"""LR schedules: cosine / linear / step / wsd, each behind a linear warm-up,
step-indexed, and the per-group schedules.

Port of linnaeus_tpu/optim/schedules.py: plain ``step -> lr`` callables on
Python numbers, built after the total number of steps is known, each the
optax schedule the TPU package builds (cosine_decay_schedule,
linear_schedule, exponential_decay with staircase, and its own
warmup-stable-decay).
"""

from __future__ import annotations

import logging
import math
from typing import Callable

from linnaeus_tpu_torch.configuration.train_presets import ConfigNode

logger = logging.getLogger(__name__)

Schedule = Callable[[int], float]


def _linear(init: float, end: float, transition_steps: int) -> Schedule:
    """Linear ramp from ``init`` to ``end`` over ``transition_steps``, then flat."""

    def sched(step: int) -> float:
        if transition_steps <= 0:
            return end
        count = min(max(step, 0), transition_steps)
        return (init - end) * (1.0 - count / transition_steps) + end

    return sched


def _warmup(base_schedule: Schedule, warmup_steps: int, warmup_lr: float,
            base_lr: float) -> Schedule:
    if warmup_steps <= 0:
        return base_schedule
    warm = _linear(warmup_lr, base_lr, warmup_steps)

    def sched(step: int) -> float:
        return warm(step) if step < warmup_steps else base_schedule(step - warmup_steps)

    return sched


def cosine_schedule(base_lr: float, min_lr: float, total_steps: int,
                    warmup_steps: int = 0, warmup_lr: float = 0.0) -> Schedule:
    decay_steps = max(total_steps - warmup_steps, 1)
    alpha = min_lr / max(base_lr, 1e-12)

    def base(step: int) -> float:
        count = min(max(step, 0), decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return base_lr * ((1.0 - alpha) * cosine + alpha)

    return _warmup(base, warmup_steps, warmup_lr, base_lr)


def linear_schedule(base_lr: float, min_lr: float, total_steps: int,
                    warmup_steps: int = 0, warmup_lr: float = 0.0) -> Schedule:
    decay_steps = max(total_steps - warmup_steps, 1)
    return _warmup(_linear(base_lr, min_lr, decay_steps), warmup_steps, warmup_lr, base_lr)


def step_schedule(base_lr: float, decay_steps: int, decay_rate: float, total_steps: int,
                  warmup_steps: int = 0, warmup_lr: float = 0.0) -> Schedule:
    """``base_lr * decay_rate ** floor(step / decay_steps)`` (optax's
    staircase exponential decay)."""
    decay_steps = max(int(decay_steps), 1)

    def base(step: int) -> float:
        return base_lr * decay_rate ** math.floor(max(step, 0) / decay_steps)

    return _warmup(base, warmup_steps, warmup_lr, base_lr)


def wsd_schedule(base_lr: float, min_lr: float, total_steps: int, warmup_steps: int = 0,
                 warmup_lr: float = 0.0, stable_fraction: float = 0.8,
                 decay_fraction: float = 0.1, decay_type: str = "cosine") -> Schedule:
    """Warmup-Stable-Decay: after the warm-up, a plateau at ``base_lr`` over
    ``stable_fraction`` of the remaining steps, then a cosine (or linear)
    decay to ``min_lr`` over ``decay_fraction`` of them; the rest stays at
    ``min_lr``."""
    post = max(total_steps - warmup_steps, 1)
    stable_steps = int(post * stable_fraction)
    decay_steps = max(int(post * decay_fraction), 1)

    def base(step: int) -> float:
        in_decay = min(max((step - stable_steps) / decay_steps, 0.0), 1.0)
        if decay_type == "linear":
            factor = 1.0 - in_decay
        else:
            factor = 0.5 * (1.0 + math.cos(math.pi * in_decay))
        return min_lr + (base_lr - min_lr) * factor

    return _warmup(base, warmup_steps, warmup_lr, base_lr)


def resolve_warmup_steps(config, total_steps: int, steps_per_epoch: int) -> int:
    """Warm-up precedence: FRACTION > EPOCHS > STEPS."""
    lr_cfg = config.LR_SCHEDULER
    frac = lr_cfg.get("WARMUP_FRACTION")
    if frac is not None and frac > 0:
        return int(total_steps * float(frac))
    epochs = lr_cfg.get("WARMUP_EPOCHS")
    if epochs and steps_per_epoch > 0:
        return int(float(epochs) * steps_per_epoch)
    return int(lr_cfg.get("WARMUP_STEPS", 0) or 0)


def build_schedule(config, total_steps: int, steps_per_epoch: int = 0) -> Schedule:
    """Main entry: the schedule named by ``config.LR_SCHEDULER``."""
    lr_cfg = config.LR_SCHEDULER
    name = str(lr_cfg.NAME).lower()
    base_lr, min_lr = float(lr_cfg.BASE_LR), float(lr_cfg.MIN_LR)
    warmup_lr = float(lr_cfg.WARMUP_LR)
    warmup_steps = resolve_warmup_steps(config, total_steps, steps_per_epoch)
    if name == "cosine":
        return cosine_schedule(base_lr, min_lr, total_steps, warmup_steps, warmup_lr)
    if name == "linear":
        return linear_schedule(base_lr, min_lr, total_steps, warmup_steps, warmup_lr)
    if name == "step":
        decay_steps = lr_cfg.get("DECAY_STEPS", 5000)
        frac = lr_cfg.get("DECAY_FRACTION")
        if frac is not None and frac > 0:
            decay_steps = int(total_steps * float(frac))
        return step_schedule(base_lr, decay_steps, float(lr_cfg.get("DECAY_RATE", 0.1)),
                             total_steps, warmup_steps, warmup_lr)
    if name == "wsd":
        return wsd_schedule(
            base_lr, min_lr, total_steps, warmup_steps, warmup_lr,
            stable_fraction=float(lr_cfg.get("STABLE_DURATION_FRACTION", 0.8)),
            decay_fraction=float(lr_cfg.get("DECAY_DURATION_FRACTION", 0.1)),
            decay_type=str(lr_cfg.get("DECAY_TYPE", "cosine")),
        )
    raise ValueError(f"Unknown LR_SCHEDULER.NAME '{name}'")


def apply_lr_scaling(config, effective_batch_size: int) -> float:
    """Linear LR scaling by the effective global batch: BASE_LR in a config
    means "LR at REFERENCE_BS". Writes the scaled LR and the factor back
    into ``config.LR_SCHEDULER`` and returns the scaled LR."""
    lr_cfg = config.LR_SCHEDULER
    factor = effective_batch_size / float(lr_cfg.REFERENCE_BS)
    scaled = float(lr_cfg.BASE_LR) * factor
    lr_cfg["BASE_LR"] = scaled
    lr_cfg["LR_SCALING_FACTOR"] = factor
    return scaled


def build_group_schedules(config, total_steps: int,
                          steps_per_epoch: int = 0) -> dict[str, Schedule]:
    """Group name -> its own schedule; 'default' is always present.

    Each ``LR_SCHEDULER.PARAMETER_GROUPS.<GROUP>`` entry is a partial
    LR_SCHEDULER override (NAME, BASE_LR, MIN_LR, WARMUP_*, the WSD knobs)
    keyed by the group names of OPTIMIZER.PARAMETER_GROUPS; a group without
    an entry follows the base schedule times its LR_MULTIPLIER
    (optim/build.py). A group BASE_LR means "LR at REFERENCE_BS", so it is
    scaled by the same LR_SCALING_FACTOR as the base rate.
    """
    out = {"default": build_schedule(config, total_steps, steps_per_epoch)}
    pg = config.LR_SCHEDULER.get("PARAMETER_GROUPS", {})
    if not pg or not pg.get("ENABLED", False):
        return out
    opt_groups = {k for k in config.OPTIMIZER.get("PARAMETER_GROUPS", {}) if k != "ENABLED"}
    scaling = float(config.LR_SCHEDULER.get("LR_SCALING_FACTOR", 1.0) or 1.0)
    for gname, gcfg in pg.items():
        if gname == "ENABLED" or not isinstance(gcfg, dict):
            continue
        if gname not in opt_groups:
            logger.warning(
                f"LR_SCHEDULER.PARAMETER_GROUPS.{gname} matches no OPTIMIZER.PARAMETER_GROUPS "
                "entry: its schedule will never be attached to any params")
        lr_cfg = dict(config.LR_SCHEDULER)
        for k, v in gcfg.items():
            lr_cfg[k] = float(v) * scaling if k == "BASE_LR" and scaling != 1.0 else v
        out[gname] = build_schedule(ConfigNode({"LR_SCHEDULER": lr_cfg}), total_steps,
                                    steps_per_epoch)
    return out
