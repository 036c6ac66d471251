"""LR schedules: cosine with a linear warm-up, step-indexed.

Port of linnaeus_tpu/optim/schedules.py for the cosine schedule: plain
``step -> lr`` callables on Python numbers, built after the total number of
steps is known. The linear, step and warmup-stable-decay schedules and the
per-group schedules are not ported yet and raise.
"""

from __future__ import annotations

import math
from typing import Callable

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
    warmup_steps = resolve_warmup_steps(config, total_steps, steps_per_epoch)
    if name == "cosine":
        return cosine_schedule(float(lr_cfg.BASE_LR), float(lr_cfg.MIN_LR), total_steps,
                               warmup_steps, float(lr_cfg.WARMUP_LR))
    if name in ("linear", "step", "wsd"):
        raise NotImplementedError(
            f"LR_SCHEDULER.NAME '{name}' is not ported yet: it comes with the Trainer "
            "(train/loop.py); only 'cosine' is available"
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
