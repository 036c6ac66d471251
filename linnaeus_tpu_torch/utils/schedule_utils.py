"""Schedule resolution, validation, and summaries.

Copy of linnaeus_tpu/utils/schedule_utils.py (held against the original by
tests/test_torch_schedule_utils.py).

Reference parity: utils/schedule_utils.py:136-1387. Resolves every
``*_FRACTION`` alternative into absolute steps once TOTAL_STEPS is known,
validates conflicting specifications (both steps and fraction given), applies
reference-batch LR scaling, and renders a human-readable schedule summary.
"""

from __future__ import annotations

import importlib.util

from linnaeus_tpu_torch.optim.schedules import apply_lr_scaling as _apply_lr_scaling
from linnaeus_tpu_torch.utils.logging import get_main_logger

logger = get_main_logger()

# (section path, steps key, fraction key) pairs that support both specs
_FRACTION_PAIRS = [
    ("SCHEDULE.META_MASKING", "END_STEPS", "END_FRACTION"),
    ("SCHEDULE.META_MASKING.PARTIAL", "START_STEPS", "START_FRACTION"),
    ("SCHEDULE.META_MASKING.PARTIAL", "END_STEPS", "END_FRACTION"),
    ("SCHEDULE.META_MASKING.PARTIAL", "PROB_END_STEPS", "PROB_END_FRACTION"),
    ("SCHEDULE.NULL_MASKING", "END_STEPS", "END_FRACTION"),
    ("SCHEDULE.MIX.PROB", "END_STEPS", "END_FRACTION"),
    ("SCHEDULE.VALIDATION", "INTERVAL_STEPS", "INTERVAL_FRACTION"),
    ("SCHEDULE.VALIDATION", "MASK_META_INTERVAL_STEPS", "MASK_META_INTERVAL_FRACTION"),
    ("SCHEDULE.VALIDATION.PARTIAL_MASK_META", "INTERVAL_STEPS", "INTERVAL_FRACTION"),
    ("SCHEDULE.CHECKPOINT", "INTERVAL_STEPS", "INTERVAL_FRACTION"),
    ("SCHEDULE.METRICS", "WANDB_INTERVAL", "WANDB_FRACTION"),
    ("SCHEDULE.METRICS", "CONSOLE_INTERVAL", "CONSOLE_FRACTION"),
    ("SCHEDULE.METRICS", "LR_INTERVAL", "LR_FRACTION"),
    ("SCHEDULE.METRICS", "PIPELINE_INTERVAL", "PIPELINE_FRACTION"),
    ("LR_SCHEDULER", "WARMUP_STEPS", "WARMUP_FRACTION"),
    ("LR_SCHEDULER", "DECAY_STEPS", "DECAY_FRACTION"),
]


def _node_at(config, path: str):
    node = config
    for part in path.split("."):
        node = node[part]
    return node


def validate_schedule_config(config) -> list[str]:
    """Detect conflicting specs; returns list of problems (empty = valid).

    A conflict = both the explicit steps key (>0) AND the fraction key (not
    None) given for the same parameter (schedule_utils.py:136).
    """
    problems = []
    for path, steps_key, frac_key in _FRACTION_PAIRS:
        try:
            node = _node_at(config, path)
        except KeyError:
            continue
        steps = node.get(steps_key, 0)
        frac = node.get(frac_key)
        if steps and steps > 0 and frac is not None and frac > 0:
            problems.append(
                f"{path}: both {steps_key}={steps} and {frac_key}={frac} set"
            )
    # warmup triple-spec check
    lr = config.LR_SCHEDULER
    specs = sum(
        1
        for v in (
            lr.get("WARMUP_STEPS", 0) or 0,
            lr.get("WARMUP_FRACTION") or 0,
        )
        if v
    )
    if specs > 1:
        problems.append("LR_SCHEDULER: multiple warmup specifications")
    for p in problems:
        logger.warning(f"Schedule config conflict: {p}")
    return problems


def resolve_all_schedule_params(config, total_steps: int) -> None:
    """Convert every set fraction into absolute steps in place
    (schedule_utils.py:566)."""
    was_frozen = config.is_frozen()
    config.defrost()
    for path, steps_key, frac_key in _FRACTION_PAIRS:
        try:
            node = _node_at(config, path)
        except KeyError:
            continue
        frac = node.get(frac_key)
        steps = node.get(steps_key, 0) or 0
        if frac is not None and frac > 0 and not steps:
            node[steps_key] = max(int(total_steps * float(frac)), 1)
            node[frac_key] = None
    config.LR_SCHEDULER.TOTAL_STEPS = int(total_steps)
    if was_frozen:
        config.freeze()


def apply_lr_scaling(config, effective_batch_size: int) -> float:
    """Linear LR scaling by effective global batch (reference:
    schedule_utils.py:492, applied unconditionally from main.py:924):
    BASE_LR in a config means "LR at REFERENCE_BS". Writes the scaled LR
    and the factor into LR_SCHEDULER (optim/schedules.py::apply_lr_scaling,
    through a frozen config too) and logs it; returns the scaled LR."""
    base_lr = float(config.LR_SCHEDULER.BASE_LR)
    was_frozen = config.is_frozen()
    config.defrost()
    scaled = _apply_lr_scaling(config, effective_batch_size)
    if was_frozen:
        config.freeze()
    logger.info(
        f"LR scaling: base_lr={scaled:.3e} = {base_lr:.3e} x "
        f"{float(config.LR_SCHEDULER.LR_SCALING_FACTOR):.4f} (effective bs "
        f"{effective_batch_size} / reference bs "
        f"{float(config.LR_SCHEDULER.REFERENCE_BS):.0f}; reference LR at that bs: "
        f"{float(config.LR_SCHEDULER.REFERENCE_LR):.1e})"
    )
    if scaled < float(config.LR_SCHEDULER.MIN_LR):
        logger.warning(
            f"LR scaling: scaled base LR {scaled:.3e} is below MIN_LR "
            f"{float(config.LR_SCHEDULER.MIN_LR):.3e}; the schedule will be "
            "degenerate — raise BASE_LR or lower REFERENCE_BS"
        )
    return scaled


def schedule_summary(config, total_steps: int, steps_per_epoch: int) -> str:
    """Text summary of the resolved schedule (schedule_utils.py:1387)."""
    lines = [
        "=== Training schedule summary ===",
        f"total steps: {total_steps} ({config.TRAIN.EPOCHS} epochs x "
        f"{steps_per_epoch} steps)",
        f"lr: {config.LR_SCHEDULER.NAME} base={config.LR_SCHEDULER.BASE_LR:.2e} "
        f"min={config.LR_SCHEDULER.MIN_LR:.2e} "
        f"warmup_steps={config.LR_SCHEDULER.WARMUP_STEPS}",
    ]
    mm = config.SCHEDULE.META_MASKING
    lines.append(
        f"meta masking: {'on' if mm.ENABLED else 'off'} "
        f"{mm.START_PROB}->{mm.END_PROB} over {mm.END_STEPS} steps"
    )
    if mm.PARTIAL.ENABLED:
        lines.append(
            f"partial meta masking: prob {mm.PARTIAL.START_PROB}->"
            f"{mm.PARTIAL.END_PROB}, whitelist={mm.PARTIAL.WHITELIST}"
        )
    nm = config.SCHEDULE.NULL_MASKING
    if nm.ENABLED:
        lines.append(
            f"null masking: {nm.START_PROB}->{nm.END_PROB} over {nm.END_STEPS}"
        )
    mix = config.SCHEDULE.MIX
    lines.append(
        f"mix: prob {mix.PROB.START_PROB}->{mix.PROB.END_PROB} "
        f"(mixup={mix.MIXUP.ENABLED}, cutmix={mix.CUTMIX.ENABLED}, "
        f"levels={mix.GROUP_LEVELS})"
    )
    gw = config.LOSS.GRAD_WEIGHTING.TASK
    lines.append(
        f"gradnorm: {gw.TYPE} alpha={gw.ALPHA} every {gw.UPDATE_INTERVAL} steps"
        f" (warmup {gw.GRADNORM_WARMUP_STEPS})"
    )
    v = config.SCHEDULE.VALIDATION
    lines.append(
        f"validation: every {v.INTERVAL_EPOCHS} epochs / {v.INTERVAL_STEPS} steps;"
        f" mask-meta every {v.MASK_META_INTERVAL_EPOCHS} epochs"
    )
    c = config.SCHEDULE.CHECKPOINT
    lines.append(
        f"checkpoint: every {c.INTERVAL_EPOCHS} epochs / {c.INTERVAL_STEPS} steps"
        f" (top {c.KEEP_TOP_N} / last {c.KEEP_LAST_N})"
    )
    return "\n".join(lines)


def generate_schedule_plot(config, total_steps: int, output_path: str) -> str | None:
    """Render the masking/mix/LR schedules to a PNG (schedule_utils.py:1118).

    Returns the path written, or None when matplotlib is unavailable.
    """
    if importlib.util.find_spec("matplotlib") is None:
        logger.warning("matplotlib unavailable; skipping schedule plot")
        return None
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from linnaeus_tpu_torch.ops_schedule import OpsSchedule, TrainingProgress
    from linnaeus_tpu_torch.optim.schedules import build_schedule

    tp = TrainingProgress(expected_total_steps=total_steps)
    sched = OpsSchedule(config, tp)
    lr_fn = build_schedule(config, total_steps)

    steps = list(range(0, max(total_steps, 1), max(total_steps // 200, 1)))
    lr_values = [float(lr_fn(s)) for s in steps]
    fig, axes = plt.subplots(2, 1, figsize=(10, 7), sharex=True)
    axes[0].plot(steps, [sched.get_meta_mask_prob(s) for s in steps],
                 label="meta mask prob")
    axes[0].plot(steps, [sched.get_mixup_prob(s) for s in steps],
                 label="mix prob")
    axes[0].plot(steps, [sched.get_null_mask_prob(s) for s in steps],
                 label="null include prob")
    axes[0].plot(steps, [sched.get_partial_meta_mask_prob(s) for s in steps],
                 label="partial mask prob")
    axes[0].set_ylabel("probability")
    axes[0].set_ylim(-0.05, 1.05)
    axes[0].legend(loc="best")
    axes[0].set_title("schedule-driven probabilities")

    axes[1].plot(steps, lr_values, label="lr")
    axes[1].set_yscale("log")
    axes[1].set_ylabel("learning rate")
    axes[1].set_xlabel("optimizer step")
    axes[1].legend(loc="best")
    fig.tight_layout()
    import os

    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    fig.savefig(output_path, dpi=110)
    plt.close(fig)
    logger.info(f"Wrote schedule plot to {output_path}")
    return output_path
