"""Training-schedule consistency checks.

Copy of linnaeus_tpu/utils/training_consistency.py (held against the
original by tests/test_torch_schedule_utils.py).

Reference parity: utils/training_consistency.py:23-380 —
``validate_training_schedule`` (pre-flight checks on resolved schedules) and
``TrainingConsistencyChecker`` (runtime assertions at step/epoch boundaries).
"""

from __future__ import annotations

from linnaeus_tpu_torch.utils.logging import get_main_logger

logger = get_main_logger()


def validate_training_schedule(config, total_steps: int,
                               steps_per_epoch: int) -> list[str]:
    """Pre-flight checks; returns a list of problems (empty = consistent)."""
    problems: list[str] = []
    if total_steps <= 0:
        problems.append("total_steps must be positive")
    if steps_per_epoch <= 0:
        problems.append("steps_per_epoch must be positive (empty dataloader?)")

    lr = config.LR_SCHEDULER
    warm = int(lr.get("WARMUP_STEPS", 0) or 0)
    if warm >= total_steps > 0:
        problems.append(
            f"warmup ({warm}) >= total steps ({total_steps}); LR never decays"
        )
    if float(lr.MIN_LR) > float(lr.BASE_LR):
        problems.append("LR_SCHEDULER.MIN_LR > BASE_LR")

    mm = config.SCHEDULE.META_MASKING
    if mm.ENABLED and int(mm.get("END_STEPS", 0) or 0) > total_steps:
        problems.append("META_MASKING.END_STEPS exceeds total steps")
    nm = config.SCHEDULE.NULL_MASKING
    if nm.ENABLED and int(nm.get("END_STEPS", 0) or 0) > total_steps:
        problems.append("NULL_MASKING.END_STEPS exceeds total steps")

    gw = config.LOSS.GRAD_WEIGHTING.TASK
    if str(gw.TYPE) == "gradnorm":
        if int(gw.UPDATE_INTERVAL) > total_steps:
            problems.append("GradNorm UPDATE_INTERVAL exceeds total steps")
        if int(gw.get("GRADNORM_WARMUP_STEPS", 0) or 0) >= total_steps:
            problems.append("GradNorm warmup covers entire run")

    acc = int(config.TRAIN.get("ACCUMULATION_STEPS", 0) or 0)
    if acc > 1 and config.DATA.BATCH_SIZE % acc != 0:
        problems.append(
            f"BATCH_SIZE ({config.DATA.BATCH_SIZE}) not divisible by "
            f"ACCUMULATION_STEPS ({acc})"
        )

    if config.SCHEDULE.MIX.PROB.ENABLED and str(config.DATA.SAMPLER.TYPE) != "grouped":
        problems.append(
            "mixing enabled but DATA.SAMPLER.TYPE != 'grouped' "
            "(selective mixup needs in-batch same-group pairs)"
        )
    for p in problems:
        logger.warning(f"Training consistency: {p}")
    return problems


class TrainingConsistencyChecker:
    """Runtime invariants checked during training (cheap, host-side)."""

    def __init__(self, config, total_steps: int):
        self.config = config
        self.total_steps = total_steps
        self._last_step = -1
        self.violations: list[str] = []

    def check_step(self, global_step: int, loss: float | None = None) -> None:
        if global_step <= self._last_step:
            self._record(
                f"global_step did not advance: {self._last_step} -> {global_step}"
            )
        self._last_step = global_step
        if loss is not None and not (loss == loss):  # NaN check
            self._record(f"NaN loss at step {global_step}")

    def check_epoch_boundary(self, epoch: int, steps_this_epoch: int,
                             expected_steps: int) -> None:
        if steps_this_epoch == 0:
            self._record(f"epoch {epoch} ran zero steps")
        elif abs(steps_this_epoch - expected_steps) > max(1, expected_steps // 10):
            self._record(
                f"epoch {epoch} ran {steps_this_epoch} steps, expected "
                f"~{expected_steps}"
            )

    def _record(self, msg: str) -> None:
        self.violations.append(msg)
        logger.warning(f"Consistency violation: {msg}")
