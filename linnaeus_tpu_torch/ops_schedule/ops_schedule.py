"""OpsSchedule — the step-indexed "what happens when" oracle.

Copy of linnaeus_tpu/ops_schedule/ops_schedule.py (held against the original
by tests/test_torch_ops_schedule.py).

Reference parity: ops_schedule/ops_schedule.py:35-1241. All probabilities
ramp linearly from START_PROB to END_PROB over END_STEPS (or END_FRACTION of
expected_total_steps); validation/checkpoint triggers support epoch, step,
and fraction intervals; GradNorm cadence honors warmup; early-stop composes
max-steps / patience / loss / lr / grad-norm conditions.

The probabilities it emits feed the jitted train step as scalar operands —
the schedule itself stays in Python (host-side, per-step, trivially cheap)
so jit caches are never invalidated by schedule changes.
"""

from __future__ import annotations

import random
from typing import Any

from linnaeus_tpu_torch.utils.logging import get_main_logger
from .training_progress import TrainingProgress

logger = get_main_logger()


def gradnorm_due(gw, step: int) -> bool:
    """Whether GradNorm updates after optimizer step ``step`` (the count of
    steps taken) under LOSS.GRAD_WEIGHTING.TASK ``gw``: on, past its warm-up,
    every UPDATE_INTERVAL steps."""
    if str(gw.TYPE) != "gradnorm" or not gw.get("GRADNORM_ENABLED", True):
        return False
    if step < int(gw.get("GRADNORM_WARMUP_STEPS", 0) or 0):
        return False
    interval = max(int(gw.UPDATE_INTERVAL), 1)
    return step > 0 and step % interval == 0


def _linear_ramp(step: int, start: float, end: float, end_steps: int) -> float:
    if end_steps <= 0:
        return end
    if step >= end_steps:
        return end
    progress = float(step) / float(max(1, end_steps))
    return float(start + progress * (end - start))


class OpsSchedule:
    def __init__(self, config, training_progress: TrainingProgress, metrics=None):
        self.config = config
        self.training_progress = training_progress
        self.metrics = metrics
        self.meta_cfg = config.SCHEDULE.META_MASKING
        self.null_cfg = config.SCHEDULE.NULL_MASKING
        self.mix_cfg = config.SCHEDULE.MIX
        self.val_cfg = config.SCHEDULE.VALIDATION
        self.ckpt_cfg = config.SCHEDULE.CHECKPOINT
        self.metrics_cfg = config.SCHEDULE.METRICS
        self._rng = random.Random(int(config.MISC.SEED))

    # ------------------------------------------------------------- helpers
    def _total_steps(self) -> int:
        ts = self.training_progress.expected_total_steps
        return int(ts) if ts else 0

    def _resolve_end_steps(self, cfg, steps_key="END_STEPS", frac_key="END_FRACTION",
                           default: int = 5000) -> int:
        end_steps = int(cfg.get(steps_key, 0) or 0)
        if end_steps > 0:
            return end_steps
        frac = cfg.get(frac_key)
        if frac is not None and self._total_steps():
            return int(self._total_steps() * float(frac))
        return default

    def _interval_steps(self, cfg, prefix="") -> int:
        """Resolve INTERVAL_{EPOCHS,STEPS,FRACTION} into a step interval (0 =
        epoch-based)."""
        steps = int(cfg.get(f"{prefix}INTERVAL_STEPS", 0) or 0)
        if steps > 0:
            return steps
        frac = cfg.get(f"{prefix}INTERVAL_FRACTION")
        if frac is not None and self._total_steps():
            return max(int(self._total_steps() * float(frac)), 1)
        return 0

    # ------------------------------------------------------- masking ramps
    def get_meta_mask_prob(self, current_step: int | None = None) -> float:
        step = self.training_progress.global_step if current_step is None else current_step
        if not self.meta_cfg.ENABLED:
            return 0.0
        end_steps = self._resolve_end_steps(self.meta_cfg)
        return _linear_ramp(
            step, float(self.meta_cfg.START_PROB), float(self.meta_cfg.END_PROB), end_steps
        )

    def get_null_mask_prob(self, current_step: int | None = None) -> float:
        step = self.training_progress.global_step if current_step is None else current_step
        if not self.null_cfg.ENABLED:
            return 1.0  # disabled => all null samples included
        end_steps = self._resolve_end_steps(self.null_cfg)
        return _linear_ramp(
            step, float(self.null_cfg.START_PROB), float(self.null_cfg.END_PROB), end_steps
        )

    # ---------------------------------------------------- partial meta mask
    def get_partial_mask_enabled(self, current_step: int | None = None) -> bool:
        p = self.meta_cfg.PARTIAL
        if not p.ENABLED or not p.get("WHITELIST"):
            return False
        step = self.training_progress.global_step if current_step is None else current_step
        start = int(p.get("START_STEPS", 0) or 0)
        if start <= 0 and p.get("START_FRACTION") is not None and self._total_steps():
            start = int(self._total_steps() * float(p.START_FRACTION))
        end = int(p.get("END_STEPS", 0) or 0)
        if end <= 0 and p.get("END_FRACTION") is not None and self._total_steps():
            end = int(self._total_steps() * float(p.END_FRACTION))
        if end <= 0:
            end = self._total_steps() or 10**12
        return start <= step < end

    def get_partial_meta_mask_prob(self, current_step: int | None = None) -> float:
        p = self.meta_cfg.PARTIAL
        if not self.get_partial_mask_enabled(current_step):
            return 0.0
        step = self.training_progress.global_step if current_step is None else current_step
        end_steps = self._resolve_end_steps(
            p, steps_key="PROB_END_STEPS", frac_key="PROB_END_FRACTION"
        )
        return _linear_ramp(step, float(p.START_PROB), float(p.END_PROB), end_steps)

    def pick_partial_mask_combo(self) -> list[str] | None:
        """Random whitelist combination, honoring optional WEIGHTS."""
        p = self.meta_cfg.PARTIAL
        whitelist = [list(c) for c in p.get("WHITELIST", [])]
        if not whitelist:
            return None
        weights = list(p.get("WEIGHTS", []) or [])
        if len(weights) == len(whitelist) and sum(weights) > 0:
            return self._rng.choices(whitelist, weights=weights, k=1)[0]
        return self._rng.choice(whitelist)

    # ----------------------------------------------------------------- mix
    def get_mixup_prob(self, current_step: int | None = None) -> float:
        step = self.training_progress.global_step if current_step is None else current_step
        prob_cfg = self.mix_cfg.PROB
        if not prob_cfg.ENABLED:
            return 0.0
        end_steps = self._resolve_end_steps(prob_cfg)
        return _linear_ramp(
            step, float(prob_cfg.START_PROB), float(prob_cfg.END_PROB), end_steps
        )

    def get_mixup_group_level(self, current_step: int | None = None) -> str:
        step = self.training_progress.global_step if current_step is None else current_step
        levels = list(self.mix_cfg.GROUP_LEVELS)
        switch_steps = list(self.mix_cfg.LEVEL_SWITCH_STEPS or [])
        if not levels:
            return "taxa_L10"
        if not switch_steps:
            return levels[0]
        group_idx = 0
        for i, threshold in enumerate(switch_steps):
            if step < threshold:
                group_idx = i
                break
            group_idx = i + 1
        return levels[min(group_idx, len(levels) - 1)]

    def should_use_cutmix(self) -> bool:
        mixup_on = bool(self.mix_cfg.MIXUP.ENABLED)
        cutmix_on = bool(self.mix_cfg.CUTMIX.ENABLED)
        if not cutmix_on:
            return False
        if not mixup_on:
            return True
        return self._rng.random() < float(self.mix_cfg.SWITCH_PROB)

    # ------------------------------------------------------------ gradnorm
    def should_update_gradnorm(self, current_step: int | None = None) -> bool:
        step = self.training_progress.global_step if current_step is None else current_step
        return gradnorm_due(self.config.LOSS.GRAD_WEIGHTING.TASK, step)

    # --------------------------------------------------- validation / ckpt
    def _interval_trigger(self, interval_epochs, interval_steps, at_epoch_boundary):
        step = self.training_progress.global_step
        epoch = self.training_progress.current_epoch
        if interval_steps > 0:
            return step > 0 and step % interval_steps == 0
        if not at_epoch_boundary:
            return False
        ie = int(interval_epochs or 0)
        return ie > 0 and (epoch + 1) % ie == 0

    def should_validate(self, at_epoch_boundary: bool = True) -> bool:
        return self._interval_trigger(
            self.val_cfg.get("INTERVAL_EPOCHS", 1),
            self._interval_steps(self.val_cfg),
            at_epoch_boundary,
        )

    def should_validate_mask_meta(self, at_epoch_boundary: bool = True) -> bool:
        return self._interval_trigger(
            self.val_cfg.get("MASK_META_INTERVAL_EPOCHS", 0),
            self._interval_steps(self.val_cfg, prefix="MASK_META_"),
            at_epoch_boundary,
        )

    def should_validate_partial_mask_meta(self, at_epoch_boundary: bool = True) -> bool:
        p = self.val_cfg.PARTIAL_MASK_META
        if not p.ENABLED or not p.get("WHITELIST"):
            return False
        return self._interval_trigger(
            p.get("INTERVAL_EPOCHS", 0), self._interval_steps(p), at_epoch_boundary
        )

    def get_partial_mask_meta_whitelist(self) -> list[list[str]]:
        return [list(c) for c in self.val_cfg.PARTIAL_MASK_META.get("WHITELIST", [])]

    def is_final_epoch(self) -> bool:
        return (
            self.training_progress.current_epoch + 1
            >= int(self.config.TRAIN.EPOCHS)
        )

    def should_run_exhaustive_final_validation(self) -> bool:
        fe = self.val_cfg.FINAL_EPOCH
        return bool(fe.EXHAUSTIVE_PARTIAL_META_VALIDATION) and self.is_final_epoch()

    def get_exhaustive_meta_components(self) -> list[str]:
        return list(self.val_cfg.FINAL_EPOCH.get("EXHAUSTIVE_META_COMPONENTS", []))

    def should_save_checkpoint(self, at_epoch_boundary: bool = True) -> bool:
        return self._interval_trigger(
            self.ckpt_cfg.get("INTERVAL_EPOCHS", 1),
            self._interval_steps(self.ckpt_cfg),
            at_epoch_boundary,
        )

    # ------------------------------------------------------------ logging cadence
    def _cadence(self, interval_key, fraction_key, default) -> int:
        steps = int(self.metrics_cfg.get(interval_key, default) or 0)
        if steps > 0:
            return steps
        frac = self.metrics_cfg.get(fraction_key)
        if frac is not None and self._total_steps():
            return max(int(self._total_steps() * float(frac)), 1)
        return default

    def should_log_to_console(self, current_step: int) -> bool:
        cadence = self._cadence("CONSOLE_INTERVAL", "CONSOLE_FRACTION", 100)
        return current_step % max(cadence, 1) == 0

    def should_log_to_wandb(self, current_step: int) -> bool:
        cadence = self._cadence("WANDB_INTERVAL", "WANDB_FRACTION", 50)
        return current_step % max(cadence, 1) == 0

    def should_log_lr(self, current_step: int) -> bool:
        cadence = self._cadence("LR_INTERVAL", "LR_FRACTION", 100)
        return current_step % max(cadence, 1) == 0

    def should_log_pipeline_metrics(self, current_step: int) -> bool:
        cadence = self._cadence("PIPELINE_INTERVAL", "PIPELINE_FRACTION", 250)
        return current_step % max(cadence, 1) == 0

    # ----------------------------------------------------------- early stop
    def should_stop_early(
        self,
        current_lr: float | None = None,
        grad_norm: float | None = None,
        early_stop_state=None,
    ) -> bool:
        es = self.config.TRAIN.EARLY_STOP
        if not es.ACTIVE:
            return False
        step = self.training_progress.global_step
        max_steps = es.get("MAX_STEPS")
        if max_steps and step >= int(max_steps):
            logger.info(f"Early stop: reached MAX_STEPS={max_steps}")
            return True
        patience = es.get("PATIENCE_STEPS")
        if (
            patience
            and early_stop_state is not None
            and early_stop_state.steps_since_improvement >= int(patience)
        ):
            logger.info(f"Early stop: no improvement for {patience} steps")
            return True
        max_loss = es.get("MAX_LOSS")
        if (
            max_loss is not None
            and early_stop_state is not None
            and early_stop_state.best_value is not None
            # MAX_LOSS only applies when the tracked metric IS a loss
            # (reference: ops_schedule.py:242-249 gates on 'loss' in name)
            and not early_stop_state.higher_is_better
            and early_stop_state.best_value > float(max_loss)
        ):
            logger.info("Early stop: loss exceeded MAX_LOSS")
            return True
        min_lr = es.get("MIN_LR")
        if min_lr is not None and current_lr is not None and current_lr < float(min_lr):
            logger.info("Early stop: lr fell below MIN_LR")
            return True
        max_gn = es.get("MAX_GRAD_NORM")
        if max_gn is not None and grad_norm is not None and grad_norm > float(max_gn):
            logger.info("Early stop: grad norm exceeded MAX_GRAD_NORM")
            return True
        return False

    # -------------------------------------------------------- serialization
    def state_dict(self) -> dict[str, Any]:
        return {"rng_state": self._rng.getstate()}

    def load_state_dict(self, state: dict[str, Any]) -> None:
        rng_state = state.get("rng_state")
        if rng_state is not None:
            # JSON round-trips tuples as lists; random.setstate needs tuples
            def detuple(x):
                return tuple(detuple(i) for i in x) if isinstance(x, (list, tuple)) else x

            self._rng.setstate(detuple(rng_state))
