"""StepMetricsLogger — per-optimizer-step console/wandb emission.

Copy of linnaeus_tpu/metrics/step_logger.py (held against the original by
tests/test_torch_metrics.py).

Reference parity: utils/metrics/step_metrics_logger.py:23-1102. Handles
console/wandb cadences from OpsSchedule, epoch ETA, schedule-value logging,
and pipeline-metrics forwarding. Wandb is optional; every wandb payload also
lands in an offline JSONL mirror (reference: utils/logging/wandb.py:233).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

from linnaeus_tpu_torch.utils.logging import get_main_logger

logger = get_main_logger()


class StepMetricsLogger:
    def __init__(
        self,
        config,
        ops_schedule,
        metrics_tracker,
        wandb_run=None,
        jsonl_path: str | None = None,
    ):
        self.config = config
        self.ops_schedule = ops_schedule
        self.tracker = metrics_tracker
        self.wandb_run = wandb_run
        self.jsonl_path = jsonl_path
        self._epoch_start: float | None = None
        self._epoch_steps = 0
        self._steps_done = 0

    # ------------------------------------------------------------ epoch ETA
    def start_epoch(self, steps_in_epoch: int) -> None:
        self._epoch_start = time.perf_counter()
        self._epoch_steps = steps_in_epoch
        self._steps_done = 0

    def _eta_seconds(self) -> float | None:
        if not self._epoch_start or not self._steps_done:
            return None
        elapsed = time.perf_counter() - self._epoch_start
        rate = elapsed / self._steps_done
        return rate * (self._epoch_steps - self._steps_done)

    # ------------------------------------------------------------- emission
    def log_step_metrics(
        self,
        step: int,
        epoch: int,
        metrics: dict[str, Any],
        lr: float | None = None,
    ) -> None:
        from linnaeus_tpu_torch.utils.debug import check_debug_flag

        if check_debug_flag(self.config, "DEBUG.TRAIN_METRICS"):
            logger.debug(f"[TRAIN_METRICS] step={step} metrics={metrics}")
        self._steps_done += 1
        scalars = {
            k: float(v)
            for k, v in metrics.items()
            if _is_scalar(v)
        }
        if lr is not None:
            scalars["lr"] = float(lr)
        if self.ops_schedule.should_log_to_console(step):
            eta = self._eta_seconds()
            eta_str = f" eta {eta:.0f}s" if eta else ""
            logger.info(
                f"epoch {epoch} step {step} "
                + " ".join(
                    f"{k}={v:.4g}"
                    for k, v in sorted(scalars.items())
                    if "/" not in k
                )
                + eta_str
            )
            self.tracker.update(self.tracker.TRAIN, scalars)
        if self.ops_schedule.should_log_to_wandb(step):
            self._emit_wandb({"train/" + k: v for k, v in scalars.items()}, step)

    def log_schedule_values(self, step: int, values: dict[str, float]) -> None:
        for name, v in values.items():
            self.tracker.log_schedule_value(name, step, float(v))
        if self.ops_schedule.should_log_to_wandb(step):
            self._emit_wandb({f"schedule/{k}": v for k, v in values.items()}, step)

    def log_pipeline_metrics(self, step: int, pipeline_stats: dict) -> None:
        if not self.ops_schedule.should_log_pipeline_metrics(step):
            return
        flat = _flatten(pipeline_stats, prefix="pipeline/")
        logger.info(
            "pipeline: "
            + " ".join(f"{k.split('/')[-1]}={v:.4g}" for k, v in flat.items())
        )
        self._emit_wandb(flat, step)

    def log_validation(self, step: int, phase: str, summary: dict) -> None:
        self._emit_wandb({f"{phase}/{k}": v for k, v in summary.items()}, step)

    def _emit_wandb(self, payload: dict, step: int) -> None:
        from linnaeus_tpu_torch.utils.debug import check_debug_flag

        if check_debug_flag(self.config, "DEBUG.WANDB_METRICS"):
            logger.debug(f"[WANDB_METRICS] step={step} payload={payload}")
        if self.wandb_run is not None:
            try:
                self.wandb_run.log(payload, step=step)
            except Exception as e:  # never let logging kill training
                logger.warning(f"wandb log failed: {e}")
        if self.jsonl_path:
            try:
                os.makedirs(os.path.dirname(self.jsonl_path), exist_ok=True)
                with open(self.jsonl_path, "a") as f:
                    f.write(json.dumps({"step": step, **payload}) + "\n")
            except OSError as e:
                logger.warning(f"jsonl mirror failed: {e}")


def _is_scalar(v) -> bool:
    try:
        import numpy as np

        return np.ndim(v) == 0
    except Exception:
        return isinstance(v, (int, float))


def _flatten(d: dict, prefix: str = "") -> dict[str, float]:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        elif _is_scalar(v):
            out[key] = float(v)
    return out


def initialize_wandb(config, resume_run_id: str | None = None):
    """Gated wandb init with resumable run id (utils/logging/wandb.py:62)."""
    if not config.EXPERIMENT.WANDB.ENABLED:
        return None
    try:
        import wandb
    except ImportError:
        logger.warning("EXPERIMENT.WANDB.ENABLED but wandb not installed; skipping")
        return None
    run_id = resume_run_id or (config.EXPERIMENT.WANDB.RUN_ID or None)
    # EXPERIMENT.WANDB.RESUME: an explicitly-configured policy (e.g. 'must')
    # always wins; 'allow' is only the fallback when a run id was
    # auto-detected (reference: utils/logging/wandb.py:132-137,680)
    explicit = config.EXPERIMENT.WANDB.RESUME or None
    resume = explicit if explicit else ("allow" if run_id else None)
    run = wandb.init(
        project=config.EXPERIMENT.PROJECT or None,
        group=config.EXPERIMENT.GROUP or None,
        name=config.EXPERIMENT.NAME or None,
        tags=list(config.EXPERIMENT.TAGS or []),
        notes=config.EXPERIMENT.NOTES or None,
        id=run_id,
        resume=resume,
        config=config.to_dict(),
        allow_val_change=bool(config.TRAIN.get("ALLOW_WANDB_VAL_CHANGE", False)),
    )
    return run
