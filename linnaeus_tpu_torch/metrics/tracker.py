"""MetricsTracker — phase-keyed metric store.

Copy of linnaeus_tpu/metrics/tracker.py (held against the original by
tests/test_torch_metrics.py).

Reference parity: utils/metrics/tracker.py:36-3048, reduced to its load-
bearing behaviors: phase-keyed metrics (train / val / val_mask_meta /
val_mask_<combo>), per-task acc1/acc3/loss, chain accuracy, best-epoch
tracking, LR/schedule-value history, and full state_dict round-tripping into
checkpoints. Device scalars are accumulated host-side at log cadence (the
jitted step returns them as a metrics dict), so nothing here touches jax.
"""

from __future__ import annotations

from typing import Any


class AverageMeter:
    """Running average (utils/metrics/__init__ AverageMeter:15)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0.0
        self.avg = 0.0

    def update(self, val: float, n: float = 1.0):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1e-12)


class MetricsTracker:
    TRAIN = "train"
    VAL = "val"
    VAL_MASK_META = "val_mask_meta"

    def __init__(self, task_keys: list[str], primary_metric: str = "loss",
                 higher_is_better: bool = False):
        self.task_keys = list(task_keys)
        self.primary_metric = primary_metric
        self.higher_is_better = higher_is_better
        self._phases: dict[str, dict[str, AverageMeter]] = {}
        self.lr_history: list[tuple[int, float]] = []
        self.schedule_values: dict[str, list[tuple[int, float]]] = {}
        self.gradnorm_history: list[dict[str, Any]] = []
        self.best: dict[str, dict[str, Any]] = {}

    # ------------------------------------------------------------- phases
    @staticmethod
    def partial_mask_phase(combo: list[str]) -> str:
        return "val_mask_" + "_".join(c.upper() for c in combo)

    def _phase(self, phase: str) -> dict[str, AverageMeter]:
        return self._phases.setdefault(phase, {})

    def reset_phase(self, phase: str) -> None:
        self._phases[phase] = {}

    def update(self, phase: str, metrics: dict[str, float], n: float = 1.0) -> None:
        meters = self._phase(phase)
        for k, v in metrics.items():
            try:
                v = float(v)
            except (TypeError, ValueError):
                continue
            meters.setdefault(k, AverageMeter()).update(v, n)

    def update_counts(self, phase: str, correct: float, total: float, key: str) -> None:
        """Accumulate a ratio metric from (correct, total) counts."""
        meters = self._phase(phase)
        if total > 0:
            meters.setdefault(key, AverageMeter()).update(correct / total, total)

    def get(self, phase: str, key: str) -> float | None:
        meter = self._phase(phase).get(key)
        return meter.avg if meter else None

    def phase_summary(self, phase: str) -> dict[str, float]:
        return {k: m.avg for k, m in self._phase(phase).items()}

    # --------------------------------------------------------- histories
    def log_lr(self, step: int, lr: float) -> None:
        self.lr_history.append((int(step), float(lr)))

    def log_schedule_value(self, name: str, step: int, value: float) -> None:
        self.schedule_values.setdefault(name, []).append((int(step), float(value)))

    def log_gradnorm(self, step: int, metrics: dict[str, Any]) -> None:
        entry = {"step": int(step)}
        entry.update({k: _to_py(v) for k, v in metrics.items()})
        self.gradnorm_history.append(entry)

    # -------------------------------------------------------------- best
    def check_best(self, phase: str, epoch: int) -> bool:
        """Track best epoch by the primary metric of a phase."""
        value = self.get(phase, self.primary_metric)
        if value is None:
            return False
        rec = self.best.get(phase)
        improved = rec is None or (
            value > rec["value"] if self.higher_is_better else value < rec["value"]
        )
        if improved:
            self.best[phase] = {"value": value, "epoch": int(epoch)}
        return improved

    # ------------------------------------------------------ serialization
    def state_dict(self) -> dict[str, Any]:
        return {
            "task_keys": self.task_keys,
            "phases": {
                phase: {k: [m.sum, m.count] for k, m in meters.items()}
                for phase, meters in self._phases.items()
            },
            "lr_history": self.lr_history,
            "schedule_values": self.schedule_values,
            "gradnorm_history": self.gradnorm_history,
            "best": self.best,
        }

    def load_state_dict(self, state: dict[str, Any]) -> None:
        self.task_keys = list(state.get("task_keys", self.task_keys))
        self._phases = {}
        for phase, meters in state.get("phases", {}).items():
            for k, (s, c) in meters.items():
                meter = AverageMeter()
                meter.sum, meter.count = float(s), float(c)
                meter.avg = meter.sum / max(meter.count, 1e-12)
                self._phase(phase)[k] = meter
        self.lr_history = [tuple(x) for x in state.get("lr_history", [])]
        self.schedule_values = {
            k: [tuple(x) for x in v]
            for k, v in state.get("schedule_values", {}).items()
        }
        self.gradnorm_history = list(state.get("gradnorm_history", []))
        self.best = dict(state.get("best", {}))


def _to_py(v):
    try:
        import numpy as np

        if isinstance(v, np.ndarray):
            return v.tolist()
        if hasattr(v, "item") and getattr(v, "size", 2) == 1:
            return v.item()
        if hasattr(v, "tolist"):
            return v.tolist()
    except Exception:
        pass
    return v
