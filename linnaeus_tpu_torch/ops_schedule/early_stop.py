"""Early-stop bookkeeping (reference parity: ops_schedule/early_stop_state.py:9).

Copy of linnaeus_tpu/ops_schedule/early_stop.py (held against the original
by tests/test_torch_ops_schedule.py).
"""

from __future__ import annotations

from typing import Any


class EarlyStopState:
    def __init__(self, metric_name: str = "val_loss", higher_is_better: bool = False):
        self.metric_name = metric_name
        self.higher_is_better = higher_is_better
        self.best_value: float | None = None
        self.best_step: int = 0
        self.steps_since_improvement: int = 0

    def update(self, value: float, step: int, min_delta: float | None = None) -> bool:
        """Record a metric observation; returns True if it improved."""
        delta = min_delta or 0.0
        improved = self.best_value is None or (
            value > self.best_value + delta
            if self.higher_is_better
            else value < self.best_value - delta
        )
        if improved:
            self.best_value = value
            self.best_step = step
            self.steps_since_improvement = 0
        else:
            self.steps_since_improvement = step - self.best_step
        return improved

    def state_dict(self) -> dict[str, Any]:
        return {
            "metric_name": self.metric_name,
            "higher_is_better": self.higher_is_better,
            "best_value": self.best_value,
            "best_step": self.best_step,
            "steps_since_improvement": self.steps_since_improvement,
        }

    def load_state_dict(self, state: dict[str, Any]) -> None:
        self.metric_name = state.get("metric_name", self.metric_name)
        self.higher_is_better = bool(state.get("higher_is_better", False))
        self.best_value = state.get("best_value")
        self.best_step = int(state.get("best_step", 0))
        self.steps_since_improvement = int(state.get("steps_since_improvement", 0))
