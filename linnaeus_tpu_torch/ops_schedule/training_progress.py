"""TrainingProgress — single source of truth for step/epoch/stage state.

Copy of linnaeus_tpu/ops_schedule/training_progress.py (held against the
original by tests/test_torch_ops_schedule.py).

Reference parity: ops_schedule/training_progress.py:12-170. Tracks
``global_step`` (optimizer steps), ``current_epoch``, the active
``TrainingStage``, and a pending-validation queue with partial indices so a
run interrupted mid-validation replays the remaining validations on resume.
Fully serializable into checkpoints.
"""

from __future__ import annotations

from enum import Enum
from typing import Any


class TrainingStage(str, Enum):
    TRAINING = "TRAINING"
    VALIDATION_NORMAL = "VALIDATION_NORMAL"
    VALIDATION_MASK_META = "VALIDATION_MASK_META"
    VALIDATION_PARTIAL_MASK_META = "VALIDATION_PARTIAL_MASK_META"


class TrainingProgress:
    def __init__(
        self,
        global_step: int = 0,
        current_epoch: int = 0,
        expected_total_steps: int | None = None,
    ):
        self.global_step = int(global_step)
        self.current_epoch = int(current_epoch)
        self.expected_total_steps = expected_total_steps
        self.current_stage = TrainingStage.TRAINING
        # pending validations: list of dicts {stage, partial_combo (opt)}
        self.pending_validations: list[dict[str, Any]] = []
        self.partial_validation_indices: dict[str, int] = {}

    # ------------------------------------------------------------- mutation
    def increment_step(self) -> None:
        self.global_step += 1

    def start_epoch(self, epoch: int | None = None) -> None:
        if epoch is not None:
            self.current_epoch = int(epoch)
        self.current_stage = TrainingStage.TRAINING

    def end_epoch(self) -> None:
        self.current_epoch += 1

    def enter_stage(self, stage: TrainingStage) -> None:
        self.current_stage = TrainingStage(stage)

    def queue_validation(
        self, stage: TrainingStage, partial_combo: list[str] | None = None
    ) -> None:
        entry: dict[str, Any] = {"stage": TrainingStage(stage).value}
        if partial_combo is not None:
            entry["partial_combo"] = list(partial_combo)
        self.pending_validations.append(entry)

    def pop_validation(self) -> dict[str, Any] | None:
        if not self.pending_validations:
            return None
        return self.pending_validations.pop(0)

    def has_pending_validations(self) -> bool:
        return bool(self.pending_validations)

    @property
    def fraction_complete(self) -> float:
        if not self.expected_total_steps:
            return 0.0
        return min(self.global_step / self.expected_total_steps, 1.0)

    # -------------------------------------------------------- serialization
    def state_dict(self) -> dict[str, Any]:
        return {
            "global_step": self.global_step,
            "current_epoch": self.current_epoch,
            "expected_total_steps": self.expected_total_steps,
            "current_stage": self.current_stage.value,
            "pending_validations": list(self.pending_validations),
            "partial_validation_indices": dict(self.partial_validation_indices),
        }

    def load_state_dict(self, state: dict[str, Any]) -> None:
        self.global_step = int(state.get("global_step", 0))
        self.current_epoch = int(state.get("current_epoch", 0))
        self.expected_total_steps = state.get("expected_total_steps")
        self.current_stage = TrainingStage(state.get("current_stage", "TRAINING"))
        self.pending_validations = list(state.get("pending_validations", []))
        self.partial_validation_indices = dict(
            state.get("partial_validation_indices", {})
        )

    def __repr__(self) -> str:
        return (
            f"TrainingProgress(step={self.global_step}, epoch={self.current_epoch}, "
            f"stage={self.current_stage.value}, pending={len(self.pending_validations)})"
        )
