"""GradNorm state carried by the train state.

Port of ``GradNormState`` and ``init_gradnorm_state`` of
linnaeus_tpu/loss/gradnorm.py. The train step reads ``task_weights``; the
GradNorm weight update (a re-forward with per-task gradient norms) is not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class GradNormState:
    task_weights: torch.Tensor  # [T]
    initial_losses: torch.Tensor  # [T]
    has_initted: torch.Tensor  # bool scalar
    last_metrics: dict[str, torch.Tensor] | None = None


def init_gradnorm_state(num_tasks: int, init_weights=None, device=None) -> GradNormState:
    if init_weights is not None:
        w = torch.as_tensor(init_weights, dtype=torch.float32, device=device)
    else:
        w = torch.ones(num_tasks, dtype=torch.float32, device=device)
    # normalise to sum = num_tasks
    w = w * (num_tasks / w.sum().clamp_min(1e-8))
    return GradNormState(
        task_weights=w,
        initial_losses=torch.zeros(num_tasks, dtype=torch.float32, device=device),
        has_initted=torch.zeros((), dtype=torch.bool, device=device),
    )
