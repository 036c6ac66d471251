"""weighted_hierarchical_loss: the training-loss entry point.

Port of linnaeus_tpu/loss/hierarchical.py. Pipeline:

    1. per-task per-sample raw losses (criteria)
    2. null masking (scheduled probability) + class weighting
    3. task weighting: weighted[t] = (sum(masked[t]) / num_valid[t]) * w[t]
    4. total = sum over tasks

Per-task scalars come back in a components dict for the metrics.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from .masking import apply_loss_masking

Criterion = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def compute_core_loss(
    outputs: dict[str, torch.Tensor],
    targets: dict[str, torch.Tensor],
    criteria: dict[str, Criterion],
) -> dict[str, torch.Tensor]:
    """Raw per-sample loss vector [B] per task."""
    return {task: criteria[task](outputs[task], targets[task]) for task in outputs}


def weighted_hierarchical_loss(
    outputs: dict[str, torch.Tensor],
    targets: dict[str, torch.Tensor],
    criteria: dict[str, Criterion],
    task_weights: torch.Tensor,
    null_mask_prob: float | torch.Tensor,
    generator: torch.Generator | None = None,
    coins: Mapping[str, torch.Tensor] | None = None,
    class_weights: Mapping[str, torch.Tensor] | None = None,
    is_validation: bool = False,
    phase1_mask_null: bool = False,
    apply_class_weights: bool = True,
    task_keys: tuple[str, ...] | None = None,
) -> tuple[torch.Tensor, dict]:
    """Returns (total_loss, components). ``task_weights`` is a [num_tasks]
    tensor ordered by ``task_keys`` (defaults to the order of ``outputs``).
    The null-masking coins come from ``generator`` or ``coins``."""
    keys = tuple(task_keys) if task_keys else tuple(outputs.keys())
    per_task = compute_core_loss(outputs, targets, criteria)
    raw_per_sample = dict(per_task)

    masked, null_stats = apply_loss_masking(
        per_task, targets, null_mask_prob, generator, coins,
        class_weights=class_weights,
        is_validation=is_validation,
        phase1_mask_null=phase1_mask_null,
        apply_class_weights=apply_class_weights,
    )

    weighted = {}
    for i, task in enumerate(keys):
        num_valid = null_stats[task]["valid_count"].float().clamp_min(1e-6)
        weighted[task] = masked[task].sum() / num_valid * task_weights[i]

    total = torch.stack([weighted[t] for t in keys]).sum()
    components = {
        "total": total,
        "tasks": {t: raw_per_sample[t].mean() for t in keys},
        "weighted_tasks": weighted,
        "null_masking": null_stats,
        "raw_per_sample_losses": raw_per_sample,
    }
    return total, components
