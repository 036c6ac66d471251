"""weighted_hierarchical_loss: the training-loss entry point.

Port of linnaeus_tpu/loss/hierarchical.py. Pipeline:

    1. per-task per-sample raw losses (criteria)
    2. null masking (scheduled probability) + class weighting
    3. task weighting: weighted[t] = (sum(masked[t]) / num_valid[t]) * w[t]
    4. total = sum over tasks

Per-task scalars come back in a components dict for the metrics.

Over the data axis (``group``: parallel/) each rank holds its rows of the
global batch; the per-task sums and counts are summed over the group (one
collective, differentiable as the identity: every rank's loss is the global
one), and the null-masking coins are the global batch's, this rank keeping
its rows, so the loss is the one-process loss of the global batch.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from linnaeus_tpu_torch.parallel.ops import draw_rows, group_size, split_rows, sum_forward

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
    group=None,
) -> tuple[torch.Tensor, dict]:
    """Returns (total_loss, components). ``task_weights`` is a [num_tasks]
    tensor ordered by ``task_keys`` (defaults to the order of ``outputs``).
    The null-masking coins come from ``generator`` or ``coins`` (the global
    batch's under ``group``)."""
    keys = tuple(task_keys) if task_keys else tuple(outputs.keys())
    per_task = compute_core_loss(outputs, targets, criteria)
    raw_per_sample = dict(per_task)
    if group_size(group) == 1:
        group = None
    elif coins is not None:
        coins = {t: split_rows(torch.as_tensor(coins[t]), group) for t in per_task}
    elif generator is not None:
        coins = {t: draw_rows(torch.rand, v.shape, v.device, generator, group)
                 for t, v in per_task.items()}

    masked, null_stats = apply_loss_masking(
        per_task, targets, null_mask_prob, generator, coins,
        class_weights=class_weights,
        is_validation=is_validation,
        phase1_mask_null=phase1_mask_null,
        apply_class_weights=apply_class_weights,
    )

    sums = {t: masked[t].sum() for t in keys}
    means = {t: raw_per_sample[t].mean() for t in keys}
    if group is not None:
        n = len(keys)
        parts = ([sums[t] for t in keys] + [raw_per_sample[t].sum() for t in keys]
                 + [null_stats[t][k].float() for k in ("valid_count", "null_total",
                                                       "null_included") for t in keys])
        whole = sum_forward(torch.stack(parts), group)
        rows = float(next(iter(raw_per_sample.values())).shape[0] * group_size(group))
        for i, t in enumerate(keys):
            sums[t], means[t] = whole[i], whole[n + i] / rows
            null_stats[t] = {k: whole[(2 + j) * n + i] for j, k in
                             enumerate(("valid_count", "null_total", "null_included"))}
    weighted = {}
    for i, task in enumerate(keys):
        num_valid = null_stats[task]["valid_count"].float().clamp_min(1e-6)
        weighted[task] = sums[task] / num_valid * task_weights[i]

    total = torch.stack([weighted[t] for t in keys]).sum()
    components = {
        "total": total,
        "tasks": means,
        "weighted_tasks": weighted,
        "null_masking": null_stats,
        "raw_per_sample_losses": raw_per_sample,
    }
    return total, components
