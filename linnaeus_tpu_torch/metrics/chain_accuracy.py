"""Vectorized hierarchical chain accuracy.

Port of linnaeus_tpu/metrics/chain_accuracy.py (reference parity:
utils/metrics/chain_accuracy.py:51,185): a sample counts as chain-correct
only if its prediction is correct at EVERY task level; null-labeled levels
(class 0) can be ignored (treated as correct) so partially-labeled samples
still contribute.
"""

from __future__ import annotations

import torch


def _true_idx(target: torch.Tensor) -> torch.Tensor:
    return target.argmax(dim=-1) if target.dim() == 2 else target


def chain_accuracy_counts(
    outputs: dict[str, torch.Tensor],
    targets: dict[str, torch.Tensor],
    task_keys: tuple[str, ...],
    ignore_null: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (num_chain_correct, num_considered) as device scalars.

    With ``ignore_null``, levels whose true label is the null class (0) are
    skipped for that sample; samples that are null at EVERY level are
    excluded from the denominator.
    """
    first = targets[task_keys[0]]
    B = first.shape[0]
    all_correct = torch.ones(B, dtype=torch.bool, device=first.device)
    any_non_null = torch.zeros(B, dtype=torch.bool, device=first.device)
    for t in task_keys:
        true = _true_idx(targets[t])
        pred = outputs[t].argmax(dim=-1)
        correct = pred == true
        if ignore_null:
            is_null = true == 0
            correct = correct | is_null
            any_non_null = any_non_null | ~is_null
        else:
            any_non_null = torch.ones(B, dtype=torch.bool, device=first.device)
        all_correct = all_correct & correct
    considered = any_non_null
    return (all_correct & considered).sum(), considered.sum()
