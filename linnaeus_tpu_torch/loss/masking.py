"""Null masking and class weighting of per-sample losses.

Port of linnaeus_tpu/loss/masking.py. A sample is null-labelled at a task
when its label index is 0 (hard) or its one-hot row puts mass on index 0
(soft). With probability ``null_mask_prob`` a null sample's loss is
included (1.0 keeps all nulls, 0.0 drops all); non-null samples always
count. The coins come from an explicit ``torch.Generator`` or are handed in
(``coins``: task -> uniform [B]); with neither, the probability must be 0
or 1, where no coin is needed.
"""

from __future__ import annotations

from typing import Mapping

import torch


def null_sample_mask(target: torch.Tensor) -> torch.Tensor:
    """Boolean [B]: True where the sample's label is the null class (index 0)."""
    if target.dim() == 1:
        return target == 0
    return target[:, 0] > 0.5


def apply_null_masking(
    per_task_losses: dict[str, torch.Tensor],
    targets: dict[str, torch.Tensor],
    null_mask_prob: float | torch.Tensor,
    generator: torch.Generator | None = None,
    coins: Mapping[str, torch.Tensor] | None = None,
):
    """Returns (masked_losses, stats). Each stats entry has null_total,
    null_included and valid_count (scalar tensors)."""
    masked, stats = {}, {}
    for task, loss_vec in per_task_losses.items():
        tgt = targets[task]
        is_null = null_sample_mask(tgt)
        # unmapped samples (label -1: all-zero one-hot row / negative index)
        # are neither null nor valid: they must not count in valid_count, or
        # a mostly-unlabelled task's mean loss deflates
        has_label = tgt.sum(dim=-1) > 0 if tgt.dim() == 2 else tgt >= 0
        if coins is not None:
            coin = coins[task]
        elif generator is not None:
            coin = torch.rand(loss_vec.shape, generator=generator, device=loss_vec.device)
        elif isinstance(null_mask_prob, (int, float)) and null_mask_prob in (0, 1):
            coin = torch.full(loss_vec.shape, 0.5, device=loss_vec.device)
        else:
            raise ValueError(
                "apply_null_masking: a probability strictly between 0 and 1 needs a "
                "torch.Generator or the coins themselves"
            )
        include_null = coin < null_mask_prob
        keep = has_label & torch.where(is_null, include_null, torch.ones_like(include_null))
        masked[task] = torch.where(keep, loss_vec, torch.zeros_like(loss_vec))
        stats[task] = {
            "null_total": is_null.sum(),
            "null_included": (is_null & include_null).sum(),
            "valid_count": keep.sum(),
        }
    return masked, stats


def apply_class_weighting(
    per_task_losses: dict[str, torch.Tensor],
    targets: dict[str, torch.Tensor],
    class_weights: Mapping[str, torch.Tensor] | None,
) -> dict[str, torch.Tensor]:
    """Scale per-sample losses by per-class weights (dense [C] tensors)."""
    if not class_weights:
        return per_task_losses
    out = {}
    for task, loss_vec in per_task_losses.items():
        cw = class_weights.get(task)
        if cw is None:
            out[task] = loss_vec
            continue
        tgt = targets[task]
        cw = torch.as_tensor(cw, dtype=loss_vec.dtype, device=loss_vec.device)
        if tgt.dim() == 1:
            w = cw[tgt]
        else:
            w = (tgt.to(loss_vec.dtype) * cw[None, :]).sum(dim=-1)
        out[task] = loss_vec * w
    return out


def apply_loss_masking(
    per_task_losses: dict[str, torch.Tensor],
    targets: dict[str, torch.Tensor],
    null_mask_prob: float | torch.Tensor,
    generator: torch.Generator | None = None,
    coins: Mapping[str, torch.Tensor] | None = None,
    class_weights: Mapping[str, torch.Tensor] | None = None,
    is_validation: bool = False,
    phase1_mask_null: bool = False,
    apply_class_weights: bool = True,
):
    """Null masking, then class weighting. Validation disables null masking
    (probability 1); phase 1 forces it (probability 0)."""
    if is_validation:
        prob = 1.0
    elif phase1_mask_null:
        prob = 0.0
    else:
        prob = null_mask_prob
    masked, stats = apply_null_masking(per_task_losses, targets, prob, generator, coins)
    if apply_class_weights:
        masked = apply_class_weighting(masked, targets, class_weights)
    return masked, stats
