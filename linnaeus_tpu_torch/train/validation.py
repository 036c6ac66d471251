"""Standalone validation entry points + shared summary math.

Reference parity: validation.py:49 (validate_one_pass) and :341
(validate_with_partial_mask) expose a module-level API; the Trainer's
internal ``_validate`` (train/loop.py) uses the SAME ``accumulate_batch`` /
``summarize_totals`` helpers below, so the two paths cannot drift.

Port of linnaeus_tpu/train/validation.py. The eval step (train/step.py)
runs under ``torch.no_grad()`` with the model in eval mode; its metrics are
fetched to the host once per batch.
"""

from __future__ import annotations

import numpy as np
import torch

from linnaeus_tpu_torch.loss.basic import one_hot
from linnaeus_tpu_torch.metrics.chain_accuracy import chain_accuracy_counts


def to_host(metrics: dict) -> dict:
    """Scalar tensors -> Python floats, in one device-to-host transfer."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor) and v.dim() == 0]
    out = {k: v for k, v in metrics.items() if k not in keys}
    if keys:
        values = torch.stack([metrics[k].double() for k in keys]).cpu().tolist()
        out.update(zip(keys, values))
    return out


def soft_targets(targets: dict, num_classes: dict) -> dict:
    """Integer labels -> one-hot rows (-1, unmapped, -> all zeros)."""
    return {t: one_hot(v, num_classes[t]) if v.dim() == 1 else v for t, v in targets.items()}


def eval_masks(batch: dict, mask_meta: bool, combo_mask) -> tuple[torch.Tensor, torch.Tensor]:
    """The eval step's ``mask_meta`` and ``partial_combo_mask`` operands on
    the batch's device."""
    device = batch["images"].device
    return (torch.tensor(bool(mask_meta), device=device),
            torch.as_tensor(np.asarray(combo_mask, np.float32), device=device))


def accumulate_batch(
    totals: dict[str, float], count: float, host: dict
) -> tuple[dict[str, float], float]:
    """Fold one eval-step metrics dict (host values) into running totals.

    Losses are weighted by the batch count; correct/valid/subset counts
    accumulate raw.
    """
    b = float(host["count"])
    count += b
    for k, v in host.items():
        if k == "count":
            continue
        totals[k] = totals.get(k, 0.0) + float(v) * (
            b if k.startswith("loss") else 1.0
        )
    return totals, count


def summarize_totals(
    totals: dict[str, float],
    count: float,
    chain_correct: float = 0.0,
    chain_total: float = 0.0,
) -> dict[str, float]:
    """Totals -> phase summary: per-task acc1/acc3 over VALID samples,
    mean losses, null/non-null + rarity + taxa subset accuracies, chain
    accuracy (reference: validation.py summary + tracker subset wrappers)."""
    summary: dict[str, float] = {}
    if count == 0:
        return summary
    for k, v in totals.items():
        if k.startswith("loss"):
            summary[k] = v / count
        elif k.startswith("correct1/"):
            task = k.split("/", 1)[1]
            denom = totals.get(f"valid_count/{task}", count) or count
            summary["acc1/" + task] = v / denom
        elif k.startswith("correct3/"):
            task = k.split("/", 1)[1]
            denom = totals.get(f"valid_count/{task}", count) or count
            summary["acc3/" + task] = v / denom
        elif k.startswith("subset_correct1/"):
            # null / non_null / rarity-bin / taxa buckets
            name = k[len("subset_correct1/"):]
            denom = totals.get(f"subset_count/{name}", 0.0)
            if denom > 0:
                summary[f"acc1_{name}"] = v / denom
    if chain_total > 0:
        summary["chain_accuracy"] = chain_correct / chain_total
    return summary


def _run_pass(
    eval_step,
    state,
    loader,
    task_keys,
    num_classes,
    mask_meta: bool,
    combo_mask: np.ndarray,
) -> dict[str, float]:
    totals: dict[str, float] = {}
    count = 0.0
    chain_correct = chain_total = 0.0
    for batch in loader:
        metrics, outputs = eval_step(state, batch, *eval_masks(batch, mask_meta, combo_mask))
        totals, count = accumulate_batch(totals, count, to_host(metrics))
        cc, ct = chain_accuracy_counts(
            outputs, soft_targets(batch["targets"], num_classes), tuple(task_keys))
        chain_correct += float(cc)
        chain_total += float(ct)
    return summarize_totals(totals, count, chain_correct, chain_total)


def validate_one_pass(
    eval_step,
    state,
    loader,
    task_keys,
    num_classes,
    meta_dim: int,
    mask_meta: bool = False,
) -> dict[str, float]:
    """Normal validation, or all-meta-masked when ``mask_meta``
    (reference: validation.py:49, zeroed aux at :174-175)."""
    return _run_pass(
        eval_step, state, loader, task_keys, num_classes,
        mask_meta, np.zeros((meta_dim,), np.float32),
    )


def validate_with_partial_mask(
    eval_step,
    state,
    loader,
    task_keys,
    num_classes,
    combo_mask: np.ndarray,
) -> dict[str, float]:
    """Validation with a specific metadata component combination masked
    (reference: validation.py:341). ``combo_mask``: [meta_dim] 0/1 columns."""
    return _run_pass(
        eval_step, state, loader, task_keys, num_classes, False,
        np.asarray(combo_mask, np.float32),
    )
