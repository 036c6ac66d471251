"""Loss preparation: per-task train/val criteria from config.

Port of linnaeus_tpu/loss/utils.py (``prepare_loss_functions``,
``calculate_class_weights``). Criteria are plain callables
``(logits, target) -> per-sample [B]`` for closure into the train step.
"""

from __future__ import annotations

import functools
import logging
from typing import Callable

import numpy as np
import torch

from .basic import (
    cross_entropy,
    label_smoothing_cross_entropy,
    soft_target_cross_entropy,
    taxonomy_smoothed_cross_entropy,
)
from .taxonomy_smoothing import build_matrices_for_tasks

logger = logging.getLogger(__name__)


def _make_criterion(
    name: str,
    smoothing: float,
    taxonomy_matrix: np.ndarray | None,
    device: torch.device | str | None = None,
) -> Callable:
    if taxonomy_matrix is not None:
        matrix = torch.as_tensor(taxonomy_matrix, device=device)
        return functools.partial(taxonomy_smoothed_cross_entropy, smoothing_matrix=matrix)
    if name in ("CrossEntropyLoss", "CrossEntropy"):
        return cross_entropy
    if name in ("LabelSmoothingCrossEntropy", "LabelSmoothing"):
        return functools.partial(label_smoothing_cross_entropy, smoothing=smoothing)
    if name in ("SoftTargetCrossEntropy", "SoftTargetCE"):
        return soft_target_cross_entropy
    raise ValueError(f"Unknown loss function '{name}'")


def prepare_loss_functions(
    config,
    num_classes: dict[str, int],
    taxonomy_tree=None,
    device: torch.device | str | None = None,
) -> tuple[dict[str, Callable], dict[str, Callable]]:
    """Build (train_criteria, val_criteria) keyed by task. ``device`` is
    where taxonomy smoothing matrices are placed."""
    task_keys = list(config.DATA.TASK_KEYS_H5)
    smoothing = float(config.MODEL.LABEL_SMOOTHING)

    tax_cfg = config.LOSS.TAXONOMY_SMOOTHING
    enabled = list(tax_cfg.get("ENABLED", []))
    if len(enabled) < len(task_keys):
        enabled = enabled + [False] * (len(task_keys) - len(enabled))
    tax_matrices: dict[str, np.ndarray] = {}
    if any(enabled) and taxonomy_tree is not None:
        tax_matrices = build_matrices_for_tasks(
            taxonomy_tree,
            task_keys,
            enabled,
            alpha=float(tax_cfg.ALPHA),
            beta=float(tax_cfg.BETA),
            uniform_roots=bool(tax_cfg.UNIFORM_ROOTS),
            fallback_to_uniform=bool(tax_cfg.FALLBACK_TO_UNIFORM),
        )
    elif any(enabled):
        logger.warning(
            "TAXONOMY_SMOOTHING enabled but no taxonomy_tree provided; "
            "falling back to plain criteria."
        )

    def build(funcs: list[str]) -> dict[str, Callable]:
        out = {}
        for i, task in enumerate(task_keys):
            name = funcs[i] if i < len(funcs) else "CrossEntropyLoss"
            out[task] = _make_criterion(name, smoothing, tax_matrices.get(task), device)
        return out

    train = build(list(config.LOSS.TASK_SPECIFIC.TRAIN.FUNCS))
    val = build(list(config.LOSS.TASK_SPECIFIC.VAL.FUNCS))
    return train, val


def calculate_class_weights(
    class_counts: dict[str, np.ndarray],
    mode: str = "inverse",
    clip_max: float = 10.0,
) -> dict[str, np.ndarray]:
    """Dense per-class weights from label frequency.

    ``inverse``: w_c = mean_count / count_c (clipped); the null class
    (index 0) keeps weight 1.0.
    """
    out = {}
    for task, counts in class_counts.items():
        counts = np.asarray(counts, dtype=np.float64)
        nz = counts.copy()
        nz[nz == 0] = 1.0
        if mode == "inverse":
            w = counts.mean() / nz
        elif mode == "sqrt_inverse":
            w = np.sqrt(counts.mean() / nz)
        else:
            w = np.ones_like(nz)
        w = np.clip(w, 0.0, clip_max)
        if len(w) > 0:
            w[0] = 1.0  # null class unweighted
        out[task] = w.astype(np.float32)
    return out
