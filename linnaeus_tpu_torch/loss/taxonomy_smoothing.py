"""Taxonomy-aware label smoothing matrices.

Port of linnaeus_tpu/loss/taxonomy_smoothing.py (numpy only). Builds a [C, C]
probability matrix where row i distributes ``alpha`` smoothing mass over
incorrect classes proportional to exp(-beta * taxonomic distance); the true
class keeps ``1 - alpha``. Root-level classes optionally smooth uniformly.
"""

from __future__ import annotations

import numpy as np


def build_taxonomy_smoothing_matrix(
    num_classes: int,
    distances: np.ndarray,
    alpha: float = 0.1,
    beta: float = 1.0,
    uniform_roots: bool = True,
    root_class_ids: list[int] | None = None,
) -> np.ndarray:
    if not (0.0 <= alpha <= 1.0):
        raise ValueError(f"alpha must be in [0, 1], got {alpha}")
    if beta < 0:
        raise ValueError(f"beta must be non-negative, got {beta}")
    if distances.shape != (num_classes, num_classes):
        raise ValueError(
            f"distances must be ({num_classes},{num_classes}), got {distances.shape}"
        )
    root_class_ids = set(root_class_ids or [])

    weights = np.exp(-beta * distances.astype(np.float64))
    weights[~np.isfinite(distances)] = 0.0

    prob = np.zeros((num_classes, num_classes), dtype=np.float32)
    for i in range(num_classes):
        row = weights[i].copy()
        row[i] = 0.0
        if uniform_roots and i in root_class_ids and num_classes > 1:
            row = np.full(num_classes, 1.0 / (num_classes - 1))
            row[i] = 0.0
        s = row.sum()
        if s > 0:
            prob[i] = (alpha * row / s).astype(np.float32)
            prob[i, i] = 1.0 - alpha
        else:
            # no neighbors: all mass on the true class
            prob[i, i] = 1.0
    return prob


def build_matrices_for_tasks(
    taxonomy_tree,
    task_keys: list[str],
    enabled: list[bool],
    alpha: float = 0.1,
    beta: float = 1.0,
    uniform_roots: bool = True,
    fallback_to_uniform: bool = True,
) -> dict[str, np.ndarray]:
    """Per-task smoothing matrices for the tasks flagged in ``enabled``."""
    out: dict[str, np.ndarray] = {}
    root_levels = {n[0] for n in taxonomy_tree.roots} if taxonomy_tree else set()
    for task, on in zip(task_keys, enabled):
        if not on:
            continue
        n = taxonomy_tree.num_classes[task]
        dist = taxonomy_tree.build_distance_matrix(task)
        roots = (
            [idx for (lvl, idx) in taxonomy_tree.roots if lvl == task]
            if task in root_levels
            else []
        )
        out[task] = build_taxonomy_smoothing_matrix(
            n, dist, alpha=alpha, beta=beta,
            uniform_roots=uniform_roots, root_class_ids=roots,
        )
    return out
