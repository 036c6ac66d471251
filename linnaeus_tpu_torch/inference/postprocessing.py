"""Hierarchical-consistency postprocessing.

Port of linnaeus_tpu/inference/postprocessing.py. Walking coarse->fine:
if a rank's top prediction is null, all finer ranks become null; if a finer
rank's top prediction is not a child of the coarser rank's top prediction in
the taxonomy, it is nulled as well.
"""

from __future__ import annotations

from .artifacts import ClassIndexMapData, TaxonomyData
from .schemas import HierarchicalClassificationResult, TaskPrediction


def enforce_hierarchical_consistency(
    result: HierarchicalClassificationResult,
    taxonomy_data: TaxonomyData,
    class_maps: ClassIndexMapData,
) -> HierarchicalClassificationResult:
    if not result.tasks:
        return result
    tree = taxonomy_data.taxonomy_tree

    # coarse (highest rank value) first
    sorted_tasks = sorted(result.tasks, key=lambda t: t.rank_level, reverse=True)
    out_tasks: dict[str, TaskPrediction] = {t.task_key: t for t in result.tasks}

    parent_node: tuple[str, int] | None = None
    parent_is_null = False
    for task in sorted_tasks:
        rank = task.rank_level
        null_taxon = class_maps.null_taxon_ids.get(rank, 0)
        preds = list(task.predictions)
        top_taxon = preds[0][0] if preds else null_taxon

        if parent_is_null:
            out_tasks[task.task_key] = TaskPrediction(
                rank_level=rank, task_key=task.task_key,
                predictions=[(null_taxon, 1.0)],
            )
            continue

        if top_taxon == null_taxon:
            parent_is_null = True
            parent_node = None
            continue

        idx = class_maps.taxon_id_to_idx.get(rank, {}).get(top_taxon)
        node = (task.task_key, idx) if idx is not None else None
        if parent_node is not None and node is not None:
            actual_parent = tree.get_parent(node)
            if actual_parent is not None and actual_parent != parent_node:
                # inconsistent: null this and all finer ranks
                out_tasks[task.task_key] = TaskPrediction(
                    rank_level=rank, task_key=task.task_key,
                    predictions=[(null_taxon, 1.0)],
                )
                parent_is_null = True
                parent_node = None
                continue
        parent_node = node

    return HierarchicalClassificationResult(
        taxonomy_context=result.taxonomy_context,
        tasks=[out_tasks[t.task_key] for t in result.tasks],
    )
