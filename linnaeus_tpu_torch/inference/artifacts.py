"""Artifact loaders: the taxonomy tree and the class-index maps.

Port of linnaeus_tpu/inference/artifacts.py: rank levels are the integer of
'taxa_L{n}', each rank maps class indices to taxon ids, and the taxonomy
tree comes with the names the results quote (source, version, root).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any

from linnaeus_tpu_torch.utils.taxonomy import TaxonomyTree


def rank_level_from_task_key(task_key: str) -> int:
    """'taxa_L10' -> 10."""
    numeric = task_key.split("_L")[-1].replace("_", "").replace(".", "")
    return int("".join(ch for ch in numeric if ch.isdigit()))


@dataclass
class TaxonomyData:
    """The taxonomy tree and what a result says about it."""

    taxonomy_tree: TaxonomyTree
    source: str
    linnaeus_task_keys: list[str]
    version: str | None = None
    root_id: Any | None = None


def taxonomy_data(tree: TaxonomyTree, source: str = "unknown", version: str | None = None,
                  root_id: Any | None = None) -> TaxonomyData:
    return TaxonomyData(taxonomy_tree=tree, source=source, linnaeus_task_keys=list(tree.task_keys),
                        version=version, root_id=root_id)


def load_taxonomy_tree_artifact(
    taxonomy_file_path: str | Path,
    taxonomy_source_name: str = "unknown",
    taxonomy_version_name: str | None = None,
    taxonomy_root_identifier: Any | None = None,
) -> TaxonomyData:
    """Load a taxonomy-tree JSON file (``TaxonomyTree.save``'s format)."""
    path = Path(taxonomy_file_path)
    if not path.is_file():
        raise FileNotFoundError(f"Taxonomy tree file not found: {path}")
    return taxonomy_data(TaxonomyTree.load(str(path)), taxonomy_source_name,
                         taxonomy_version_name, taxonomy_root_identifier)


@dataclass
class ClassIndexMapData:
    """Per-rank class-index <-> taxon-id maps (rank keyed by int level)."""

    idx_to_taxon_id: dict[int, dict[int, int]]
    taxon_id_to_idx: dict[int, dict[int, int]]
    null_taxon_ids: dict[int, int]
    num_classes_per_rank: dict[int, int]


def class_index_maps(
    raw: dict[str, dict[str, int]],
    model_linnaeus_task_keys_ordered: list[str],
    num_classes_per_task: list[int],
    null_class_indices: dict[str, int],
) -> ClassIndexMapData:
    """{task_key: {class_idx_str: taxon_id}} -> rank-keyed maps."""
    idx_to_taxon: dict[int, dict[int, int]] = {}
    taxon_to_idx: dict[int, dict[int, int]] = {}
    null_taxon_ids: dict[int, int] = {}
    num_classes: dict[int, int] = {}
    for task_key, n_cls in zip(model_linnaeus_task_keys_ordered, num_classes_per_task):
        rank = rank_level_from_task_key(task_key)
        fwd = {int(k): int(v) for k, v in raw.get(task_key, {}).items()}
        idx_to_taxon[rank] = fwd
        taxon_to_idx[rank] = {v: k for k, v in fwd.items()}
        num_classes[rank] = int(n_cls)
        null_taxon_ids[rank] = fwd.get(int(null_class_indices.get(task_key, 0)), 0)
    return ClassIndexMapData(
        idx_to_taxon_id=idx_to_taxon,
        taxon_id_to_idx=taxon_to_idx,
        null_taxon_ids=null_taxon_ids,
        num_classes_per_rank=num_classes,
    )


def load_class_index_maps_artifact(
    class_map_file_path: str | Path,
    model_linnaeus_task_keys_ordered: list[str],
    num_classes_per_task: list[int],
    null_class_indices: dict[str, int],
) -> ClassIndexMapData:
    """Load a class-map JSON file into rank-keyed maps."""
    path = Path(class_map_file_path)
    if not path.is_file():
        raise FileNotFoundError(f"Class index map file not found: {path}")
    with open(path) as f:
        raw = json.load(f)
    return class_index_maps(
        raw, model_linnaeus_task_keys_ordered, num_classes_per_task, null_class_indices
    )
