"""Validate the hierarchy of a labels file: the observed (child, parent)
taxon pairs form a single-parent forest and a TaxonomyTree can be built.

Port of linnaeus_tpu/tools/validate_taxonomy_h5.py (reference parity:
linnaeus/tools/validate_taxonomy_h5.py), over the port's DatasetProcessor
and TaxonomyTree. The file is opened as the processor opens it
(data/processor.py::open_labels: HDF5 needs h5py and raises by name without
it).

    python -m linnaeus_tpu_torch.tools.validate_taxonomy_h5 labels.h5 --task-keys taxa_L10 taxa_L20
"""

from __future__ import annotations

import argparse
import json
import sys


def validate(path: str, task_keys: list[str], partial_levels: bool = True) -> dict:
    from linnaeus_tpu_torch.configuration import get_default_config
    from linnaeus_tpu_torch.data.processor import DatasetProcessor

    cfg = get_default_config()
    cfg.DATA.TASK_KEYS_H5 = list(task_keys)
    cfg.DATA.PARTIAL.LEVELS = partial_levels
    cfg.DATA.META.ACTIVE = False
    proc = DatasetProcessor(cfg)
    result: dict = {"path": path, "valid": True, "errors": []}
    try:
        proc._build_class_maps([path])
        hier = proc._generate_hierarchy_map([path])
        from linnaeus_tpu_torch.utils.taxonomy import TaxonomyTree

        tree = TaxonomyTree(hier, task_keys, proc.num_classes)
        result["num_classes"] = proc.num_classes
        result["roots"] = len(tree.roots)
        result["leaves"] = len(tree.leaves)
        # orphans: non-null classes without a parent at the next level
        orphans = {}
        for task in task_keys[:-1]:
            start = 1 if partial_levels else 0
            n_orphan = sum(1 for idx in range(start, proc.num_classes[task])
                           if tree.get_parent((task, idx)) is None)
            if n_orphan:
                orphans[task] = n_orphan
        result["orphans"] = orphans
    except Exception as e:  # noqa: BLE001 every failure is the report's
        result["valid"] = False
        result["errors"].append(str(e))
    return result


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("validate_taxonomy_h5")
    parser.add_argument("path")
    parser.add_argument("--task-keys", nargs="+",
                        default=["taxa_L10", "taxa_L20", "taxa_L30", "taxa_L40"])
    parser.add_argument("--no-partial", action="store_true")
    args = parser.parse_args(argv)
    result = validate(args.path, args.task_keys, not args.no_partial)
    print(json.dumps(result, indent=2))
    sys.exit(0 if result["valid"] else 1)


if __name__ == "__main__":
    main()
