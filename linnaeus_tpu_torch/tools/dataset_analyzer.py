"""Label-file dataset analyzer: label density, class balance and hierarchy
statistics over a labels file.

Port of linnaeus_tpu/tools/dataset_analyzer.py (reference parity:
tools/dataset_analyzer.py:432 + tools/analyze_all_datasets.py). Files are
opened with data/processor.py::open_labels: an ``.h5`` through h5py, which
raises by name where h5py is not installed, or an ``.npz`` of the same
datasets (``write_labels_npz``).

    python -m linnaeus_tpu_torch.tools.dataset_analyzer labels.h5 --task-keys taxa_L10 taxa_L20
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from linnaeus_tpu_torch.data.processor import open_labels


def analyze_labels_h5(
    path: str,
    task_keys: list[str],
    meta_sources: list[str] | None = None,
    rarity_percentiles: list[int] = (1, 5, 25, 50, 75, 90, 95, 99),
) -> dict:
    out: dict = {"path": path}
    with open_labels(path) as f:
        n = len(f["img_identifiers"])
        out["num_samples"] = n
        tasks = {}
        for task in task_keys:
            if task not in f:
                tasks[task] = {"present": False}
                continue
            raw = f[task][:]
            non_null = raw != 0
            uniq, counts = np.unique(raw[non_null], return_counts=True)
            tasks[task] = {
                "present": True,
                "num_classes": int(len(uniq)),
                "label_density": float(non_null.mean()),
                "null_fraction": float(1 - non_null.mean()),
                "class_count_min": int(counts.min()) if len(counts) else 0,
                "class_count_max": int(counts.max()) if len(counts) else 0,
                "class_count_mean": float(counts.mean()) if len(counts) else 0.0,
                "gini": _gini(counts) if len(counts) else 0.0,
                "rarity_thresholds": {
                    str(p): float(np.percentile(counts, p)) for p in rarity_percentiles
                } if len(counts) else {},
            }
        out["tasks"] = tasks

        meta = {}
        for src in meta_sources or []:
            if src not in f:
                meta[src] = {"present": False}
                continue
            arr = np.asarray(f[src][:])
            if arr.ndim == 1:
                arr = arr[:, None]
            valid = np.any(arr != 0, axis=1)
            meta[src] = {
                "present": True,
                "dim": int(arr.shape[1]),
                "valid_fraction": float(valid.mean()),
            }
        out["meta"] = meta

        # hierarchy consistency between adjacent task levels
        hier = {}
        for i in range(len(task_keys) - 1):
            child, parent = task_keys[i], task_keys[i + 1]
            if child not in f or parent not in f:
                continue
            c = f[child][:]
            p = f[parent][:]
            both = (c != 0) & (p != 0)
            pairs = set(zip(c[both].tolist(), p[both].tolist()))
            child_parents: dict = {}
            violations = 0
            for ct, pt in pairs:
                if ct in child_parents and child_parents[ct] != pt:
                    violations += 1
                child_parents[ct] = pt
            hier[f"{child}->{parent}"] = {
                "observed_pairs": len(pairs),
                "multi_parent_violations": violations,
            }
        out["hierarchy"] = hier
    return out


def _gini(counts: np.ndarray) -> float:
    sorted_c = np.sort(counts).astype(np.float64)
    n = len(sorted_c)
    cum = np.cumsum(sorted_c)
    return float((n + 1 - 2 * (cum / cum[-1]).sum()) / n)


def analyze_all(
    paths: list[str],
    task_keys: list[str],
    meta_sources: list[str] | None = None,
    output_path: str | None = None,
) -> dict[str, dict]:
    """The analyzer over many label files (reference:
    tools/analyze_all_datasets.py): {path: report}, written as one JSON file
    where ``output_path`` is given."""
    reports = {p: analyze_labels_h5(p, task_keys, meta_sources) for p in paths}
    if output_path:
        with open(output_path, "w") as f:
            json.dump(reports, f, indent=2)
    return reports


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("dataset_analyzer")
    parser.add_argument("paths", nargs="+", help="one or more labels.h5 files")
    parser.add_argument("--task-keys", nargs="+",
                        default=["taxa_L10", "taxa_L20", "taxa_L30", "taxa_L40"])
    parser.add_argument("--meta", nargs="*", default=["temporal", "spatial"])
    parser.add_argument("--output", default=None, help="write combined JSON")
    args = parser.parse_args(argv)
    if len(args.paths) == 1 and not args.output:
        report = analyze_labels_h5(args.paths[0], args.task_keys, args.meta)
    else:
        report = analyze_all(args.paths, args.task_keys, args.meta, args.output)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
