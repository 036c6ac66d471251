"""Vectorized one-pass dataset processor.

Reference parity: h5data/vectorized_dataset_processor.py:58-1226. One numpy
scan of the labels HDF5 builds everything the pipeline needs:

  * ``class_to_idx`` per task (taxon_id -> class index; null -> index 0 when
    DATA.PARTIAL.LEVELS)
  * dense per-sample class-index label arrays (int32 [N] per task; -1 =
    unmapped/skip) — unlike the reference, labels are vectorized ONCE here
    instead of being re-mapped per sample in the reader hot path
  * packed metadata array aux [N, total_dim] (+ per-component validity)
  * group_ids per rank level (class index at that level; -1 for null)
  * hierarchy_map (child task -> {child_idx: parent_idx}) + TaxonomyTree
  * task label densities, per-class counts, rarity-percentile subsets
  * upward-major-rank check and out-of-region masking

Label HDF5 schema (same as the reference): datasets ``img_identifiers``,
one int dataset per task key (0 = missing), one float dataset per metadata
SOURCE (optional ``column_names`` attr), optional ``in_region``.

Port of linnaeus_tpu/data/processor.py. Every labels file is opened by
``open_labels``: an ``.h5`` through h5py, imported there (a machine without
h5py raises by name when it is asked to open one), or an ``.npz`` that holds
the same dataset names, with each attribute the processor reads carried as
an array named ``<dataset>.attrs.<attribute>`` (``write_labels_npz`` writes
one). The ``.npz`` is an adapter for a machine without h5py, not a format of
its own: the same labels give the same processed result through either.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Any

import numpy as np

from linnaeus_tpu_torch.utils.logging import get_h5data_logger, get_main_logger
from linnaeus_tpu_torch.utils.meta import get_enabled_meta_components
from linnaeus_tpu_torch.utils.taxonomy import TaxonomyTree

logger = get_main_logger()
h5logger = get_h5data_logger()

NPZ_ATTR_SEP = ".attrs."


class _NpzDataset:
    """One array of an ``.npz`` labels file, with its attributes, read the
    way the processor reads an h5py dataset (``[:]``, ``len``, ``.attrs``)."""

    def __init__(self, data: np.ndarray, attrs: dict[str, np.ndarray]):
        self._data = data
        self.attrs = attrs

    def __getitem__(self, key):
        return self._data[key]

    def __len__(self) -> int:
        return len(self._data)


class _NpzLabels:
    """An ``.npz`` labels file opened like an h5py file: ``name in f``,
    ``f[name]``, usable as a context manager."""

    def __init__(self, path: str):
        with np.load(path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
        self._datasets: dict[str, _NpzDataset] = {}
        for key, value in arrays.items():
            if NPZ_ATTR_SEP not in key:
                attrs = {
                    k.split(NPZ_ATTR_SEP, 1)[1]: v
                    for k, v in arrays.items()
                    if k.startswith(key + NPZ_ATTR_SEP)
                }
                self._datasets[key] = _NpzDataset(value, attrs)

    def __contains__(self, name: str) -> bool:
        return name in self._datasets

    def __getitem__(self, name: str) -> _NpzDataset:
        return self._datasets[name]

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


def open_labels(path: str):
    """Open a labels file for reading: an ``.npz`` (see the module
    docstring), else HDF5 through h5py. Use as ``with open_labels(p) as f``."""
    if str(path).endswith(".npz"):
        return _NpzLabels(path)
    if importlib.util.find_spec("h5py") is None:
        raise ModuleNotFoundError(
            f"open_labels: {path} is HDF5 and h5py is not installed; write the "
            "labels as .npz (data/processor.py::write_labels_npz) on this machine"
        )
    import h5py

    return h5py.File(path, "r")


def write_labels_npz(path: str, datasets: dict[str, np.ndarray],
                     attrs: dict[str, dict[str, Any]] | None = None) -> None:
    """Write labels as ``.npz``: the datasets by name, and each attribute of
    ``attrs[dataset]`` as the array ``<dataset>.attrs.<attribute>``."""
    arrays = {k: np.asarray(v) for k, v in datasets.items()}
    for name, named in (attrs or {}).items():
        for attr, value in named.items():
            arrays[f"{name}{NPZ_ATTR_SEP}{attr}"] = np.asarray(value)
    np.savez(path, **arrays)


class ProcessedLabels:
    """Container for one split's processed label data."""

    def __init__(self):
        self.labels: dict[str, np.ndarray] = {}  # task -> int32 [N] class idx
        self.aux: np.ndarray | None = None  # [N, meta_dim] float32
        self.meta_validity: dict[str, np.ndarray] = {}  # comp -> bool [N]
        self.group_ids: dict[str, np.ndarray] = {}  # rank -> int32 [N]
        self.subset_ids: dict[str, np.ndarray] = {}  # subset -> int32 [N]
        self.valid_mask: np.ndarray | None = None  # bool [N]
        self.img_identifiers: list[str] = []

    @property
    def num_samples(self) -> int:
        return len(self.img_identifiers)

    def valid_indices(self) -> np.ndarray:
        return np.nonzero(self.valid_mask)[0]


class DatasetProcessor:
    """One-pass processor over train (and optional val) label files."""

    def __init__(self, config):
        self.config = config
        self.task_keys = list(config.DATA.TASK_KEYS_H5)
        self.partial_levels = bool(config.DATA.PARTIAL.LEVELS)
        self.upward_major_check = bool(config.DATA.UPWARD_MAJOR_CHECK)
        self.include_oor = bool(config.DATA.OUT_OF_REGION.INCLUDE)
        self.meta_components = dict(get_enabled_meta_components(config))
        self.rarity_percentiles = list(config.METRICS.RARITY_PERCENTILES)
        # [(name, rank_key, taxon_id), ...] — custom taxa subsets
        # (reference: vectorized_dataset_processor.py:859-867)
        self.taxa_subsets = [tuple(s) for s in config.METRICS.get("TAXA_SUBSETS", [])]

        self.class_to_idx: dict[str, dict[Any, int]] = {}
        self.num_classes: dict[str, int] = {}
        self.class_label_counts: dict[str, np.ndarray] = {}
        self.task_label_density: dict[str, dict[str, float]] = {}
        self.task_nulls_density: dict[str, dict[str, float]] = {}
        self.meta_label_density: dict[str, dict[str, float]] = {}
        self.hierarchy_map: dict[str, dict[int, int]] = {}
        self.taxonomy_tree: TaxonomyTree | None = None
        self.rarity_thresholds: dict[str, dict[int, float]] = {}

    # ------------------------------------------------------------------ API
    def process(
        self,
        train_labels_path: str,
        val_labels_path: str | None = None,
    ) -> tuple[ProcessedLabels, ProcessedLabels | None]:
        """Two-file (or train-only) processing."""
        self._build_class_maps([train_labels_path] +
                               ([val_labels_path] if val_labels_path else []))
        with open_labels(train_labels_path) as f:
            train = self._process_file(f, "train")
        val = None
        if val_labels_path:
            with open_labels(val_labels_path) as f:
                val = self._process_file(f, "val")
        self._finalize([train_labels_path] +
                       ([val_labels_path] if val_labels_path else []), train)
        return train, val

    def process_single_file(
        self,
        labels_path: str,
        split_ratio: float = 0.9,
        split_seed: int = 42,
    ) -> tuple[ProcessedLabels, ProcessedLabels, np.ndarray, np.ndarray]:
        """Single-file mode: returns (data, data, train_indices, val_indices).

        The same ProcessedLabels backs both splits; index arrays select
        samples (reference: _SingleFileH5SubsetWrapper, h5data/build.py:903).
        """
        self._build_class_maps([labels_path])
        with open_labels(labels_path) as f:
            data = self._process_file(f, "all")
        self._finalize([labels_path], data)
        valid = data.valid_indices()
        rng = np.random.default_rng(split_seed)
        perm = rng.permutation(len(valid))
        n_train = int(len(valid) * split_ratio)
        train_idx = np.sort(valid[perm[:n_train]])
        val_idx = np.sort(valid[perm[n_train:]])
        return data, data, train_idx, val_idx

    # --------------------------------------------------------------- stages
    def _build_class_maps(self, files: list[str]) -> None:
        """Union of observed taxon ids across files -> contiguous indices
        (vectorized_dataset_processor.py:457,680-688)."""
        for task in self.task_keys:
            uniq: set = set()
            for path in files:
                with open_labels(path) as f:
                    if task not in f:
                        raise KeyError(f"Task dataset '{task}' missing in {path}")
                    uniq.update(np.unique(f[task][:]).tolist())
            uniq.discard(0)
            ordered = sorted(uniq)
            if self.partial_levels:
                idx_map = {"null": 0}
                idx_map.update({tax: i + 1 for i, tax in enumerate(ordered)})
            else:
                idx_map = {tax: i for i, tax in enumerate(ordered)}
            self.class_to_idx[task] = idx_map
            self.num_classes[task] = len(idx_map)
        logger.info(
            "Class maps built: "
            + ", ".join(f"{t}={self.num_classes[t]}" for t in self.task_keys)
        )

    def _vectorized_label_lookup(self, raw: np.ndarray, task: str) -> np.ndarray:
        """taxon ids -> class indices; -1 for unmapped; null(0) -> 0 when
        partial_levels else -1."""
        idx_map = self.class_to_idx[task]
        keys = np.array([k for k in idx_map if k != "null"], dtype=raw.dtype)
        vals = np.array([idx_map[k] for k in idx_map if k != "null"], dtype=np.int32)
        out = np.full(raw.shape, -1, dtype=np.int32)
        if len(keys):
            order = np.argsort(keys)
            keys_s, vals_s = keys[order], vals[order]
            pos = np.searchsorted(keys_s, raw)
            pos = np.clip(pos, 0, len(keys_s) - 1)
            hit = keys_s[pos] == raw
            out[hit] = vals_s[pos[hit]]
        if self.partial_levels:
            out[raw == 0] = 0
        else:
            out[raw == 0] = -1
        return out

    def _process_file(self, f, split: str) -> ProcessedLabels:
        out = ProcessedLabels()
        n = len(f["img_identifiers"])
        raw_ids = f["img_identifiers"][:]
        out.img_identifiers = [
            i.decode("utf-8", "replace") if isinstance(i, bytes) else str(i)
            for i in raw_ids
        ]
        valid = np.ones(n, dtype=bool)

        # out-of-region (in_region dataset: 1 = in region)
        oor_mask = None
        if "in_region" in f:
            in_region = np.asarray(f["in_region"][:], dtype=bool)
            oor_mask = ~in_region
            if not self.include_oor:
                valid &= in_region
                h5logger.info(
                    f"[{split}] excluded {int(oor_mask.sum())} out-of-region samples"
                )

        # labels
        raw_labels = {}
        for task in self.task_keys:
            raw = f[task][:]
            raw_labels[task] = raw
            out.labels[task] = self._vectorized_label_lookup(raw, task)
            if not self.partial_levels:
                valid &= raw != 0  # skip samples missing this rank

        # upward major-rank check: non-null at rank k requires non-null below
        if self.upward_major_check and self.partial_levels:
            nonnull = np.stack(
                [raw_labels[t] != 0 for t in self.task_keys]
            )  # [T, N] fine->coarse
            ok = np.ones(n, dtype=bool)
            for k in range(1, len(self.task_keys)):
                # if rank k non-null, all finer ranks must be non-null
                ok &= ~nonnull[k] | np.all(nonnull[:k], axis=0)
            removed = int((~ok & valid).sum())
            if removed:
                h5logger.info(f"[{split}] upward-major check removed {removed}")
            valid &= ok

        # metadata
        chunks, validity = [], {}
        for comp_name, comp_cfg in self.meta_components.items():
            src = comp_cfg.get("SOURCE")
            dim = int(comp_cfg.get("DIM", 0))
            if src not in f:
                h5logger.warning(f"[{split}] meta source '{src}' missing; zeros")
                arr = np.zeros((n, dim), dtype=np.float32)
            else:
                arr = np.asarray(f[src][:], dtype=np.float32)
                if arr.ndim == 1:
                    arr = arr[:, None]
                cols = list(comp_cfg.get("COLUMNS", []) or [])
                if cols and "column_names" in f[src].attrs:
                    actual = [
                        c.decode("utf-8", "replace") if isinstance(c, bytes) else c
                        for c in list(f[src].attrs["column_names"])
                    ]
                    sel = [actual.index(c) for c in cols if c in actual]
                    if sel:
                        arr = arr[:, sel]
                if arr.shape[1] != dim:
                    h5logger.warning(
                        f"[{split}] meta '{comp_name}' dim {arr.shape[1]} != "
                        f"configured {dim}; padding/truncating"
                    )
                    fixed = np.zeros((n, dim), dtype=np.float32)
                    fixed[:, : min(dim, arr.shape[1])] = arr[:, :dim]
                    arr = fixed
            if comp_cfg.get("OOR_MASK", False) and oor_mask is not None:
                arr[oor_mask] = 0.0
            comp_valid = np.any(arr != 0, axis=1)
            validity[comp_name] = comp_valid
            if not comp_cfg.get("ALLOW_MISSING", True):
                valid &= comp_valid
            chunks.append(arr)
        out.aux = (
            np.concatenate(chunks, axis=1).astype(np.float32)
            if chunks
            else np.zeros((n, 0), dtype=np.float32)
        )
        out.meta_validity = validity

        # group ids per rank level = class index at that level (-1 for null).
        # Groups smaller than SCHEDULE.MIX.MIN_GROUP_SIZE are marked -1 too,
        # exactly like the reference (vectorized_dataset_processor.py:845,
        # 1220). NOTE the downstream consequences are also the reference's:
        # in 'mixed-pairs' sampler mode ungrouped samples are excluded from
        # batches entirely (reference grouped_batch_sampler.py:303-305 skips
        # gid -1), so tail classes below the threshold never train at that
        # grouping level; 'strict-group' mode still round-robins them in.
        # Logged below so the drop is visible, not silent.
        min_group = int(self.config.SCHEDULE.MIX.MIN_GROUP_SIZE)
        for task in self.task_keys:
            gids = out.labels[task].astype(np.int32).copy()
            if self.partial_levels:
                gids[gids == 0] = -1  # nulls don't group together
            if min_group > 1 and len(gids):
                counts = np.bincount(gids[gids >= 0], minlength=0)
                small = np.zeros(len(gids), dtype=bool)
                pos = gids >= 0
                small[pos] = counts[gids[pos]] < min_group
                gids[small] = -1
                n_small = int(small.sum())
                if n_small:
                    logger.info(
                        f"[{split}] {task}: {n_small} samples in groups "
                        f"smaller than MIN_GROUP_SIZE={min_group} marked "
                        "ungrouped (excluded from mixed-pairs batches)"
                    )
            out.group_ids[task] = gids

        out.valid_mask = valid

        # densities (over valid samples)
        nv = max(int(valid.sum()), 1)
        for task in self.task_keys:
            raw = raw_labels[task]
            non_null = int(((raw != 0) & valid).sum())
            self.task_label_density.setdefault(task, {})[split] = non_null / nv
            self.task_nulls_density.setdefault(task, {})[split] = 1 - non_null / nv
        for comp_name, comp_valid in validity.items():
            self.meta_label_density.setdefault(comp_name, {})[split] = (
                int((comp_valid & valid).sum()) / nv
            )

        if split in ("train", "all"):
            for task in self.task_keys:
                counts = np.bincount(
                    out.labels[task][valid & (out.labels[task] >= 0)],
                    minlength=self.num_classes[task],
                )
                self.class_label_counts[task] = counts

        h5logger.info(
            f"[{split}] processed {n} samples, {int(valid.sum())} valid"
        )
        return out

    def _finalize(self, files: list[str], train: ProcessedLabels) -> None:
        self.hierarchy_map = self._generate_hierarchy_map(files)
        self.taxonomy_tree = TaxonomyTree(
            hierarchy_map=self.hierarchy_map,
            task_keys=self.task_keys,
            num_classes=self.num_classes,
        )
        self._calculate_rarity_subsets(train)

    def _generate_hierarchy_map(self, files: list[str]) -> dict:
        """Observed (child, parent) taxon pairs -> class-index map
        (vectorized_dataset_processor.py:989)."""
        if len(self.task_keys) < 2:
            return {}
        mapping_out: dict[str, dict[int, int]] = {}
        for i in range(len(self.task_keys) - 1):
            child_task = self.task_keys[i]
            parent_task = self.task_keys[i + 1]
            pairs = []
            for path in files:
                with open_labels(path) as f:
                    c = f[child_task][:]
                    p = f[parent_task][:]
                    keep = (c != 0) & (p != 0)
                    if np.any(keep):
                        pairs.append(np.column_stack([c[keep], p[keep]]))
            local: dict[int, int] = {}
            if pairs:
                uniq = np.unique(np.concatenate(pairs, axis=0), axis=0)
                cmap = self.class_to_idx[child_task]
                pmap = self.class_to_idx[parent_task]
                for ct, pt in uniq:
                    ct_k = ct if ct in cmap else int(ct)
                    pt_k = pt if pt in pmap else int(pt)
                    if ct_k in cmap and pt_k in pmap:
                        local[cmap[ct_k]] = pmap[pt_k]
            mapping_out[child_task] = local
        return mapping_out

    def _calculate_rarity_subsets(self, train: ProcessedLabels) -> None:
        """Percentile-bin subset ids per task from train class frequencies
        (vectorized_dataset_processor.py:1031-1146)."""
        for task in self.task_keys:
            counts = self.class_label_counts.get(task)
            if counts is None or counts.sum() == 0:
                continue
            nz = counts[counts > 0]
            thr = {
                pct: float(np.percentile(nz, pct))
                for pct in self.rarity_percentiles
            }
            self.rarity_thresholds[task] = thr
            labels = train.labels[task]
            class_count_of_sample = np.where(
                labels >= 0, counts[np.clip(labels, 0, None)], 0
            )
            # subset id = index of the smallest percentile bin containing it
            bins = np.full(labels.shape, len(self.rarity_percentiles), np.int32)
            for bi, pct in enumerate(sorted(self.rarity_percentiles)):
                sel = (class_count_of_sample <= thr[pct]) & (
                    bins == len(self.rarity_percentiles)
                )
                bins[sel] = bi
            train.subset_ids[f"rarity_{task}"] = bins

    def taxa_subset_selectors(self) -> dict[str, tuple[str, int]]:
        """name -> (rank_key, class_index) for each configured taxa subset.

        Membership in a taxa subset (e.g. "aves" at taxa_L40) is a pure
        function of the sample's class at that rank, so the jitted eval step
        can select members by comparing the target index against the class
        index — no per-sample subset ids in the pipeline (reference builds
        them per sample: vectorized_dataset_processor.py:859-880)."""
        out: dict[str, tuple[str, int]] = {}
        for entry in self.taxa_subsets:
            if len(entry) != 3:
                continue
            name, rank_key, taxon_id = entry
            cmap = self.class_to_idx.get(rank_key)
            if not cmap:
                continue
            cid = cmap.get(taxon_id, cmap.get(int(taxon_id)))
            if cid is not None:
                out[str(name)] = (str(rank_key), int(cid))
        return out

    def rarity_class_bins(self, task: str) -> np.ndarray | None:
        """Class-index -> rarity-bin table (int32 [num_classes]).

        The per-sample bins above are a pure function of the sample's class
        count, so a class-level table is equivalent — and it lets the jitted
        eval step bucket metrics with one device gather instead of threading
        per-sample subset ids through the input pipeline (reference carries
        subset_ids per sample: vectorized_dataset_processor.py:1031-1146)."""
        counts = self.class_label_counts.get(task)
        thr = self.rarity_thresholds.get(task)
        if counts is None or not thr:
            return None
        bins = np.full(counts.shape, len(self.rarity_percentiles), np.int32)
        for bi, pct in enumerate(sorted(self.rarity_percentiles)):
            sel = (counts <= thr[pct]) & (bins == len(self.rarity_percentiles))
            bins[sel] = bi
        return bins


def process_and_save_dataset_metadata(processor: DatasetProcessor, assets_dir: str):
    """Persist class maps / densities / hierarchy to the assets dir
    (reference: utils/dataset_metadata.py:17)."""
    import json

    os.makedirs(assets_dir, exist_ok=True)
    with open(os.path.join(assets_dir, "dataset_metadata.json"), "w") as fh:
        json.dump(
            {
                "task_keys": processor.task_keys,
                "num_classes": processor.num_classes,
                "class_to_idx": {
                    t: {str(k): v for k, v in m.items()}
                    for t, m in processor.class_to_idx.items()
                },
                "task_label_density": processor.task_label_density,
                "task_nulls_density": processor.task_nulls_density,
                "meta_label_density": processor.meta_label_density,
                "rarity_thresholds": {
                    t: {str(k): v for k, v in m.items()}
                    for t, m in processor.rarity_thresholds.items()
                },
            },
            fh,
            indent=2,
        )
    if processor.taxonomy_tree is not None:
        processor.taxonomy_tree.save(os.path.join(assets_dir, "taxonomy.json"))
