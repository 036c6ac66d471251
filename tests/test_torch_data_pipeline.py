"""The port's data feed against the TPU package's, on the same files.

A seeded labels file of 96 observations over three ranks (nulls, a rank
missing, out-of-region rows, a metadata source read through its
``column_names`` attribute, missing spatial metadata) is written as HDF5
and, through ``data/processor.py::write_labels_npz``, as ``.npz``; images
as an HDF5 dataset (contiguous and one row per chunk) and as a directory of
JPEG and PNG files. Equal means exactly equal throughout: the processor's
class maps, hierarchy map, tree, densities, rarity bins and processed
arrays (from ``.h5`` and from ``.npz``), the sampler's batches for a seed
and an epoch in every mode, ``PrefetchingDataset.read_batch`` from every
image source, and the loaders' batches and their order over two epochs
(the TPU loader with ``device_put_fn=None``, the port's with
``device=None``; on ``device="cpu"`` the same values as tensors; on the
card, tests/test_torch_cuda.py). Each
decode runs the same library (cv2 where it is installed, else PIL) on
both sides; the native JPEG decode of both packages is turned off there
(tests/test_torch_native.py holds the two data planes against each other).
"""

import importlib.util

import h5py
import numpy as np
import pytest
import torch
from PIL import Image

import linnaeus_tpu.data.build as jbuild
import linnaeus_tpu.data.datasets as jds
import linnaeus_tpu.data.image_verifier as jiv
import linnaeus_tpu.data.memcache as jmc
import linnaeus_tpu.data.processor as jproc
import linnaeus_tpu.data.sampler as jsamp
import linnaeus_tpu_torch.data.build as tbuild
import linnaeus_tpu_torch.data.datasets as tds
import linnaeus_tpu_torch.data.image_verifier as tiv
import linnaeus_tpu_torch.data.memcache as tmc
import linnaeus_tpu_torch.data.processor as tproc
import linnaeus_tpu_torch.data.sampler as tsamp
from linnaeus_tpu.configuration import get_default_config as j_default
from linnaeus_tpu_torch.configuration import get_default_config as t_default

N = 96
TASKS = ["taxa_L10", "taxa_L20", "taxa_L30"]
SIDES = {"jax": (j_default, jproc, jbuild, jsamp), "torch": (t_default, tproc, tbuild, tsamp)}


def _label_arrays():
    rng = np.random.default_rng(0)
    species = rng.integers(1, 13, N)  # 12 species under 4 genera under 2 families
    genus = 100 + (species - 1) // 3
    family = 1000 + (genus - 100) // 2
    species[:6] = 0  # null species
    family[6:10] = 0  # a rank missing above a known genus
    spatial = rng.normal(size=(N, 4)).astype(np.float32)
    spatial[10:16] = 0.0  # missing spatial
    return {
        "img_identifiers": np.array([f"img_{i:04d}" for i in range(N)], dtype="S16"),
        "taxa_L10": species.astype(np.int64),
        "taxa_L20": genus.astype(np.int64),
        "taxa_L30": family.astype(np.int64),
        "temporal": rng.normal(size=(N, 2)).astype(np.float32),
        "spatial": spatial,
        "in_region": (rng.uniform(size=N) > 0.1).astype(np.int8),
    }


SPATIAL_COLUMNS = np.array([b"lat", b"lon", b"junk", b"alt"])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("feed")
    arrays = _label_arrays()
    h5 = str(d / "labels.h5")
    with h5py.File(h5, "w") as f:
        for k, v in arrays.items():
            f.create_dataset(k, data=v)
        f["spatial"].attrs["column_names"] = SPATIAL_COLUMNS
    npz = str(d / "labels.npz")
    tproc.write_labels_npz(npz, arrays, {"spatial": {"column_names": SPATIAL_COLUMNS}})
    # two-file mode: the second half as a val file
    halves = {}
    for name, rows in (("train", slice(0, 64)), ("val", slice(64, N))):
        part = {k: v[rows] for k, v in arrays.items()}
        halves[name] = str(d / f"{name}.h5")
        with h5py.File(halves[name], "w") as f:
            for k, v in part.items():
                f.create_dataset(k, data=v)
        tproc.write_labels_npz(str(d / f"{name}.npz"), part)
    rng = np.random.default_rng(1)
    pixels = rng.integers(0, 256, (N, 16, 16, 3), dtype=np.uint8)
    images = str(d / "images.h5")
    with h5py.File(images, "w") as f:
        f.create_dataset("images", data=pixels)
    chunked = str(d / "chunked.h5")
    with h5py.File(chunked, "w") as f:
        f.create_dataset("images", data=pixels, chunks=(1, 16, 16, 3))
    img_dir = d / "imgs"
    img_dir.mkdir()
    for i, ident in enumerate(arrays["img_identifiers"]):
        smooth = np.clip(np.linspace(0, 255, 40)[None, :, None] * rng.uniform(0.3, 1, 3)
                         + rng.integers(0, 40, (40, 1, 1)), 0, 255).astype(np.uint8)
        smooth = np.broadcast_to(smooth, (40, 40, 3)).copy()
        Image.fromarray(smooth).save(img_dir / f"{ident.decode()}.jpg", quality=90)
        Image.fromarray(smooth).save(img_dir / f"{ident.decode()}.png")
    return {"h5": h5, "npz": npz, "images": images, "chunked": chunked, "dir": str(img_dir),
            "train_h5": halves["train"], "val_h5": halves["val"],
            "train_npz": str(d / "train.npz"), "val_npz": str(d / "val.npz")}


def config(side, labels=None, images=None, two_file=None, **overrides):
    cfg = SIDES[side][0]()
    cfg.DATA.TASK_KEYS_H5 = list(TASKS)
    cfg.DATA.PARTIAL.LEVELS = True
    cfg.DATA.IMG_SIZE = 16
    cfg.DATA.BATCH_SIZE = 8
    cfg.DATA.BATCH_SIZE_VAL = 8
    cfg.DATA.H5.TRAIN_VAL_SPLIT_RATIO = 0.75
    cfg.DATA.PREFETCH.MEM_CACHE_SIZE = 1 << 20
    cfg.DATA.NATIVE_DATAPLANE = "off"
    cfg.SCHEDULE.MIX.GROUP_LEVELS = ["taxa_L20", "taxa_L10"]
    cfg.DATA.SAMPLER.GROUPED_MODE = "mixed-pairs"
    cfg.DATA.META.COMPONENTS.SPATIAL.COLUMNS = ["lon", "lat", "alt"]
    cfg.DATA.META.COMPONENTS.SPATIAL.OOR_MASK = True
    cfg.METRICS.TAXA_SUBSETS = [["g101", "taxa_L20", 101], ["f1000", "taxa_L30", 1000]]
    cfg.METRICS.RARITY_PERCENTILES = [25, 50, 90]
    if two_file:
        cfg.DATA.H5.TRAIN_LABELS_PATH, cfg.DATA.H5.VAL_LABELS_PATH = two_file
    else:
        cfg.DATA.H5.LABELS_PATH = labels
    cfg.DATA.H5.IMAGES_PATH = images
    for dotted, value in overrides.items():
        node = cfg
        parts = dotted.split(".")
        for p in parts[:-1]:
            node = node[p]
        node[parts[-1]] = value
    return cfg


def _plain(x):
    """Arrays -> (dtype, nested lists), recursively, so == compares all."""
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.tolist())
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def processor_view(proc, data):
    """Everything the processor derives, as comparable values."""
    return _plain({
        "class_to_idx": proc.class_to_idx, "num_classes": proc.num_classes,
        "class_label_counts": proc.class_label_counts,
        "task_label_density": proc.task_label_density,
        "task_nulls_density": proc.task_nulls_density,
        "meta_label_density": proc.meta_label_density,
        "hierarchy_map": proc.hierarchy_map, "rarity_thresholds": proc.rarity_thresholds,
        "rarity_bins": {t: proc.rarity_class_bins(t) for t in TASKS},
        "taxa_selectors": proc.taxa_subset_selectors(),
        "tree": proc.taxonomy_tree.build_hierarchy_matrices(),
        "data": [vars(x) if hasattr(x, "img_identifiers") else x for x in data],
    })


def process(side, files, source, mode, partial_levels):
    if mode == "single":
        cfg = config(side, files[source])
    else:
        cfg = config(side, two_file=(files[f"train_{source}"], files[f"val_{source}"]))
    cfg.DATA.PARTIAL.LEVELS = partial_levels
    proc = SIDES[side][1].DatasetProcessor(cfg)
    if mode == "single":
        out = proc.process_single_file(cfg.DATA.H5.LABELS_PATH, 0.75, 42)
        data = [out[0], out[2], out[3]]
    else:
        data = list(proc.process(cfg.DATA.H5.TRAIN_LABELS_PATH, cfg.DATA.H5.VAL_LABELS_PATH))
    return processor_view(proc, data)


@pytest.mark.parametrize("partial_levels", [True, False])
@pytest.mark.parametrize("mode", ["single", "two_files"])
@pytest.mark.parametrize("source", ["h5", "npz"])
def test_processor_matches_jax(files, source, mode, partial_levels):
    """Class maps, hierarchy map and tree, densities, rarity bins, taxa
    subsets and the processed arrays and split: the port's processor on the
    .h5 or the .npz against the TPU package's on the .h5."""
    got = process("torch", files, source, mode, partial_levels)
    want = process("jax", files, "h5", mode, partial_levels)
    assert got == want
    assert got["num_classes"]["taxa_L10"] == (13 if partial_levels else 12)


def test_h5_labels_without_h5py_raise_by_name(files, monkeypatch):
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "h5py" else real(name, *a))
    with pytest.raises(ModuleNotFoundError, match="h5py is not installed"):
        tproc.open_labels(files["h5"])
    with pytest.raises(ModuleNotFoundError, match="h5py is not installed"):
        tds.H5ImageSource(files["images"], 16).read(0)
    with tproc.open_labels(files["npz"]) as f:  # the adapter needs no h5py
        assert "taxa_L10" in f and len(f["img_identifiers"]) == N


def _groups(files):
    proc = tproc.DatasetProcessor(config("torch", files["h5"]))
    data, _, train_idx, _ = proc.process_single_file(files["h5"], 0.75, 42)
    return data.group_ids, train_idx


@pytest.mark.parametrize("level", ["taxa_L20", "taxa_L10"])
@pytest.mark.parametrize("mode", ["standard", "mixed-pairs", "strict-group"])
def test_sampler_batches_match_jax(files, mode, level):
    groups, idx = _groups(files)
    for epoch in (0, 1, 5):
        got, want = [], []
        for mod, out in ((tsamp, got), (jsamp, want)):
            s = mod.GroupedBatchSampler(groups, idx, 8, mode=mode, seed=7, initial_level=level)
            s.set_epoch(epoch)
            out.extend(b.tolist() for b in s.batches())
        assert got == want and len(got) > 0


SOURCES = {
    "h5": lambda m, f, labels: m.H5ImageSource(f["images"], 16),
    "h5_direct_chunk": lambda m, f, labels: m.H5ImageSource(f["chunked"], 16, direct_chunk="on"),
    "h5_resized": lambda m, f, labels: m.H5ImageSource(f["images"], 12),
    "dir_jpg": lambda m, f, labels: m.DirImageSource(
        f["dir"], labels.img_identifiers, 32, ".jpg", native="off"),
    "dir_png": lambda m, f, labels: m.DirImageSource(f["dir"], labels.img_identifiers, 24, ".png",
                                                     native="off"),
    "synthetic": lambda m, f, labels: m.SyntheticImageSource(16, seed=3),
}


@pytest.mark.parametrize("source", SOURCES)
def test_read_batch_matches_jax(files, source):
    """``PrefetchingDataset.read_batch`` (a cache in front of the source,
    read twice so the second batch comes from it) from every image source."""
    proc = tproc.DatasetProcessor(config("torch", files["h5"]))
    labels, _, _, _ = proc.process_single_file(files["h5"], 0.75, 42)
    indices = np.array([5, 3, 90, 17, 3, 44])
    out = {}
    for side, mod in (("jax", jds), ("torch", tds)):
        ds = mod.PrefetchingDataset(labels, SOURCES[source](mod, files, labels), TASKS,
                                    mem_cache_bytes=1 << 20, group_level="taxa_L20")
        out[side] = [ds.read_batch(indices), ds.read_batch(indices[::-1])]
        out[side].append(ds.cache.stats())
        ds.close()
    for got, want in zip(out["torch"][:2], out["jax"][:2]):
        assert got["images"].dtype == want["images"].dtype
        np.testing.assert_array_equal(got["images"], want["images"])
        for t in TASKS:
            np.testing.assert_array_equal(got["targets"][t], want["targets"][t])
        np.testing.assert_array_equal(got["aux"], want["aux"])
        np.testing.assert_array_equal(got["group_ids"], want["group_ids"])
    assert out["torch"][2] == out["jax"][2]


def _loader_batches(side, cfg, epochs=(0, 1), **loader_kw):
    build = SIDES[side][2]
    bundle = build.build_datasets(cfg)
    train, val = build.build_loaders(cfg, bundle, **loader_kw)
    out = []
    for epoch in epochs:
        train.set_epoch(epoch)
        out.append(list(train))
        out.append(list(val))
    stats = train.pipeline_metrics()
    train.close()
    val.close()
    return out, stats


def _as_numpy(batch):
    return {k: (_as_numpy(v) if isinstance(v, dict) else
                v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in batch.items()}


def _assert_same_batches(got, want):
    assert [len(x) for x in got] == [len(x) for x in want]
    for g_epoch, w_epoch in zip(got, want):
        for g, w in zip(g_epoch, w_epoch):
            g = _as_numpy(g)
            np.testing.assert_array_equal(g["images"], w["images"])
            for t in TASKS:
                np.testing.assert_array_equal(g["targets"][t], w["targets"][t])
            np.testing.assert_array_equal(g["aux"], w["aux"])
            np.testing.assert_array_equal(g["group_ids"], w["group_ids"])


@pytest.mark.parametrize("images", ["h5", "dir"])
def test_loader_batches_match_jax(files, images):
    """The loaders from build_datasets / build_loaders, two epochs of train
    and val batches, the same batches in the same order; on the CPU device
    the port's loader gives the same values as tensors."""
    extra = {}
    if images == "dir":
        extra = {"DATA.HYBRID.USE_HYBRID": True, "DATA.HYBRID.IMAGES_DIR": files["dir"],
                 "DATA.HYBRID.FILE_EXTENSION": ".jpg", "DATA.IMG_SIZE": 24}
    want, _ = _loader_batches("jax", config("jax", files["h5"], files["images"], **extra),
                              device_put_fn=None)
    got, stats = _loader_batches("torch", config("torch", files["npz"], files["images"], **extra),
                                 device=None)
    _assert_same_batches(got, want)
    on_cpu, _ = _loader_batches("torch", config("torch", files["h5"], files["images"], **extra),
                                device="cpu")
    assert isinstance(on_cpu[0][0]["images"], torch.Tensor)
    _assert_same_batches(on_cpu, want)
    assert stats["batches_emitted"] == len(got[0]) + len(got[2])
    assert stats["throughput_samples_per_sec"] > 0


def test_loader_epoch_indices_are_the_samplers(files):
    cfg = config("torch", files["npz"], files["images"])
    bundle = tbuild.build_datasets(cfg)
    train, val = tbuild.build_loaders(cfg, bundle)
    train.set_epoch(3)
    batches = list(train)
    sampler = tsamp.build_sampler(cfg, bundle["train_dataset"].labels.group_ids,
                                  bundle["train_indices"], 8, is_train=True)
    sampler.set_epoch(3)
    assert [b.tolist() for b in train.epoch_indices] == [b.tolist() for b in sampler.batches()]
    for batch, idx in zip(batches, train.epoch_indices):
        np.testing.assert_array_equal(batch["targets"]["taxa_L10"],
                                      bundle["train_dataset"].labels.labels["taxa_L10"][idx])
    train.close()
    val.close()


def test_image_verifier_exclusions_match_jax(files, tmp_path):
    """Missing image files: the verifier's missing set and the indices
    build_datasets keeps, under the threshold; over it both raise."""
    import shutil

    d = tmp_path / "imgs"
    shutil.copytree(files["dir"], d)
    for i in (2, 30, 71):
        (d / f"img_{i:04d}.jpg").unlink()
    extra = {"DATA.HYBRID.USE_HYBRID": True, "DATA.HYBRID.IMAGES_DIR": str(d),
             "DATA.HYBRID.FILE_EXTENSION": ".jpg", "DATA.HYBRID.VERIFY_IMAGES.ENABLED": True,
             "DATA.HYBRID.VERIFY_IMAGES.MAX_MISSING_COUNT": 5,
             "DATA.HYBRID.VERIFY_IMAGES.CHUNK_SIZE": 7}
    out = {}
    for side, build in (("jax", jbuild), ("torch", tbuild)):
        bundle = build.build_datasets(config(side, files["h5"], None, **extra))
        out[side] = (bundle["train_indices"].tolist(), bundle["val_indices"].tolist())
    assert out["torch"] == out["jax"]
    assert not {2, 30, 71} & set(out["torch"][0] + out["torch"][1])
    idents = [f"img_{i:04d}" for i in range(N)]
    for mod in (jiv, tiv):
        missing, ids = mod.ImageVerifier(str(d), max_missing_count=5, chunk_size=10).verify_images(
            idents)
        assert missing == {2, 30, 71} and ids == ["img_0002", "img_0030", "img_0071"]
        with pytest.raises(RuntimeError, match="Too many missing images"):
            mod.ImageVerifier(str(d), max_missing_count=2).verify_images(idents)


def test_memcache_copy_matches_jax():
    out = {}
    for side, mod in (("jax", jmc), ("torch", tmc)):
        cache = mod.MemoryCache(100)
        for k in range(8):
            cache.put(k, np.zeros(30, np.uint8))
            cache.get(k - 2)
        cache.put("big", np.zeros(200, np.uint8))
        out[side] = (cache.stats(), list(cache._store))
    assert out["torch"] == out["jax"]


def test_unported_feed_options_raise_by_name(files):
    """DATA.NATIVE_DATAPLANE 'on' is ported since (tests/test_torch_native.py;
    the Trainer under it: tests/test_torch_trainer.py), and so are the
    PARALLEL settings: the datasets build as the TPU package's do (the mesh
    and its checks are the Trainer's; a rank's rows are the loader's,
    tests/test_torch_multiprocess_trainer.py)."""
    for key, value in (("PARALLEL.MESH.DATA", 2), ("PARALLEL.MULTI_HOST", True),
                       ("PARALLEL.PARAM_SHARDING", "fsdp"), ("PARALLEL.MESH.MODEL", 2),
                       ("PARALLEL.SEQUENCE_PARALLEL", True), ("PARALLEL.PIPELINE.STAGES", 2)):
        ours = tbuild.build_datasets(config("torch", files["h5"], files["images"],
                                            **{key: value}))
        theirs = jbuild.build_datasets(config("jax", files["h5"], files["images"],
                                              **{key: value}))
        for part in ("train_indices", "val_indices"):
            np.testing.assert_array_equal(ours[part], theirs[part], err_msg=key)
        assert ours["num_classes"] == theirs["num_classes"]


def test_host_augmentation_runs_in_the_loader(files):
    """AUG.SINGLE_AUG_DEVICE 'cpu': the loader hands out float32 images in
    [0, 1], augmented on the host, the same for the same epoch."""
    cfg = config("torch", files["npz"], files["images"], **{"AUG.SINGLE_AUG_DEVICE": "cpu"})
    raw = config("torch", files["npz"], files["images"])
    (aug, _, aug_again, _), _ = _loader_batches("torch", cfg, epochs=(0, 0))
    (plain, _, _, _), _ = _loader_batches("torch", raw, epochs=(0, 0))
    a, p = aug[0]["images"], plain[0]["images"]
    assert a.dtype == np.float32 and p.dtype == np.uint8 and a.shape == p.shape
    assert 0.0 <= a.min() and a.max() <= 1.0
    assert np.abs(a - p / 255.0).mean() > 1e-2
    np.testing.assert_array_equal(a, aug_again[0]["images"])
