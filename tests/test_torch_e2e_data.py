"""The port's receipt data and end-to-end bench against the TPU package's.

``linnaeus_tpu_torch/tools/e2e_train_bench.py`` against
``linnaeus_tpu/tools/e2e_train_bench.py`` on the same arguments: the
taxonomy (``hierarchy_labels``) and the HDF5 pair (``generate_dataset``)
equal bit for bit, labels and raw uint8 images; the hybrid form (``.npz``
labels, JPEGs) holds the same labels, and its images decoded by the port's
``DirImageSource`` are within the bar of tests/test_native_dataplane.py
(mean |difference| < 3.0 in uint8) of the raw arrays. The HDF5 form and
``feed_ab`` raise by name without h5py. The port's loader over the hybrid
form gives the batches of its loader over the HDF5 form (the same indices
and targets), and ``run_e2e`` trains a tiny mFormerV1 on the hybrid form on
the CPU.
"""

import importlib.util

import h5py
import numpy as np
import pytest

from linnaeus_tpu.tools import e2e_train_bench as jbench
from linnaeus_tpu_torch.data.datasets import DirImageSource
from linnaeus_tpu_torch.data.processor import open_labels
from linnaeus_tpu_torch.tools import e2e_train_bench as tbench

DECODE_BAR = 3.0  # tests/test_native_dataplane.py:60, mean |diff| in uint8
TINY = {
    "CONVNEXT": {"DEPTHS": [1, 1, 1, 1], "DIMS": [8, 16, 32, 64]},
    "ROPE": {"DEPTHS": [1, 1], "DIMS": [32, 64], "NUM_HEADS": [2, 2]},
    "DROP_PATH_RATE": 0.0,
}
# (n, img, learnable, null_frac, species): the JAX generator's two modes,
# nulls, and more rows than one 512-row block
CASES = [(40, 32, True, 0.25, 7), (24, 16, False, 0.0, 999), (520, 8, True, 0.1, 999)]


@pytest.mark.parametrize("learnable", [True, False])
@pytest.mark.parametrize("null_frac", [0.0, 0.3])
def test_hierarchy_labels_match_jax(learnable, null_frac):
    args = dict(species=11, null_frac=null_frac, learnable=learnable)
    got = tbench.hierarchy_labels(57, rng=np.random.default_rng(3), **args)
    want = jbench.hierarchy_labels(57, rng=np.random.default_rng(3), **args)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Each case written by both tools (HDF5) and by the port (hybrid)."""
    out = {}
    for case in CASES:
        n, img, learnable, null_frac, species = case
        d = tmp_path_factory.mktemp("gen")
        args = (n, img, learnable, null_frac, species)
        out[case] = {
            "jax": jbench.generate_dataset(str(d / "jax"), *args),
            "port": tbench.generate_dataset(str(d / "port"), *args),
            "hybrid": tbench.generate_dataset(str(d / "hyb"), *args, hybrid=True),
        }
    return out


def _h5(path: str) -> dict:
    with h5py.File(path, "r") as f:
        return {k: f[k][:] for k in f}


@pytest.mark.parametrize("case", CASES)
def test_generate_dataset_matches_jax_bit_for_bit(datasets, case):
    (jl, ji), (tl, ti) = datasets[case]["jax"], datasets[case]["port"]
    jlab, tlab = _h5(jl), _h5(tl)
    assert jlab.keys() == tlab.keys()
    for k in jlab:
        assert jlab[k].dtype == tlab[k].dtype, k
        np.testing.assert_array_equal(jlab[k], tlab[k], err_msg=k)
    with h5py.File(ji, "r") as a, h5py.File(ti, "r") as b:
        assert a["images"].chunks == b["images"].chunks
        np.testing.assert_array_equal(a["images"][:], b["images"][:])


@pytest.mark.parametrize("case", CASES[:2])
def test_hybrid_form_holds_the_labels_and_decodes_within_the_bar(datasets, case):
    n, img = case[:2]
    jl, ji = datasets[case]["jax"]
    labels, images_dir = datasets[case]["hybrid"]
    assert labels.endswith("_labels.npz")
    want = _h5(jl)
    with open_labels(labels) as f:
        for k, v in want.items():
            np.testing.assert_array_equal(f[k][:], v, err_msg=k)
        ids = [i.decode() for i in f["img_identifiers"][:]]
    source = DirImageSource(images_dir, ids, img)
    with h5py.File(ji, "r") as f:
        raw = f["images"][:]
    for i in range(n):
        decoded = source.read(i)
        assert decoded.shape == raw[i].shape and decoded.dtype == np.uint8
        diff = np.abs(decoded.astype(np.float32) - raw[i]).mean()
        assert diff < DECODE_BAR, f"sample {i}: mean |diff| {diff}"


def test_hdf5_form_and_feed_ab_raise_by_name_without_h5py(tmp_path, monkeypatch):
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "h5py" else real(name, *a))
    with pytest.raises(ModuleNotFoundError, match="h5py"):
        tbench.generate_dataset(str(tmp_path / "x"), 4, 8)
    with pytest.raises(ModuleNotFoundError, match="h5py"):
        tbench.feed_ab("x_labels.h5", "x_images.h5")
    labels, images = tbench.generate_dataset(str(tmp_path / "y"), 4, 8, hybrid=True)
    assert labels.endswith(".npz") and len(list((tmp_path / "y_images").iterdir())) == 4


def test_loader_over_the_hybrid_form_reads_the_hdf5_batches(datasets):
    case = CASES[0]
    (tl, ti), (hl, hi) = datasets[case]["port"], datasets[case]["hybrid"]
    epochs = []
    for labels, images in ((tl, ti), (hl, hi)):
        loader, bundle = tbench.build_loader(labels, images, 8, 2, 2, 1, img=case[1])
        loader.set_epoch(1)
        epochs.append((list(loader), [b.copy() for b in loader.epoch_indices],
                       bundle["num_classes"]))
        loader.close()
    (h5_batches, h5_idx, h5_nc), (hy_batches, hy_idx, hy_nc) = epochs
    assert h5_nc == hy_nc and len(h5_batches) == len(hy_batches) > 0
    for a, b, ia, ib in zip(h5_batches, hy_batches, h5_idx, hy_idx):
        np.testing.assert_array_equal(ia, ib)
        for t in a["targets"]:
            np.testing.assert_array_equal(a["targets"][t], b["targets"][t])
        np.testing.assert_array_equal(a["aux"], b["aux"])
        assert np.abs(a["images"].astype(np.float32) - b["images"]).mean() < DECODE_BAR


def test_feed_ab_reads_the_hdf5_form_both_ways(tmp_path):
    # the bench's size: the direct-chunk reads take rows stored at the size read
    labels, images = tbench.generate_dataset(str(tmp_path / "ab"), 40, tbench.BENCH_IMG,
                                             learnable=True, species=5)
    record = tbench.feed_ab(labels, images, batch=8, pairs=1, window=2, depth=1)
    assert record["pairs"] == 1 and record["speedup"] > 0
    assert record["direct_img_per_sec"][0] > 0 and record["per_row_img_per_sec"][0] > 0
    assert set(record["scaling_on"]) == set(record["scaling_off"]) == {1, 2, 4, 8}


def test_run_e2e_trains_on_the_hybrid_form_on_the_cpu(tmp_path):
    prefix = str(tmp_path / "e2e")
    tbench.generate_dataset(prefix, 24, 32, learnable=True, species=3, hybrid=True)
    record = tbench.run_e2e(steps=2, warmup=1, batch=4, prefix=prefix,
                            io_threads=2, window=2, depth=1, hybrid=True, device="cpu",
                            arch=TINY, img=32)
    assert record["device"] == "cpu" and record["hybrid"] and record["steps"] == 2
    assert record["e2e_images_per_sec"] > 0 and record["total_batches_per_epoch"] >= 1
    assert record["host_feed_images_per_sec_steady"] > 0
    assert record["device_ms_per_step"] > 0 and 0 < record["feed_overlap"]
    assert record["loader"]["batches_emitted"] >= 3


def test_run_e2e_needs_a_card_unless_the_cpu_is_asked_for(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.run_e2e(steps=1, warmup=1, batch=4, prefix=str(tmp_path / "e"),
                       hybrid=True, arch=TINY, img=32)
    loader, _ = tbench.build_loader(*tbench.generate_dataset(str(tmp_path / "r"), 8, 8,
                                                             hybrid=True), 4, 1, 1, 1, img=8)
    with pytest.raises(ValueError, match="zero batches"):  # random genera: no pairs
        tbench._check_batches(loader, 4)
    loader.close()
