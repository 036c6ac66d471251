"""The port's host data plane (linnaeus_tpu_torch/native/, cv2) against the
TPU package's (linnaeus_tpu/native/, dataplane.cpp over libjpeg) on the same
bytes and files, and against PIL at the TPU package's own bars.

Against dataplane.cpp: every pixel within 1 u8 and the mean |diff| at most
0.15 u8 an image, over each DCT scale denominator (1, 2, 4, 8), an upscale
on one side only and on both, grayscale, progressive, 4:4:4 and restart
markers; the statuses equal exactly for PNG content behind a .jpg name, a
CMYK JPEG, truncated bytes (in the scan: libjpeg decodes them; in the
header: it refuses), empty bytes, a missing file and a path under a file
(ENOTDIR). Only these comparisons skip, and only where dataplane.cpp does not
build (no g++ or libjpeg), as tests/test_native_dataplane.py skips.

Against PIL, the bars of tests/test_native_dataplane.py (mean |diff| < 3.0
u8; < 0.05 after normalisation). Then the pool: two threads calling at once
get the serial rows, ``threads=k`` bounds a call's concurrency to k, and the
switches: LINNAEUS_TPU_NATIVE=0, 'on' without cv2 raising by name.
"""

import io
import os
import threading

import cv2
import numpy as np
import pytest
from PIL import Image

import linnaeus_tpu_torch.native as tnative
from linnaeus_tpu_torch.data.datasets import DirImageSource, PrefetchingDataset
from linnaeus_tpu_torch.data.processor import ProcessedLabels

TARGET = 96
BAR_MAX, BAR_MEAN = 1, 0.15  # against dataplane.cpp, u8
PIL_BAR = 3.0  # tests/test_native_dataplane.py:59, mean |diff| in u8


def _photo(h, w, seed, channels=3):
    """A smooth pattern with noise: JPEG content like a photo's."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (127 + 60 * np.sin(xx / (17 + 7 * seed % 5))[..., None]
            + 50 * np.cos(yy / (11 + 3 * seed % 7))[..., None])
    pixels = np.clip(base + rng.normal(0, 10, (h, w, channels)), 0, 255).astype(np.uint8)
    return pixels[..., 0] if channels == 1 else pixels


def _jpeg(pixels, **kw):
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, "JPEG", **kw)
    return buf.getvalue()


# (name, height, width, encoder options); TARGET = 96
GOOD = {
    "denom_1": (150, 130, {"quality": 90}),
    "denom_2": (200, 260, {"quality": 90}),
    "denom_4": (400, 390, {"quality": 90}),
    "denom_8": (800, 1000, {"quality": 90}),
    "same_size": (96, 96, {"quality": 90}),
    "upscale_one_side": (60, 200, {"quality": 90}),
    "upscale_both": (50, 70, {"quality": 90}),
    "grayscale": (300, 200, {"quality": 90, "gray": True}),
    "progressive": (500, 400, {"quality": 85, "progressive": True}),
    "subsampling_444": (333, 222, {"quality": 95, "subsampling": 0}),
    "restart_markers": (300, 300, {"rst": 4}),
}


def _good_bytes(name):
    h, w, opts = GOOD[name]
    opts = dict(opts)
    seed = sorted(GOOD).index(name)
    if opts.pop("gray", False):
        return _jpeg(_photo(h, w, seed, channels=1), **opts)
    if "rst" in opts:
        ok, buf = cv2.imencode(".jpg", _photo(h, w, seed),
                               [cv2.IMWRITE_JPEG_RST_INTERVAL, opts["rst"]])
        assert ok
        return buf.tobytes()
    return _jpeg(_photo(h, w, seed), **opts)


def _bad_bytes(name):
    good = _jpeg(_photo(400, 390, 1), quality=90)
    if name == "png_behind_jpg":
        buf = io.BytesIO()
        Image.fromarray(_photo(100, 100, 2)).save(buf, "PNG")
        return buf.getvalue()
    if name == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(_photo(100, 100, 3)).convert("CMYK").save(buf, "JPEG")
        return buf.getvalue()
    if name == "truncated_scan":
        return good[: len(good) // 2]
    if name == "truncated_header":
        return good[:100]
    if name == "empty":
        return b""
    if name == "soi_then_garbage":
        return b"\xff\xd8this is not a jpeg"
    raise KeyError(name)


BAD = ["png_behind_jpg", "cmyk", "truncated_scan", "truncated_header", "empty",
       "soi_then_garbage"]


@pytest.fixture(scope="module")
def tdp():
    dp = tnative.get_dataplane()
    assert dp is not None, "cv2 is installed here, so the data plane must be"
    return dp


@pytest.fixture(scope="module")
def jdp():
    from linnaeus_tpu.native import get_dataplane

    dp = get_dataplane()
    if dp is None:
        pytest.skip("the TPU package's native dataplane does not build here (no g++/libjpeg)")
    return dp


def _within_bar(a, b):
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert diff.max() <= BAR_MAX, f"max |diff| {diff.max()}"
    assert diff.mean() <= BAR_MEAN, f"mean |diff| {diff.mean()}"


# ------------------------------------------------- against dataplane.cpp


@pytest.mark.parametrize("name", list(GOOD))
def test_memory_decode_matches_dataplane_cpp(tdp, jdp, name):
    buf = _good_bytes(name)
    got, gs = tdp.decode_jpeg_mem_batch([buf], TARGET)
    want, ws = jdp.decode_jpeg_mem_batch([buf], TARGET)
    assert gs.tolist() == ws.tolist() == [0]
    assert got.shape == want.shape == (1, TARGET, TARGET, 3) and got.dtype == np.uint8
    _within_bar(got, want)


def test_the_denominator_rule_and_the_header(tdp):
    for name, d in (("denom_1", 1), ("denom_2", 2), ("denom_4", 4), ("denom_8", 8),
                    ("upscale_one_side", 1)):
        h, w, _ = GOOD[name]
        assert tnative.jpeg_header(_good_bytes(name)) == (w, h, 3)
        assert tnative.scale_denom(w, h, TARGET) == d
    assert tnative.jpeg_header(_good_bytes("grayscale"))[2] == 1
    assert tnative.jpeg_header(_bad_bytes("cmyk"))[2] == 4
    for name in ("png_behind_jpg", "truncated_header", "empty", "soi_then_garbage"):
        assert tnative.jpeg_header(_bad_bytes(name)) is None


@pytest.mark.parametrize("name", BAD)
def test_memory_statuses_match_dataplane_cpp(tdp, jdp, name):
    buf = _bad_bytes(name)
    good = _good_bytes("denom_2")
    got, gs = tdp.decode_jpeg_mem_batch([good, buf], TARGET)
    want, ws = jdp.decode_jpeg_mem_batch([good, buf], TARGET)
    assert gs.tolist() == ws.tolist()
    if gs[1] != 0:
        assert got[1].max() == 0  # the zero placeholder
    _within_bar(got, want)


@pytest.fixture(scope="module")
def jpeg_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("native_files")
    paths = {}
    for name in GOOD:
        paths[name] = str(d / f"{name}.jpg")
        with open(paths[name], "wb") as f:
            f.write(_good_bytes(name))
    for name in BAD:
        paths[name] = str(d / f"{name}.jpg")
        with open(paths[name], "wb") as f:
            f.write(_bad_bytes(name))
    paths["missing"] = str(d / "not_there.jpg")
    paths["under_a_file"] = os.path.join(paths["denom_1"], "x.jpg")  # ENOTDIR
    return d, paths


def test_file_decode_matches_dataplane_cpp(tdp, jdp, jpeg_files):
    _, paths = jpeg_files
    names = list(GOOD) + BAD + ["missing", "under_a_file"]
    batch = [paths[n] for n in names]
    got, gs = tdp.decode_jpeg_batch(batch, TARGET, allow_missing=True)
    want, ws = jdp.decode_jpeg_batch(batch, TARGET, allow_missing=True)
    assert dict(zip(names, gs.tolist())) == dict(zip(names, ws.tolist()))
    assert [s for n, s in zip(names, gs.tolist()) if n in ("missing", "under_a_file")] == [1, 1]
    assert (got[gs != 0] == 0).all()
    _within_bar(got, want)
    for name in ("missing", "under_a_file"):
        for dp in (tdp, jdp):
            with pytest.raises(FileNotFoundError):
                dp.decode_jpeg_batch([paths["denom_1"], paths[name]], TARGET)


def test_a_file_that_cannot_be_opened_raises_oserror(tdp, jpeg_files, monkeypatch):
    """Status 3 (the file exists but cannot be opened: EACCES, EMFILE, EIO)
    raises OSError, allow_missing or not, and is never a FileNotFoundError
    (dataplane.cpp's contract; the process here reads every file, so the
    refusal is made by replacing ``open``)."""
    _, paths = jpeg_files
    locked = paths["denom_2"]

    def refusing_open(path, *args, **kwargs):
        if path == locked:
            raise PermissionError(13, "Permission denied", path)
        return open(path, *args, **kwargs)

    monkeypatch.setattr(tnative, "open", refusing_open, raising=False)
    for allow in (True, False):
        with pytest.raises(OSError, match="could not be opened") as err:
            tdp.decode_jpeg_batch([paths["denom_1"], locked], TARGET, allow_missing=allow)
        assert not isinstance(err.value, FileNotFoundError)


# ------------------------------------------------ against PIL (JAX's bars)


@pytest.mark.parametrize("name", ["denom_1", "denom_2", "denom_4", "denom_8", "upscale_both",
                                  "grayscale", "progressive"])
def test_decode_matches_pil_within_the_tpu_packages_bar(tdp, name):
    buf = _good_bytes(name)
    got, status = tdp.decode_jpeg_mem_batch([buf], TARGET)
    ref = np.asarray(Image.open(io.BytesIO(buf)).convert("RGB").resize(
        (TARGET, TARGET), Image.BILINEAR)).astype(np.float32)
    assert status.tolist() == [0]
    assert np.abs(got[0].astype(np.float32) - ref).mean() < PIL_BAR


def test_serving_preprocess_matches_the_pil_path_within_the_bar(tdp):
    """preprocess_image_batch takes the data plane for JPEG bytes; against
    the per-image PIL path within the TPU package's normalised bar, and a
    corrupt row raises as the PIL path raises."""
    from linnaeus_tpu_torch.inference.config import InferenceConfig
    from linnaeus_tpu_torch.inference.preprocessing import (
        preprocess_image_batch,
        preprocess_image_u8,
    )

    cfg = InferenceConfig.from_dict(dict(
        model={"architecture_name": "tiny_v1", "weights_path": "w.msgpack",
               "model_task_keys_ordered": ["taxa_L10"], "num_classes_per_task": [5],
               "null_class_indices": {"taxa_L10": 0}, "expected_aux_vector_length": 11},
        input_preprocessing={"image_size": [3, TARGET, TARGET]},
        metadata_preprocessing={},
        taxonomy_data={"source_name": "t", "taxonomy_tree_path": "t.json",
                       "class_index_map_path": "c.json"},
        inference_options={},
    ))
    bufs = [_good_bytes(n) for n in ("denom_1", "denom_2", "denom_4")]
    before = tdp.mem_batches
    native = preprocess_image_batch(bufs, cfg)
    assert tdp.mem_batches == before + 1
    pil = np.stack([preprocess_image_u8(np.asarray(Image.open(io.BytesIO(b))), cfg)
                    for b in bufs])
    mean = np.asarray(cfg.input_preprocessing.image_mean, np.float32)
    std = np.asarray(cfg.input_preprocessing.image_std, np.float32)

    def norm(u8):
        return (u8.astype(np.float32) / 255.0 - mean) / std

    assert native.shape == (3, TARGET, TARGET, 3) and native.dtype == np.uint8
    assert np.abs(norm(native) - norm(pil)).mean() < 0.05
    with pytest.raises(Exception):
        preprocess_image_batch([bufs[0], b"\xff\xd8corrupt"], cfg)


# ------------------------------------------------------------- the pool


def test_concurrent_calls_give_the_serial_rows(tdp, jpeg_files):
    _, paths = jpeg_files
    batch = [paths[n] for n in GOOD]
    want, _ = tdp.decode_jpeg_batch(batch, TARGET, threads=1)
    results, errors = [None, None], []

    def worker(slot):
        try:
            for _ in range(3):
                imgs, status = tdp.decode_jpeg_batch(batch, TARGET)
                assert (status == 0).all()
            results[slot] = imgs
        except Exception as e:  # noqa: BLE001 surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    for r in results:
        np.testing.assert_array_equal(r, want)


def test_many_callers_lose_no_row_and_no_count(tdp):
    """More callers than cores, a short switch interval: every row of every
    call decoded (a row the shared index skipped would keep its
    uninitialised bytes or a zero placeholder) and every call counted."""
    import sys

    bufs = [_good_bytes(n) for n in ("denom_1", "denom_2", "upscale_both", "grayscale")] * 3
    want, _ = tdp.decode_jpeg_mem_batch(bufs, 48, threads=1)
    callers, calls = 2 * (os.cpu_count() or 1) + 2, 5
    before, bad, errors = tdp.mem_batches, [], []

    def worker():
        try:
            for _ in range(calls):
                got, status = tdp.decode_jpeg_mem_batch(bufs, 48)
                if not (status == 0).all() or not np.array_equal(got, want):
                    bad.append(status.tolist())
        except Exception as e:  # noqa: BLE001 surfaced below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(callers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not bad, (errors, bad[:3])
    assert tdp.mem_batches - before == callers * calls


@pytest.mark.parametrize("threads", [1, 2, 3])
def test_threads_bounds_one_calls_concurrency(tdp, monkeypatch, threads):
    active, peak, lock, callers = [0], [0], threading.Lock(), set()
    decode = tnative._decode_mem
    gate = threading.Barrier(min(threads, 6), timeout=5)

    def counted(buf, target, out):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
            callers.add(threading.get_ident())
        try:
            try:  # let as many as are allowed be in here at once
                gate.wait()
            except threading.BrokenBarrierError:
                pass
            return decode(buf, target, out)
        finally:
            with lock:
                active[0] -= 1

    monkeypatch.setattr(tnative, "_decode_mem", counted)
    bufs = [_good_bytes("denom_2")] * 6
    _, status = tdp.decode_jpeg_mem_batch(bufs, TARGET, threads=threads)
    assert (status == 0).all()
    assert peak[0] == min(threads, tdp._pool.workers + 1)
    if threads == 1:
        assert callers == {threading.get_ident()}  # the caller alone


# ----------------------------------------------------------- the switches


def test_native_zero_switches_the_data_plane_off(monkeypatch):
    monkeypatch.setattr(tnative, "_CACHED", False)
    monkeypatch.setenv("LINNAEUS_TPU_NATIVE", "0")
    assert tnative.get_dataplane() is None
    src = DirImageSource("/nonexistent", ["a"], 32, native="auto")
    assert not src.supports_batch_read()
    with pytest.raises(RuntimeError, match="NATIVE_DATAPLANE='on'"):
        DirImageSource("/nonexistent", ["a"], 32, native="on").supports_batch_read()


def test_on_without_cv2_raises_by_name(monkeypatch):
    import importlib.util

    find_spec = importlib.util.find_spec
    monkeypatch.setattr(tnative, "_CACHED", False)
    monkeypatch.setattr(tnative.importlib.util, "find_spec",
                        lambda name, *a: None if name == "cv2" else find_spec(name, *a))
    assert tnative.get_dataplane() is None
    with pytest.raises(RuntimeError, match="NATIVE_DATAPLANE='on'.*cv2"):
        DirImageSource("/nonexistent", ["a"], 32, native="on").supports_batch_read()
    assert not DirImageSource("/nonexistent", ["a"], 32, native="auto").supports_batch_read()


def test_off_and_other_extensions_never_take_the_data_plane():
    assert not DirImageSource("/tmp", ["a"], 64, native="off").supports_batch_read()
    assert not DirImageSource("/tmp", ["a"], 64, file_extension=".png").supports_batch_read()
    assert DirImageSource("/tmp", ["a"], 64, file_extension=".JPEG").supports_batch_read()


def test_batch_read_through_the_dataset_within_the_bar_of_the_per_sample_path(jpeg_files):
    """PrefetchingDataset routes a JPEG directory through the data plane's
    batch read; its rows against the per-sample cv2 path within the TPU
    package's decoder bar, the targets exact."""
    d, _ = jpeg_files
    idents = list(GOOD)
    labels = ProcessedLabels()
    labels.img_identifiers = idents
    labels.labels = {"taxa_L10": np.arange(len(idents), dtype=np.int32)}
    labels.aux = np.zeros((len(idents), 2), np.float32)
    labels.group_ids = {}
    native = PrefetchingDataset(labels, DirImageSource(str(d), idents, 48, native="on"),
                                ["taxa_L10"])
    python = PrefetchingDataset(labels, DirImageSource(str(d), idents, 48, native="off"),
                                ["taxa_L10"])
    assert native._can_bulk_read() and not python._can_bulk_read()
    idx = np.array([2, 0, 5, 1, 9])
    a = native.read_batch(idx)
    b = python.read_batch(idx)
    assert a["images"].shape == b["images"].shape == (5, 48, 48, 3)
    assert np.abs(a["images"].astype(np.float32) - b["images"]).mean() < PIL_BAR
    np.testing.assert_array_equal(a["targets"]["taxa_L10"], idx.astype(np.int32))
