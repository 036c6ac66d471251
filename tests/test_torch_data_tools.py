"""The host data plane's wiring and the data tools, each against the TPU
package on the same inputs.

- ``preprocess_image_batch``: an all-JPEG batch through both data planes
  (within 1 u8 a pixel, 0.15 mean; tests/test_torch_native.py holds the
  decoders), a mixed JPEG/PNG batch whole through the per-image path on
  both sides (exactly equal).
- ``DirImageSource`` and the loader's bulk path on one directory, native
  'on' on both sides: the same rows in the same order, the cache, the
  missing-file placeholder and the status-2 retry through ``read``.
- The handler serving JPEG bytes on a tiny model: through the data plane,
  against the JAX handler on the same decoded pixels, and against the same
  handler with LINNAEUS_TPU_NATIVE=0 (PIL).
- The tools: ``dataset_analyzer`` and ``validate_taxonomy_h5`` on ``.h5``
  labels written by the TPU package's helpers (reports and CLI output
  equal), ``analyze_batch_sizes`` with a fake step, ``filter_logs`` and
  ``utils/ibrida`` bit for bit, CLI output included; ``pipeline_benchmark``
  on the CPU with the data plane on and off, its JPEG files and labels bit
  for bit the JAX tool's.
"""

import base64
import contextlib
import io
import json
import os
from types import SimpleNamespace

import h5py
import numpy as np
import pytest
from PIL import Image

import linnaeus_tpu.data.datasets as jds
import linnaeus_tpu.inference.preprocessing as jpre
import linnaeus_tpu_torch.data.datasets as tds
import linnaeus_tpu_torch.inference.preprocessing as tpre
import linnaeus_tpu_torch.native as tnative
from linnaeus_tpu.native import get_dataplane as jax_dataplane
from tests.test_torch_handler import TASKS as HANDLER_TASKS
from tests.test_torch_handler import _pair

BAR_MAX, BAR_MEAN = 1, 0.15  # the data planes against each other, u8


@pytest.fixture(scope="module")
def jax_plane():
    """The TPU package's data plane (dataplane.cpp); the tests that compare
    with it skip where it does not build (no g++ or libjpeg)."""
    dp = jax_dataplane()
    if dp is None:
        pytest.skip("the TPU package's native dataplane does not build here (no g++/libjpeg)")
    return dp


def _within_bar(a, b):
    diff = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    assert diff.max() <= BAR_MAX and diff.mean() <= BAR_MEAN, (diff.max(), diff.mean())


def _photo(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 127 + 60 * np.sin(xx / 13.0)[..., None] + 50 * np.cos(yy / 9.0)[..., None]
    return np.clip(base + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)


def _encode(pixels, fmt="JPEG"):
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, fmt, quality=90)
    return buf.getvalue()


# ------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    from tests.bundle_utils import make_test_bundle

    return make_test_bundle(tmp_path_factory.mktemp("bundle"))


@pytest.fixture(scope="module")
def handlers(bundle):
    return _pair(bundle, check=False)


SIZES = [(32, 32), (70, 50), (130, 140), (300, 260), (64, 128)]


def test_preprocess_batch_of_jpegs_takes_both_data_planes(handlers, jax_plane):
    jax_handler, handler = handlers
    jpegs = [_encode(_photo(h, w, i)) for i, (h, w) in enumerate(SIZES)]
    plane = tnative.get_dataplane()
    before = plane.mem_batches
    got = tpre.preprocess_image_batch(jpegs, handler.config)
    assert plane.mem_batches == before + 1
    want = jpre.preprocess_image_batch(jpegs, jax_handler.config, as_uint8=True)
    assert got.shape == want.shape == (len(SIZES), 32, 32, 3) and got.dtype == np.uint8
    _within_bar(got, want)


def test_a_mixed_batch_goes_whole_through_the_per_image_path(handlers):
    jax_handler, handler = handlers
    images = [_encode(_photo(h, w, i), "PNG" if i % 2 else "JPEG")
              for i, (h, w) in enumerate(SIZES)]
    images.append(_photo(40, 48, 9))  # an array among bytes
    plane = tnative.get_dataplane()
    before = plane.mem_batches
    got = tpre.preprocess_image_batch(images, handler.config)
    assert plane.mem_batches == before
    np.testing.assert_array_equal(
        got, jpre.preprocess_image_batch(images, jax_handler.config, as_uint8=True))
    np.testing.assert_array_equal(
        got, np.stack([tpre.preprocess_image_u8(im, handler.config) for im in images]))


def _same_results(ours, theirs, atol):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert [t.task_key for t in a.tasks] == HANDLER_TASKS
        for ta, tb in zip(a.tasks, b.tasks):
            assert [tid for tid, _ in ta.predictions] == [tid for tid, _ in tb.predictions]
            np.testing.assert_allclose([p for _, p in ta.predictions],
                                       [p for _, p in tb.predictions], atol=atol)


def test_the_handler_serves_jpeg_bytes_through_the_data_plane(handlers, jax_plane, monkeypatch):
    """``predict`` of JPEG bytes decodes them in the data plane, one call a
    chunk, and answers what it answers for the data plane's pixels, as the
    JAX handler does for the same pixels (each within 1 u8 of the JAX data
    plane's); with LINNAEUS_TPU_NATIVE=0 the same handler takes PIL and
    answers what it answers for PIL's pixels, which are within the TPU
    package's decoder bar of the data plane's."""
    jax_handler, handler = handlers
    jpegs = [_encode(_photo(h, w, 10 + i)) for i, (h, w) in enumerate(SIZES)]
    metas = [{"lat": 10.0 * i, "lon": 5.0} for i in range(len(jpegs))]
    plane = tnative.get_dataplane()
    before = plane.mem_batches
    on = handler.predict(jpegs, metas)
    assert plane.mem_batches > before
    pixels, status = plane.decode_jpeg_mem_batch(jpegs, 32)
    assert (status == 0).all()
    _same_results(on, handler.predict(list(pixels), metas), atol=0)
    jax_pixels, _ = jax_plane.decode_jpeg_mem_batch(jpegs, 32)
    _within_bar(pixels, jax_pixels)
    _same_results(on, jax_handler.predict(list(pixels), metas), atol=1e-5)

    monkeypatch.setattr(tnative, "_CACHED", False)
    monkeypatch.setenv("LINNAEUS_TPU_NATIVE", "0")
    off = handler.predict(jpegs, metas)
    assert tnative.get_dataplane() is None
    pil = np.stack([tpre.preprocess_image_u8(np.asarray(Image.open(io.BytesIO(b))), handler.config)
                    for b in jpegs])
    _same_results(off, handler.predict(list(pil), metas), atol=0)
    assert np.abs(pil.astype(np.float32) - pixels).mean() < 3.0


def test_the_http_server_serves_jpeg_requests_through_the_data_plane(handlers):
    """tools/serve.py's batcher collates the requests' JPEG bytes into one
    ``predict_async`` batch, which the data plane decodes."""
    import threading
    import urllib.request

    from linnaeus_tpu_torch.tools.serve import make_server

    _, handler = handlers
    plane = tnative.get_dataplane()
    before = plane.mem_batches
    server = make_server(handler, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    body = {"instances": [{"image": base64.b64encode(_encode(_photo(h, w, i))).decode()}
                          for i, (h, w) in enumerate(SIZES)]}
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/predict",
            data=json.dumps(body).encode(), headers={"Content-Type": "application/json"},
            method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            answer = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.stop()
    assert len(answer["predictions"]) == len(SIZES)
    assert plane.mem_batches > before


# --------------------------------------------- the directory and the loader


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("dir_images")
    idents = []
    for i, (h, w) in enumerate(SIZES * 2):
        ident = f"obs{i:03d}"
        Image.fromarray(_photo(h, w, 20 + i)).save(d / f"{ident}.jpg", quality=90)
        idents.append(ident)
    Image.fromarray(_photo(50, 50, 40)).save(d / "png_inside.jpg", "PNG")
    Image.fromarray(_photo(50, 50, 41)).convert("CMYK").save(d / "cmyk.jpg", "JPEG")
    return str(d), idents + ["png_inside", "cmyk", "not_there"]


def _labels(mod, idents):
    from linnaeus_tpu.data.processor import ProcessedLabels as JLabels
    from linnaeus_tpu_torch.data.processor import ProcessedLabels as TLabels

    labels = (JLabels if mod is jds else TLabels)()
    labels.img_identifiers = idents
    labels.labels = {"taxa_L10": np.arange(len(idents), dtype=np.int32)}
    labels.aux = np.arange(2 * len(idents), dtype=np.float32).reshape(-1, 2)
    labels.group_ids = {}
    return labels


def test_dir_source_batch_rows_match_jax(image_dir, jax_plane):
    """read_batch_rows on both sides: the rows within the bar, the missing
    placeholder (ALLOW_MISSING), the PNG and CMYK rows retried through
    ``read`` (exactly equal there: the same cv2 per-sample path), and a
    missing file without ALLOW_MISSING raising on both."""
    d, idents = image_dir
    idx = np.array([3, len(idents) - 3, 0, len(idents) - 1, len(idents) - 2, 7])
    rows = {}
    for mod in (jds, tds):
        src = mod.DirImageSource(d, idents, 48, allow_missing=True, native="on")
        assert src.supports_batch_read()
        rows[mod] = src.read_batch_rows(idx)
        for pos in (1, 4):  # png_inside, cmyk: status 2, retried per sample
            np.testing.assert_array_equal(rows[mod][pos], src.read(int(idx[pos])))
            assert rows[mod][pos].max() > 0
        assert rows[mod][3].max() == 0  # not_there
        strict = mod.DirImageSource(d, idents, 48, native="on")
        with pytest.raises(FileNotFoundError):
            strict.read_batch_rows(np.array([len(idents) - 1]))
    _within_bar(rows[tds], rows[jds])
    np.testing.assert_array_equal(rows[tds][[1, 3, 4]], rows[jds][[1, 3, 4]])


def test_the_loaders_bulk_path_matches_jax(image_dir, jax_plane):
    """PrefetchingDataset.read_batch through the bulk path on both sides,
    a cache in front (the second read from it), rows in the requested order,
    a duplicate index, the cache's statistics equal."""
    d, idents = image_dir
    indices = np.array([5, 3, 9, 1, 3, 0])
    out = {}
    for mod in (jds, tds):
        ds = mod.PrefetchingDataset(
            _labels(mod, idents), mod.DirImageSource(d, idents, 40, native="auto"),
            ["taxa_L10"], mem_cache_bytes=1 << 20)
        assert ds._can_bulk_read()
        out[mod] = [ds.read_batch(indices), ds.read_batch(indices[::-1]), ds.cache.stats()]
    for got, want in zip(out[tds][:2], out[jds][:2]):
        _within_bar(got["images"], want["images"])
        np.testing.assert_array_equal(got["targets"]["taxa_L10"], want["targets"]["taxa_L10"])
        np.testing.assert_array_equal(got["aux"], want["aux"])
    np.testing.assert_array_equal(out[tds][1]["images"], out[tds][0]["images"][::-1])
    assert out[tds][2] == out[jds][2]


def test_bulk_reads_retry_a_transient_oserror(image_dir, monkeypatch):
    """An OSError from the batch call is retried as the per-sample path
    retries it (PrefetchingDataset.READ_RETRIES)."""
    d, idents = image_dir
    ds = tds.PrefetchingDataset(_labels(tds, idents),
                                tds.DirImageSource(d, idents, 40, native="on"), ["taxa_L10"])
    plane = tnative.get_dataplane()
    real, calls = plane.decode_jpeg_batch, []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise OSError("1 image files exist but could not be opened")
        return real(*args, **kwargs)

    monkeypatch.setattr(plane, "decode_jpeg_batch", flaky)
    batch = ds.read_batch(np.array([0, 1]))
    assert len(calls) == 2 and batch["images"].shape == (2, 40, 40, 3)


# ------------------------------------------------------------- the tools


@pytest.fixture(scope="module")
def labels_files(tmp_path_factory):
    """Two labels files from the TPU package's helpers: the pipeline
    benchmark's generator (random, many-parent ranks) and one with a
    consistent two-rank hierarchy, nulls and a metadata source."""
    from linnaeus_tpu.tools.pipeline_benchmark import generate_real_dataset

    d = tmp_path_factory.mktemp("labels")
    random_labels, _ = generate_real_dataset(str(d / "gen"), 64, 4)
    rng = np.random.default_rng(3)
    species = rng.integers(0, 9, 80)
    genus = np.where(species == 0, 0, (species + 2) // 3 + 100)
    genus[rng.choice(80, 5, replace=False)] = 0
    consistent = str(d / "consistent.h5")
    with h5py.File(consistent, "w") as f:
        f.create_dataset("img_identifiers", data=np.array([f"o{i}" for i in range(80)], "S8"))
        f.create_dataset("taxa_L10", data=species)
        f.create_dataset("taxa_L20", data=genus)
        f.create_dataset("temporal", data=rng.normal(size=(80, 2)).astype("f4"))
        f.create_dataset("spatial", data=np.zeros((80, 3), "f4"))
    return [random_labels, consistent]


def _stdout_of(main, argv):
    buf = io.StringIO()
    code = None
    with contextlib.redirect_stdout(buf):
        try:
            main(argv)
        except SystemExit as e:
            code = e.code
    return buf.getvalue(), code


@pytest.mark.parametrize("which", [0, 1])
def test_dataset_analyzer_matches_jax(labels_files, which, tmp_path):
    from linnaeus_tpu.tools import dataset_analyzer as jtool
    from linnaeus_tpu_torch.tools import dataset_analyzer as ttool

    path = labels_files[which]
    keys, meta = ["taxa_L10", "taxa_L20", "taxa_L30"], ["temporal", "spatial", "elevation"]
    assert ttool.analyze_labels_h5(path, keys, meta) == jtool.analyze_labels_h5(path, keys, meta)
    argv = [path, "--task-keys", *keys]
    assert _stdout_of(ttool.main, argv) == _stdout_of(jtool.main, argv)
    outs = [str(tmp_path / "t.json"), str(tmp_path / "j.json")]
    for tool, out in zip((ttool, jtool), outs):
        _stdout_of(tool.main, [*labels_files, "--output", out])
    assert open(outs[0]).read() == open(outs[1]).read()


@pytest.mark.parametrize("which", [0, 1])
def test_validate_taxonomy_matches_jax(labels_files, which):
    from linnaeus_tpu.tools import validate_taxonomy_h5 as jtool
    from linnaeus_tpu_torch.tools import validate_taxonomy_h5 as ttool

    path = labels_files[which]
    for partial in (True, False):
        got = ttool.validate(path, ["taxa_L10", "taxa_L20"], partial)
        assert got == jtool.validate(path, ["taxa_L10", "taxa_L20"], partial)
    argv = [path, "--task-keys", "taxa_L10", "taxa_L20"]
    got, code = _stdout_of(ttool.main, argv)
    assert (got, code) == _stdout_of(jtool.main, argv)
    assert code == (0 if json.loads(got)["valid"] else 1)


def test_the_data_tools_raise_by_name_without_h5py(labels_files, monkeypatch):
    import importlib.util

    from linnaeus_tpu_torch.tools import dataset_analyzer, pipeline_benchmark

    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "h5py" else find_spec(name, *a))
    with pytest.raises(ModuleNotFoundError, match="h5py is not installed"):
        dataset_analyzer.analyze_labels_h5(labels_files[1], ["taxa_L10"])
    with pytest.raises(ModuleNotFoundError, match="h5py is not installed"):
        pipeline_benchmark.generate_real_dataset("unused", 4, 4)


def test_analyze_batch_sizes_sweeps_as_jax_with_a_fake_step():
    from linnaeus_tpu.tools.analyze_batch_sizes import sweep_memory_fractions as jsweep
    from linnaeus_tpu_torch.tools.analyze_batch_sizes import sweep_memory_fractions as tsweep

    total = 16 * 2**30

    def need(bs):  # a fixed cost and a per-image cost
        return 3 * 2**30 + bs * 41 * 2**20

    def compile_step(bs):
        mem = SimpleNamespace(temp_size_in_bytes=need(bs), argument_size_in_bytes=0,
                              output_size_in_bytes=0, generated_code_size_in_bytes=0,
                              alias_size_in_bytes=0)
        return SimpleNamespace(memory_analysis=lambda: mem)

    for kwargs in ({}, {"multiple_of": 8}, {"max_batch": 64}, {"min_batch": 400}):
        want = jsweep(compile_step, hbm_bytes=total, **kwargs)
        got = tsweep(need, total_bytes=total, **kwargs)
        assert got == want and len(got) == 5


def test_analyze_batch_sizes_needs_the_card():
    import torch

    from linnaeus_tpu_torch.tools.analyze_batch_sizes import main

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--img-size", "32"])
        with pytest.raises(NotImplementedError, match="DATA.AUTOBATCH"):
            main(["--img-size", "32", "--device", "cpu"])


def test_analyze_batch_sizes_cli_runs_the_forward(monkeypatch, capsys):
    """The CLI's trial is the real forward of the architecture (its aux
    width included) at each candidate batch; the card's memory and peak
    are faked so that it runs on the CPU at 32 px."""
    from linnaeus_tpu_torch.tools.analyze_batch_sizes import main
    from linnaeus_tpu_torch.train import autobatch

    trials = []

    def peak(run_trial, bs, device):
        run_trial(bs)
        trials.append(bs)
        return 2**28 + bs * 2**26

    monkeypatch.setattr(autobatch, "device_memory_bytes", lambda device: 2**30)
    monkeypatch.setattr(autobatch, "measure_peak_bytes", peak)
    got = main(["--img-size", "32", "--max-batch", "8", "--fractions", "0.5", "0.9",
                "--device", "cpu"])
    assert got == {0.5: 4, 0.9: 8} and 8 in trials
    assert json.loads(capsys.readouterr().out) == {"0.5": 4, "0.9": 8}


LOG = """2024-01-01 00:00:00 - linnaeus (loop.py:10) DEBUG: step detail
2024-01-01 00:00:01 - linnaeus (loop.py:11) INFO: step 1 loss 2.5
2024-01-01 00:00:02 - linnaeus (build.py:40) WARNING: zero val batches
2024-01-01 00:00:03 - linnaeus (loop.py:12) ERROR: nan loss at step 7
a line without a level
2024-01-01 00:00:04 - linnaeus (checkpoint.py:3) CRITICAL: disk full
"""


@pytest.mark.parametrize("argv", [[], ["--level", "DEBUG"], ["--level", "warning"],
                                  ["--pattern", r"loss \d"], ["--component", "loop.py"],
                                  ["--level", "ERROR", "--component", "loop.py"]])
def test_filter_logs_matches_jax_bit_for_bit(tmp_path, argv):
    from linnaeus_tpu.tools import filter_logs as jtool
    from linnaeus_tpu_torch.tools import filter_logs as ttool

    path = tmp_path / "main_p0.log"
    path.write_text(LOG)
    kw = dict(zip(("min_level", "pattern", "component"), (None, None, None)))
    for i in range(0, len(argv), 2):
        kw[{"--level": "min_level", "--pattern": "pattern",
            "--component": "component"}[argv[i]]] = argv[i + 1]
    kw = {k: v for k, v in kw.items() if v is not None}
    lines = LOG.splitlines(keepends=True)
    assert list(ttool.filter_lines(lines, **kw)) == list(jtool.filter_lines(lines, **kw))
    assert ttool.LEVELS == jtool.LEVELS
    got = _stdout_of(ttool.main, [str(path), *argv])
    assert got == _stdout_of(jtool.main, [str(path), *argv]) and got[0]


def test_ibrida_matches_jax_bit_for_bit():
    from linnaeus_tpu.utils import ibrida as jmod
    from linnaeus_tpu_torch.utils import ibrida as tmod

    assert tmod.RANK_NAMES == jmod.RANK_NAMES
    keys = ["taxa_L10", "taxa_L20", "taxa_L33_5", "taxa_L40", "taxa_L57", "taxa_L70", "taxa_L99"]
    t, j = tmod.AncestralLevels(keys), jmod.AncestralLevels(keys)
    assert (t.levels, t.names(), t.finest(), t.coarsest(), repr(t)) == (
        j.levels, j.names(), j.finest(), j.coarsest(), repr(j))
    for level in (10, 25, 33, 335, 70, 5):
        assert tmod.AncestralLevels.task_key_of(level) == jmod.AncestralLevels.task_key_of(level)
        assert tmod.AncestralLevels.rank_name(level) == jmod.AncestralLevels.rank_name(level)


@pytest.mark.parametrize("native", ["on", "off"])
def test_pipeline_benchmark_reads_a_jpeg_directory(tmp_path, native):
    """The benchmark on the CPU: a generated JPEG directory of 3:4 photos
    read with the data plane on (the bulk path) and off (per sample), the
    same samples; the JAX tool's generator layout (labels as HDF5 here)."""
    from linnaeus_tpu_torch.tools.pipeline_benchmark import generate_jpeg_dataset, main

    prefix = str(tmp_path / "pb")
    out = main(["--gen-jpeg", "48", "--stored-size", "64x48", "--img-size", "32",
                "--batch-size", "8", "--native", native, "--device", "cpu",
                "--gen-prefix", prefix])
    assert len(out) == 1
    row = out[0]
    assert row["bulk_read"] == (native == "on") and row["hybrid"] and row["device"] == "cpu"
    assert row["samples"] > 0 and row["samples_per_sec"] > 0 and row["wait_ms_per_batch"] >= 0
    labels, images = generate_jpeg_dataset(prefix, 48, (64, 48))
    assert labels.endswith(".h5") and len(os.listdir(images)) == 48
    assert Image.open(os.path.join(images, "img_000000.jpg")).size == (64, 48)


def test_pipeline_benchmark_writes_the_jax_tools_jpeg_files(tmp_path):
    """``--gen-jpeg`` at a square ``--stored-size`` writes the JAX tool's
    files and labels bit for bit, and keeps a file that is already there
    without drawing its noise, as the JAX tool does."""
    from linnaeus_tpu.tools.pipeline_benchmark import generate_jpeg_dataset as jgen
    from linnaeus_tpu_torch.tools.pipeline_benchmark import generate_jpeg_dataset as tgen

    for kept in (False, True):
        dirs = []
        for name, gen in (("t", tgen), ("j", jgen)):
            prefix = str(tmp_path / f"{name}{int(kept)}")
            if kept:
                os.makedirs(f"{prefix}_jpegs")
                Image.fromarray(_photo(24, 24, 5)).save(f"{prefix}_jpegs/img_000001.jpg")
            labels, images = gen(prefix, 5, 24)
            dirs.append((labels, images))
        (t_labels, t_images), (j_labels, j_images) = dirs
        assert sorted(os.listdir(t_images)) == sorted(os.listdir(j_images))
        for name in os.listdir(j_images):
            with open(os.path.join(t_images, name), "rb") as a, \
                    open(os.path.join(j_images, name), "rb") as b:
                assert a.read() == b.read(), name
        with h5py.File(t_labels, "r") as a, h5py.File(j_labels, "r") as b:
            assert sorted(a) == sorted(b)
            for key in b:
                np.testing.assert_array_equal(a[key][()], b[key][()])
                assert a[key].dtype == b[key].dtype
