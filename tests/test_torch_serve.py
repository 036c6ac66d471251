"""HTTP serving of the port: tools/serve.py against tests/test_serve.py.

Every test of tests/test_serve.py has its counterpart here, on the port's
``make_server`` / ``MicroBatcher`` over the port's handler, loaded with
``load_from_artifacts`` from the tiny bundle of tests/bundle_utils.py
(copied with ``inference_options.device: cpu``): batching, the
``max_batch`` cap, worker survival, poisoned and corrupt-image triage,
pipelined dispatch and its depth bound, a failed fetch falling back to the
synchronous path, the error paths and the request deadline. The sleeps are
the JAX tests' own. Each test has a time limit of its own (SIGALRM), and
every HTTP call a socket timeout. Beyond the mirror: answers over HTTP
equal ``handler.predict`` on the same bytes, a burst of 64 connections is
not refused by the listen backlog, ``main`` loads and warms the bundle
before it serves, and the latency bench runs one small setting.
"""

import base64
import functools
import io
import json
import shutil
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import yaml

from linnaeus_tpu_torch.configuration import archs as tarchs
from linnaeus_tpu_torch.inference.handler import LinnaeusInferenceHandler
from linnaeus_tpu_torch.tools import serve, serve_latency_bench
from linnaeus_tpu_torch.tools.serve import DeadlineExceededError, MicroBatcher, make_server

TINY = {
    "CONVNEXT": {"DEPTHS": [1, 1, 1, 1], "DIMS": [8, 16, 32, 64]},
    "ROPE": {"DEPTHS": [1, 1], "DIMS": [32, 64], "NUM_HEADS": [2, 2]},
    "DROP_PATH_RATE": 0.0,
}
HTTP_TIMEOUT = 60


def time_limit(seconds: int):
    """Fail the test with TimeoutError once it has run ``seconds``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            def expire(signum, frame):
                raise TimeoutError(f"{fn.__name__} ran past its {seconds} s limit")

            previous = signal.signal(signal.SIGALRM, expire)
            signal.alarm(seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, previous)
        return run
    return wrap


@pytest.fixture(scope="module")
def bundle_config(tmp_path_factory):
    from tests.bundle_utils import make_test_bundle

    src = make_test_bundle(tmp_path_factory.mktemp("serve_bundle_src"))
    dst = tmp_path_factory.mktemp("serve_bundle") / "b"
    shutil.copytree(src, dst)
    raw = yaml.safe_load((dst / "config.yaml").read_text())
    raw["inference_options"]["device"] = "cpu"
    (dst / "config.yaml").write_text(yaml.safe_dump(raw))
    return dst / "config.yaml"


@pytest.fixture(scope="module")
def inference_handler(bundle_config):
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tarchs.MFORMER_V1_ARCHS, "tiny_v1", TINY)
        return LinnaeusInferenceHandler.load_from_artifacts(bundle_config)


@pytest.fixture(scope="module")
def server_port(inference_handler):
    server = make_server(inference_handler, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield server.server_address[1]
    server.shutdown()
    server.server_close()
    server.batcher.stop()


def _req(port, path, payload=None):
    r = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode() if payload is not None else None,
        headers={"Content-Type": "application/json"},
        method="POST" if payload is not None else "GET",
    )
    try:
        with urllib.request.urlopen(r, timeout=HTTP_TIMEOUT) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _image_b64(seed=0, fmt="PNG"):
    from PIL import Image

    img = np.random.default_rng(seed).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, fmt)
    return base64.b64encode(buf.getvalue()).decode()


@time_limit(60)
def test_healthz_and_info(server_port):
    assert _req(server_port, "/healthz") == (200, {"status": "ok"})
    st, info = _req(server_port, "/info")
    assert st == 200
    assert info["architecture_name"] == "tiny_v1"
    assert info["task_keys"] == ["taxa_L10", "taxa_L20"]


@time_limit(60)
def test_predict_roundtrip(server_port):
    b64 = _image_b64()
    st, out = _req(server_port, "/predict", {
        "instances": [
            {"image": b64, "metadata": {"lat": 40.0, "lon": -105.0}, "top_k": 2},
            {"image": b64},
        ]
    })
    assert st == 200
    assert len(out["predictions"]) == 2
    tasks = out["predictions"][0]["tasks"]
    assert {t["task_key"] for t in tasks} == {"taxa_L10", "taxa_L20"}
    for t in tasks:
        for taxon_id, prob in t["predictions"]:
            assert 0.0 <= prob <= 1.0


@time_limit(60)
def test_http_answers_equal_the_handlers(server_port, inference_handler):
    """The same bytes through HTTP and through ``handler.predict``: the same
    batch bucket here, so the same numbers."""
    images = [_image_b64(seed, fmt) for seed, fmt in ((1, "PNG"), (2, "JPEG"))]
    metas = [{"lat": 10.0, "lon": 20.0, "datetime": "2024-03-01T08:00:00"}, None]
    st, out = _req(server_port, "/predict", {"instances": [
        {"image": b, "metadata": m} for b, m in zip(images, metas)]})
    assert st == 200
    direct = inference_handler.predict([base64.b64decode(b) for b in images], metas)
    for got, want in zip(out["predictions"], direct):
        assert got["taxonomy_context"] == want.taxonomy_context
        for gt, wt in zip(got["tasks"], want.tasks):
            assert gt["task_key"] == wt.task_key
            assert [i for i, _ in gt["predictions"]] == [i for i, _ in wt.predictions]
            np.testing.assert_allclose([p for _, p in gt["predictions"]],
                                       [p for _, p in wt.predictions], atol=1e-6)


class _CountingHandler:
    """Proxy that records every forward's image count (and fails on a
    marker); intercepts predict and predict_async alike."""

    def __init__(self, handler, poison_key=None):
        self._h = handler
        self._poison = poison_key
        self.call_sizes = []

    def __getattr__(self, name):
        return getattr(self._h, name)

    def _check_poison(self, metas):
        if self._poison and any(isinstance(m, dict) and self._poison in m for m in (metas or [])):
            raise ValueError("poisoned instance")

    def predict(self, images, metas=None, options=None):
        self.call_sizes.append(len(images))
        self._check_poison(metas)
        return self._h.predict(images, metas, options)

    def predict_async(self, images, metas=None, options=None):
        self._check_poison(metas)
        finisher = self._h.predict_async(images, metas, options)
        # only dispatched forwards count (a dispatch-side failure falls back
        # to the sync path, which counts itself)
        self.call_sizes.append(len(images))
        return finisher


@pytest.fixture()
def batching_server(inference_handler):
    proxy = _CountingHandler(inference_handler, poison_key="poison")
    # a generous timeout, so concurrently fired clients land in one batch
    server = make_server(proxy, "127.0.0.1", 0, max_batch=16, batch_timeout_ms=2000.0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield server.server_address[1], proxy
    server.shutdown()
    server.server_close()
    server.batcher.stop()


def _fire_concurrent(port, payloads):
    out = [None] * len(payloads)

    def worker(i):
        out[i] = _req(port, "/predict", payloads[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


@time_limit(60)
def test_concurrent_requests_are_batched(batching_server):
    port, proxy = batching_server
    b64 = _image_b64()
    results = _fire_concurrent(port, [{"instances": [{"image": b64}]} for _ in range(6)])
    assert all(st == 200 for st, _ in results)
    assert all(len(out["predictions"]) == 1 for _, out in results)
    assert len(proxy.call_sizes) < 6, proxy.call_sizes
    assert max(proxy.call_sizes) >= 2, proxy.call_sizes


def _fire_concurrent_batcher(batcher, image_lists):
    out = [None] * len(image_lists)

    def worker(i):
        imgs = image_lists[i]
        out[i] = batcher.predict(imgs, [None] * len(imgs), [None] * len(imgs))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(image_lists))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


@time_limit(30)
def test_max_batch_caps_collation():
    class Recorder:
        def __init__(self):
            self.sizes = []

        def predict(self, images, metas=None, options=None):
            self.sizes.append(len(images))
            return ["r"] * len(images)

    rec = Recorder()
    b = MicroBatcher(rec, max_batch=4, timeout_ms=200.0)
    try:
        results = _fire_concurrent_batcher(b, [[f"i{j}{k}" for k in range(3)] for j in range(4)])
        assert all(r == ["r"] * 3 for r in results)
        # 12 images at a cap of 4 in requests of 3: one request a forward
        assert rec.sizes and max(rec.sizes) <= 4, rec.sizes
    finally:
        b.stop()


@time_limit(30)
def test_worker_survives_pathological_handler():
    class Short:
        def predict(self, images, metas=None, options=None):
            return []  # the wrong length

    b = MicroBatcher(Short(), max_batch=8, timeout_ms=1.0)
    try:
        for _ in range(2):  # a second call proves the worker is alive
            with pytest.raises(RuntimeError, match="returned"):
                b.predict(["img"], [None], [None])
    finally:
        b.stop()


@time_limit(60)
def test_poisoned_request_is_isolated(batching_server):
    port, proxy = batching_server
    b64 = _image_b64()
    results = _fire_concurrent(port, [
        {"instances": [{"image": b64}]},
        {"instances": [{"image": b64, "metadata": {"poison": 1}}]},
        {"instances": [{"image": b64}]},
    ])
    assert sorted(st for st, _ in results) == [200, 200, 400], results
    bad = next(out for st, out in results if st == 400)
    assert "poison" in bad["error"]


@time_limit(60)
def test_corrupt_image_in_shared_batch_is_triaged_host_side(batching_server):
    port, proxy = batching_server
    b64 = _image_b64()
    corrupt = base64.b64encode(b"\x89PNGnot really an image").decode()
    before = len(proxy.call_sizes)
    results = _fire_concurrent(port, [
        {"instances": [{"image": b64}]},
        {"instances": [{"image": corrupt}]},
        {"instances": [{"image": b64}]},
    ])
    assert sorted(st for st, _ in results) == [200, 200, 400], results
    # the shared batch and ONE re-run of the survivors, never a forward each
    assert len(proxy.call_sizes) - before <= 2, proxy.call_sizes


@time_limit(30)
def test_pipelined_dispatch_overlaps_fetch():
    events = []
    lock = threading.Lock()

    class Async:
        def predict(self, images, metas=None, options=None):
            return ["r"] * len(images)

        def predict_async(self, images, metas=None, options=None):
            with lock:
                events.append("dispatch")

            def finish():
                time.sleep(0.15)  # the device "executing"
                with lock:
                    events.append("finish")
                return ["r"] * len(images)

            return finish

    b = MicroBatcher(Async(), max_batch=1, timeout_ms=1.0, pipeline_depth=2)
    try:
        results = _fire_concurrent_batcher(b, [["a"], ["b"], ["c"], ["d"]])
        assert all(r == ["r"] for r in results)
        first_finish = events.index("finish")
        assert events[:first_finish].count("dispatch") >= 2, events
    finally:
        b.stop()


@time_limit(30)
def test_pipeline_depth_truly_bounds_inflight():
    lock = threading.Lock()
    state = {"inflight": 0, "max_inflight": 0}

    class Async:
        def predict(self, images, metas=None, options=None):
            return ["r"] * len(images)

        def predict_async(self, images, metas=None, options=None):
            with lock:
                state["inflight"] += 1
                state["max_inflight"] = max(state["max_inflight"], state["inflight"])

            def finish():
                time.sleep(0.05)  # the device "executing"
                with lock:
                    state["inflight"] -= 1
                return ["r"] * len(images)

            return finish

    b = MicroBatcher(Async(), max_batch=1, timeout_ms=1.0, pipeline_depth=1)
    try:
        results = _fire_concurrent_batcher(b, [["a"], ["b"], ["c"], ["d"]])
        assert all(r == ["r"] for r in results)
        assert state["max_inflight"] == 1, state
    finally:
        b.stop()


@time_limit(30)
def test_pipelined_fetch_failure_falls_back_to_sync():
    class FlakyFetch:
        def __init__(self):
            self.sync_calls = 0

        def predict(self, images, metas=None, options=None):
            self.sync_calls += 1
            return ["ok"] * len(images)

        def predict_async(self, images, metas=None, options=None):
            def finish():
                raise RuntimeError("transfer aborted")

            return finish

    h = FlakyFetch()
    b = MicroBatcher(h, max_batch=8, timeout_ms=1.0, pipeline_depth=2)
    try:
        assert b.predict(["img"], [None], [None]) == ["ok"]
        assert h.sync_calls == 1
    finally:
        b.stop()


@time_limit(60)
def test_predict_error_paths(server_port):
    st, out = _req(server_port, "/predict", {"instances": []})
    assert st == 400 and "instances" in out["error"]
    st, out = _req(server_port, "/predict", {"instances": [{"metadata": {}}]})
    assert st == 400 and "image" in out["error"]
    st, _ = _req(server_port, "/predict", {"instances": [{"image": "!!bad"}]})
    assert st == 400
    st, _ = _req(server_port, "/nope")
    assert st == 404
    st, _ = _req(server_port, "/nope", {"instances": []})
    assert st == 404


@time_limit(60)
def test_request_deadline_times_out_stalled_device(inference_handler):
    class Stall:
        """Sync-only proxy (pipeline_depth=0) whose first forward stalls
        until the test releases it (or 30 s pass)."""

        def __init__(self, inner):
            self._inner = inner
            self.entered = threading.Event()
            self.release = threading.Event()

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def predict(self, images, metas=None, options=None):
            if not self.entered.is_set():
                self.entered.set()
                self.release.wait(30.0)
            return self._inner.predict(images, metas, options)

    stall = Stall(inference_handler)
    server = make_server(stall, "127.0.0.1", 0, pipeline_depth=0, request_deadline_ms=200.0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    try:
        b64 = _image_b64()
        st, out = _req(port, "/predict", {"instances": [{"image": b64}]})
        # answered by the deadline while the batch is still stalled on the device
        assert st == 504 and "deadline" in out["error"]
        assert stall.entered.is_set() and not stall.release.is_set()
        stall.release.set()  # the stalled batch drains; the next request is served
        st, out = _req(port, "/predict", {"instances": [{"image": b64}]})
        assert st == 200 and len(out["predictions"]) == 1
    finally:
        stall.release.set()
        server.shutdown()
        server.server_close()
        server.batcher.stop()


@time_limit(30)
def test_expired_queued_request_never_dispatches():
    seen = []
    gate = threading.Event()

    class Slow:
        def predict(self, images, metas=None, options=None):
            seen.append(tuple(images))
            gate.wait(3.0)
            return ["r"] * len(images)

    b = MicroBatcher(Slow(), max_batch=1, timeout_ms=1.0, pipeline_depth=0,
                     request_deadline_ms=150.0)
    try:
        errs = []

        def call(img):
            try:
                b.predict([img], [None], [None])
            except DeadlineExceededError as e:
                errs.append((img, e))

        t1 = threading.Thread(target=call, args=("a",))
        t1.start()
        time.sleep(0.05)  # let "a" dispatch and block the worker
        t2 = threading.Thread(target=call, args=("b",))
        t2.start()
        t1.join(2.0)
        t2.join(2.0)
        assert {img for img, _ in errs} == {"a", "b"}  # both timed out
        gate.set()  # the worker, unblocked, must NOT then run "b"
        time.sleep(0.3)
        assert seen == [("a",)]
    finally:
        gate.set()
        b.stop()


@time_limit(60)
def test_a_burst_of_connections_is_not_refused(server_port):
    """64 clients connecting at once: none waits out a TCP SYN
    retransmission (1 s), which socketserver's default listen backlog of 5
    would cause."""
    import socket

    def fetch(times):
        t0 = time.perf_counter()
        with socket.create_connection(("127.0.0.1", server_port), timeout=HTTP_TIMEOUT) as s:
            s.sendall(b"GET /healthz HTTP/1.0\r\n\r\n")
            reply = b""
            while chunk := s.recv(65536):
                reply += chunk
        assert reply.startswith(b"HTTP/1.0 200")
        times.append(time.perf_counter() - t0)

    assert serve._Server.request_queue_size >= 128
    for _ in range(3):
        times = []
        threads = [threading.Thread(target=fetch, args=(times,)) for _ in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(HTTP_TIMEOUT)
        assert len(times) == 64 and max(times) < 0.9, sorted(times)[-5:]


@time_limit(120)
def test_main_loads_and_warms_the_bundle_before_serving(bundle_config, monkeypatch):
    monkeypatch.setitem(tarchs.MFORMER_V1_ARCHS, "tiny_v1", TINY)
    seen = {}
    warm = LinnaeusInferenceHandler.warmup

    def counting_warmup(self):
        seen["warmed"] = warm(self)
        return seen["warmed"]

    class Served:
        def __init__(self, handler, host, port, *args, **kwargs):
            seen.update(handler=handler, host=host, port=port, kwargs=kwargs)
            self.batcher = MicroBatcher(handler, pipeline_depth=0)

        def serve_forever(self):
            seen["served_after_warmup"] = "warmed" in seen

        def server_close(self):
            pass

    monkeypatch.setattr(LinnaeusInferenceHandler, "warmup", counting_warmup)
    monkeypatch.setattr(serve, "make_server", Served)
    serve.main(["--config", str(bundle_config), "--host", "127.0.0.1", "--port", "0",
                "--request-deadline-ms", "250"])
    assert seen["served_after_warmup"] and seen["warmed"] == 3  # buckets 1, 2, 4
    assert seen["handler"].config.model.architecture_name == "tiny_v1"
    assert seen["kwargs"] == {"pipeline_depth": 2, "request_deadline_ms": 250.0}


@time_limit(120)
def test_latency_bench_runs_one_setting(inference_handler):
    body = json.dumps({"instances": [{"image": serve_latency_bench._jpeg_b64(32)}]}).encode()
    row = serve_latency_bench.run_setting(inference_handler, 5.0, 4, clients=2,
                                          requests_per_client=3, warmup=1, body=body)
    assert row["requests"] == 6 and row["errors"] == 0 and row["deadline_504s"] == 0
    assert 0 < row["p50_ms"] <= row["p95_ms"] <= row["p99_ms"]
    assert row["throughput_req_per_s"] > 0 and 1.0 <= row["mean_batch_fill"] <= 2.0
    assert serve_latency_bench.percentile([1.0, 2.0, 3.0, 4.0], 50) == 3.0
