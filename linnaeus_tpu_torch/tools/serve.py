"""Dependency-free HTTP serving for LinnaeusInferenceHandler.

Port of linnaeus_tpu/tools/serve.py: the request surface of the upstream
LitServe deployment with the standard library alone (ThreadingHTTPServer).
Concurrent /predict requests are collated by ``MicroBatcher`` into one
padded forward, so concurrent load rides the card's batched throughput
instead of serialised single-request latency.

Endpoints:
  GET  /info     -> ModelInformation JSON
  GET  /healthz  -> {"status": "ok"}
  POST /predict  -> {"instances": [{"image": <base64>, "metadata": {...}?,
                     "top_k": int?}, ...]}
                 -> {"predictions": [HierarchicalClassificationResult...]}

Usage (a bundle: config.yaml, weights, taxonomy.json, class_map.json):
    python -m linnaeus_tpu_torch.tools.serve --config bundle/config.yaml --port 8000
"""

from __future__ import annotations

import argparse
import base64
import collections
import dataclasses
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

logger = logging.getLogger(__name__)


def _decode_image(b64: str) -> bytes:
    """Base64 -> raw image bytes, passed to the handler undecoded: the
    handler's preprocessing decodes them, and undecodable bytes fail inside
    the shared batch, where the MicroBatcher's host-side triage answers 400
    to the offending request only."""
    return base64.b64decode(b64)


class DeadlineExceededError(RuntimeError):
    """A request outlived the server's per-request deadline (HTTP 504)."""


class _Pending:
    __slots__ = ("images", "metas", "options", "done", "results", "error", "expired")

    def __init__(self, images, metas, options):
        self.images = images
        self.metas = metas
        self.options = options
        self.done = threading.Event()
        self.results = None
        self.error = None
        self.expired = False  # the client gave up (deadline); drop if undispatched


class MicroBatcher:
    """Cross-request dynamic batching. A worker thread drains the pending
    queue: after the first request arrives it waits up to ``timeout_ms``
    for more (or until ``max_batch`` images are pending), runs ONE
    handler.predict over the concatenation, and splits the results back per
    request. The worker serialises predict(). A handler-level failure in a
    multi-request batch is isolated by retrying each request on its own.

    ``pipeline_depth`` > 0 with a handler that has ``predict_async``: the
    worker dispatches batch N+1 (preprocess, upload, launches) while batch N
    runs on the device, and a completion thread fetches and distributes the
    results; the depth bounds dispatched-but-unfetched batches (the worker
    takes a permit before dispatching, the completion thread returns it after
    the fetch). ``request_deadline_ms`` > 0 answers a request that waits
    longer with ``DeadlineExceededError``; a request that expires while still
    queued is dropped before dispatch."""

    def __init__(self, handler, max_batch: int = 32, timeout_ms: float = 5.0,
                 pipeline_depth: int = 2, request_deadline_ms: float = 0.0):
        self.handler = handler
        self.max_batch = max(1, int(max_batch))
        self.timeout = max(0.0, float(timeout_ms)) / 1e3
        self.request_deadline = max(0.0, float(request_deadline_ms)) / 1e3
        self._queue: list[_Pending] = []
        self._cv = threading.Condition()
        self._stopped = False
        # images per collated batch, a bounded window
        self.batch_sizes = collections.deque(maxlen=1024)
        self._completion_q = None
        self._completion_thread = None
        self._inflight = None
        if pipeline_depth > 0 and hasattr(handler, "predict_async"):
            self._inflight = threading.Semaphore(max(1, int(pipeline_depth)))
            self._completion_q = queue.Queue()
            self._completion_thread = threading.Thread(
                target=self._completion_loop, name="serve-complete", daemon=True)
            self._completion_thread.start()
        self._worker = threading.Thread(target=self._loop, name="serve-microbatch", daemon=True)
        self._worker.start()

    def predict(self, images, metas, options):
        p = _Pending(images, metas, options)
        with self._cv:
            if self._stopped:
                raise RuntimeError("server is shutting down")
            self._queue.append(p)
            self._cv.notify_all()
        if not p.done.wait(self.request_deadline or None):
            with self._cv:
                # marked under the lock before the removal: a worker between
                # "saw p queued" and "popped p" then skips it
                p.expired = True
                if p in self._queue:  # never dispatched: free to drop
                    self._queue.remove(p)
            raise DeadlineExceededError(
                f"request exceeded the {self.request_deadline * 1e3:.0f} ms server deadline")
        if p.error is not None:
            raise p.error
        return p.results

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._worker.join(timeout=5.0)
        if self._completion_thread is not None:
            self._completion_q.put(None)  # sentinel after the worker drains
            self._completion_thread.join(timeout=30.0)

    # -- worker side ------------------------------------------------------
    def _n_pending_images(self) -> int:
        return sum(len(p.images) for p in self._queue)

    def _take_batch_locked(self) -> list[_Pending]:
        """Pop requests up to the max_batch image cap (always at least one
        request); the rest stays queued for the next round."""
        batch, total = [], 0
        while self._queue:
            if self._queue[0].expired:  # its client already got its 504
                self._queue.pop(0)
                continue
            nxt = len(self._queue[0].images)
            if batch and total + nxt > self.max_batch:
                break
            batch.append(self._queue.pop(0))
            total += nxt
        return batch

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stopped:
                    self._cv.wait()
                if self._stopped and not self._queue:
                    return
                deadline = time.monotonic() + self.timeout
                while self._n_pending_images() < self.max_batch and not self._stopped:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                batch = self._take_batch_locked()
            if not batch:  # everything pending expired while queued
                continue
            # the worker survives anything _run throws (a dead worker would
            # hang every request), and done fires no matter what
            deferred = False
            try:
                deferred = self._run(batch)
            except BaseException as e:  # noqa: BLE001
                for p in batch:
                    if p.error is None and p.results is None:
                        p.error = RuntimeError(f"batch execution failed: {e!r}")
            finally:
                if not deferred:  # deferred batches complete in the completion thread
                    for p in batch:
                        p.done.set()

    def _run_one(self, p: _Pending) -> None:
        try:
            results = self.handler.predict(
                p.images, p.metas, p.options if any(o is not None for o in p.options) else None)
            if len(results) != len(p.images):
                raise RuntimeError(
                    f"handler returned {len(results)} results for {len(p.images)} images")
            p.results = results
        except Exception as e:
            p.error = e

    @staticmethod
    def _concat(batch: list[_Pending]):
        images = [img for p in batch for img in p.images]
        metas = [m for p in batch for m in p.metas]
        options = [o for p in batch for o in p.options]
        return images, metas, options if any(o is not None for o in options) else None

    @staticmethod
    def _split(batch: list[_Pending], results) -> None:
        i = 0
        for p in batch:
            p.results = results[i:i + len(p.images)]
            i += len(p.images)

    def _run(self, batch: list[_Pending]) -> bool:
        """True when the batch went to the completion thread (results and
        done are set there); False when it was handled here."""
        if self._completion_q is None:
            self._run_sync(batch)
            return False
        self.batch_sizes.append(sum(len(p.images) for p in batch))
        images, metas, options = self._concat(batch)
        # blocks while pipeline_depth batches are dispatched: the
        # backpressure that bounds the device's queue
        self._inflight.acquire()
        try:
            finisher = self.handler.predict_async(images, metas, options)
        except Exception:
            # a dispatch-side failure (bad bytes or options): the sync path
            # triages it; the batch was counted above
            self._inflight.release()
            self._run_sync(batch, count=False)
            return False
        self._completion_q.put((batch, finisher, len(images)))
        return True

    def _completion_loop(self) -> None:
        while True:
            item = self._completion_q.get()
            if item is None:
                return
            batch, finisher, n_images = item
            try:
                results = finisher()
                if len(results) != n_images:
                    raise RuntimeError("handler returned a short result list")
                self._split(batch, results)
            except BaseException:  # noqa: BLE001
                # a device- or fetch-side failure: re-run synchronously,
                # which triages offenders and isolates survivors
                try:
                    self._run_sync(batch, count=False)
                except BaseException as e:  # noqa: BLE001
                    for p in batch:
                        if p.error is None and p.results is None:
                            p.error = RuntimeError(f"batch execution failed: {e!r}")
            finally:
                self._inflight.release()
                for p in batch:
                    p.done.set()

    def _run_sync(self, batch: list[_Pending], count: bool = True) -> None:
        if count:
            self.batch_sizes.append(sum(len(p.images) for p in batch))
        if len(batch) == 1:
            return self._run_one(batch[0])
        try:
            results = self.handler.predict(*self._concat(batch))
            if len(results) != sum(len(p.images) for p in batch):
                raise RuntimeError("handler returned a short result list")
        except Exception:
            self._triage(batch)
            return
        self._split(batch, results)

    def _triage(self, batch: list[_Pending]) -> None:
        """Find the offenders of a failed shared batch on the host: run the
        preprocessing alone (no forward) per request. Offenders get their own
        error; the survivors re-run as ONE shared batch. A handler without an
        inference config (a test double) cannot be triaged this way, and each
        request then runs on its own."""
        from linnaeus_tpu_torch.inference.preprocessing import (
            preprocess_image_batch,
            preprocess_metadata_batch,
        )

        config = getattr(self.handler, "config", None)
        if config is None or not hasattr(config, "input_preprocessing"):
            survivors = list(batch)
        else:
            survivors = []
            for p in batch:
                try:
                    preprocess_image_batch(p.images, config)
                    preprocess_metadata_batch(p.metas, len(p.images), config)
                    survivors.append(p)
                except Exception as e:
                    p.error = e
        if len(survivors) == len(batch):
            # not a preprocessing failure: isolate by individual runs
            for p in batch:
                self._run_one(p)
        elif survivors:
            self._run_sync(survivors, count=False)


class _Server(ThreadingHTTPServer):
    # the listen backlog: socketserver's default of 5 refuses the connections
    # of a burst of clients beyond it, and each refused client waits out a TCP
    # SYN retransmission (1 s, then 3 s more), which set the p99 of
    # serve_latency_bench with 16 clients; the kernel caps it at somaxconn
    request_queue_size = 1024


def make_server(handler, host: str = "0.0.0.0", port: int = 8000,
                max_batch: int = 32, batch_timeout_ms: float = 5.0,
                pipeline_depth: int = 2, request_deadline_ms: float = 0.0):
    """A ThreadingHTTPServer around an inference handler, not yet serving
    (call ``serve_forever``). Concurrent /predict requests are batched by
    one MicroBatcher, exposed as ``server.batcher``: call
    ``server.batcher.stop()`` after ``shutdown()``. The batcher's threads
    start only after the socket binds, so a bind failure leaks nothing."""
    from linnaeus_tpu_torch.inference.schemas import InferenceRequestMetadata

    batcher = None  # assigned after the socket binds; read at request time

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, payload) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            logger.debug("serve: " + fmt % args)

        def do_GET(self):
            if self.path == "/healthz":
                return self._json(200, {"status": "ok"})
            if self.path == "/info":
                return self._json(200, dataclasses.asdict(handler.info()))
            return self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                return self._json(404, {"error": f"unknown path {self.path}"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                instances = req.get("instances")
                if not isinstance(instances, list) or not instances:
                    return self._json(
                        400, {"error": "body must carry a non-empty 'instances' list"})
                images, metas, options = [], [], []
                for inst in instances:
                    if "image" not in inst:
                        return self._json(
                            400, {"error": "every instance needs an 'image' (base64)"})
                    images.append(_decode_image(inst["image"]))
                    metas.append(inst.get("metadata"))
                    top_k = inst.get("top_k")
                    options.append(InferenceRequestMetadata(top_k=int(top_k)) if top_k else None)
                try:
                    results = batcher.predict(images, metas, options)
                except DeadlineExceededError as e:
                    return self._json(504, {"error": str(e)})
                return self._json(200, {"predictions": [dataclasses.asdict(r) for r in results]})
            except Exception as e:  # malformed input must not kill the server
                return self._json(400, {"error": str(e)[:500]})

    server = _Server((host, port), Handler)  # binds here
    batcher = MicroBatcher(handler, max_batch, batch_timeout_ms,
                           pipeline_depth=pipeline_depth,
                           request_deadline_ms=request_deadline_ms)
    server.batcher = batcher
    return server


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("linnaeus_tpu_torch serve")
    parser.add_argument("--config", required=True, help="bundle config.yaml")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max-batch", type=int, default=32,
                        help="dynamic-batching cap: most images collated into one "
                             "forward across concurrent requests")
    parser.add_argument("--batch-timeout-ms", type=float, default=5.0,
                        help="how long the batcher waits for more concurrent requests")
    parser.add_argument("--pipeline-depth", type=int, default=2,
                        help="most dispatched-but-unfetched batches on the device "
                             "(0 = synchronous)")
    parser.add_argument("--request-deadline-ms", type=float, default=0.0,
                        help="per-request deadline; a request not answered in time "
                             "gets HTTP 504 (0 = unbounded)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from linnaeus_tpu_torch.inference.handler import LinnaeusInferenceHandler

    handler = LinnaeusInferenceHandler.load_from_artifacts(args.config)
    n = handler.warmup()  # builds the kernels and runs every batch bucket before traffic
    logger.info(f"warmed {n} batch buckets on {handler.device}")
    server = make_server(handler, args.host, args.port, args.max_batch, args.batch_timeout_ms,
                         pipeline_depth=args.pipeline_depth,
                         request_deadline_ms=args.request_deadline_ms)
    logger.info(
        f"Serving {handler.config.model.architecture_name} on {args.host}:{args.port} "
        f"(/predict /info /healthz; dynamic batching <= {args.max_batch} images, "
        f"{args.batch_timeout_ms} ms)")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        server.batcher.stop()


if __name__ == "__main__":
    main()
