"""Serving latency under concurrent load: p50/p95/p99 per batch timeout.

Port of linnaeus_tpu/tools/serve_latency_bench.py. The MicroBatcher trades
tail latency for batched throughput; this tool measures it: a local
``make_server`` (real HTTP round trips through ThreadingHTTPServer, real
base64 and JPEG decode, real padded forwards) is driven by N closed-loop
client threads, each sending single-image /predict requests one after
another; per-request wall-clock latency is recorded after a warm-up and
summarised per ``--batch-timeout-ms`` setting: p50/p95/p99 (ms), requests
per second, and the mean collated batch size from the batcher's own window.

Usage (on the card; the bundle's device "auto" is the GPU):
    python -m linnaeus_tpu_torch.tools.serve_latency_bench \\
        --config bundle/config.yaml --clients 16 --requests 30 --timeouts 0 5 20
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request


def _jpeg_b64(size: int) -> str:
    import numpy as np
    from PIL import Image

    img = np.random.default_rng(0).integers(0, 256, (size, size, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=90)
    return base64.b64encode(buf.getvalue()).decode()


class _Deadline504(RuntimeError):
    """The server answered 504: the per-request deadline fired."""


def _fire(port: int, body: bytes) -> None:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=body,
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            if resp.status != 200:
                raise RuntimeError(f"status {resp.status}")
            resp.read()
    except urllib.error.HTTPError as e:
        if e.code == 504:
            e.read()
            raise _Deadline504("deadline") from None
        raise


def percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile of a sorted list."""
    if not sorted_vals:
        return float("nan")
    k = max(0, min(len(sorted_vals) - 1, round(q / 100.0 * (len(sorted_vals) - 1))))
    return sorted_vals[k]


def run_setting(handler, timeout_ms: float, max_batch: int, clients: int,
                requests_per_client: int, warmup: int, body: bytes,
                deadline_ms: float = 0.0) -> dict:
    """One server at one batch-timeout setting under closed-loop load.
    ``deadline_ms`` > 0 turns on the server's per-request deadline; its 504s
    are counted (``deadline_504s``) and left out of the percentiles."""
    from linnaeus_tpu_torch.tools.serve import make_server

    server = make_server(handler, "127.0.0.1", 0, max_batch=max_batch,
                         batch_timeout_ms=timeout_ms, request_deadline_ms=deadline_ms)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        barrier = threading.Barrier(clients)
        lock = threading.Lock()
        latencies: list[float] = []
        errors: list[str] = []
        deadline_hits = [0]
        t_start, t_end = [0.0], [0.0]

        def worker() -> None:
            for _ in range(warmup):
                try:
                    _fire(port, body)
                except Exception:  # noqa: BLE001 a failed warm-up must not
                    pass  # leave the barrier one party short
            if barrier.wait() == 0:
                server.batcher.batch_sizes.clear()
                t_start[0] = time.perf_counter()
            for _ in range(requests_per_client):
                t0 = time.perf_counter()
                try:
                    _fire(port, body)
                except _Deadline504:
                    with lock:
                        deadline_hits[0] += 1
                    continue
                except Exception as e:  # noqa: BLE001 record and go on
                    with lock:
                        errors.append(repr(e)[:200])
                    continue
                with lock:
                    latencies.append((time.perf_counter() - t0) * 1e3)
            if barrier.wait() == 0:
                t_end[0] = time.perf_counter()

        threads = [threading.Thread(target=worker) for _ in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = t_end[0] - t_start[0]
        lat = sorted(latencies)
        sizes = list(server.batcher.batch_sizes)
        return {
            "batch_timeout_ms": timeout_ms,
            "request_deadline_ms": deadline_ms,
            "clients": clients,
            "requests": len(lat),
            "errors": len(errors),
            "deadline_504s": deadline_hits[0],
            "p50_ms": percentile(lat, 50),
            "p95_ms": percentile(lat, 95),
            "p99_ms": percentile(lat, 99),
            "throughput_req_per_s": len(lat) / wall if wall else 0.0,
            "mean_batch_fill": sum(sizes) / len(sizes) if sizes else 0.0,
            "n_batches": len(sizes),
        }
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.stop()


def main(argv=None) -> None:
    p = argparse.ArgumentParser("serve_latency_bench")
    p.add_argument("--config", required=True, help="bundle config.yaml")
    p.add_argument("--timeouts", type=float, nargs="+", default=[0.0, 5.0, 20.0],
                   help="batch-timeout-ms settings to sweep")
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--clients", type=int, default=16)
    p.add_argument("--requests", type=int, default=30, help="measured requests per client")
    p.add_argument("--warmup", type=int, default=4, help="unmeasured requests per client")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--deadline-ms", type=float, default=0.0,
                   help="also run each timeout with the per-request deadline at this value")
    args = p.parse_args(argv)

    from linnaeus_tpu_torch.inference.handler import LinnaeusInferenceHandler

    handler = LinnaeusInferenceHandler.load_from_artifacts(args.config)
    handler.warmup()  # every batch bucket before the clock starts
    body = json.dumps({"instances": [{"image": _jpeg_b64(args.image_size)}]}).encode()
    rows = []
    deadlines = [0.0] + ([args.deadline_ms] if args.deadline_ms > 0 else [])
    for t in args.timeouts:
        for d in deadlines:
            row = run_setting(handler, t, args.max_batch, args.clients, args.requests,
                              args.warmup, body, deadline_ms=d)
            print(json.dumps(row), flush=True)
            rows.append(row)
    print(json.dumps({"sweep": rows}))


if __name__ == "__main__":
    main()
