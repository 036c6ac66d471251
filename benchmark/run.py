"""One run of one cell of the benchmark, driven by data.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's entry in ``BENCHMARK.json`` names
its configuration (``benchmark/configs/<config>.json``) and its traffic mix
(``benchmark/traffic/<traffic>.json``); the mix's ``kind`` names the general
driver that reads it (``benchmark/drivers/<kind>.py``); with ``--trace 1``
each per-layer metric the cell lists is read by ``benchmark/metrics/<name>.py``.
A new configuration, mix or metric is new files and new entries only.

The run builds the program on the card from the seed, warms up the cell's
shapes (set-up), measures for ``--seconds`` (``--trace 0``: the cell's
end-to-end metrics; ``--trace 1``: the same window, then a short window
under the profiler, and the cell's per-layer metrics), reads the peak
memory, frees the program's state and checks what the window produced
against the plain reference. It prints each compared number beside its
limit as the last lines of standard error and, as the last line of standard
output, one JSON object. Without a card, or with fewer than the cell asks
for, or with JAX or the JAX package loaded once the window has closed, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from benchmark import common  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "linnaeus_tpu")


def fixed_caches(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def banned_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


def applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads`` list,
    else every cell (an end-to-end metric) or every cell that reports the
    end-to-end metric it moves (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool, device,
             root: Path = common.ROOT, adjust=None) -> dict:
    """The result of one run of ``cell_name`` on ``device``. On a CPU
    device (the tests) the run is driven whole, correctness check included,
    but no metric is reported: a CPU's times are not the card's."""
    import torch

    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    doc = common.config_file(cell["config"], root)
    traffic = common.traffic_file(cell["traffic"], root)
    if adjust is not None:
        adjust(doc, traffic)
    driver_module = importlib.import_module(f"benchmark.drivers.{traffic['kind']}")
    driver = driver_module.DRIVER(doc, traffic, seed, device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    driver.setup()
    setup_s = time.perf_counter() - START
    e2e = driver.window(seconds)
    reported = {m["name"] for m in bench["end_to_end"] if applies(m, cell_name, set())}
    metrics: dict = {}
    breakdown = None
    dev: dict = {"platform": "gpu" if on_card else "cpu", "count": int(cell["chips"])}
    if trace:
        if not on_card:
            raise RuntimeError("a traced run reads the card's trace; there is no card")
        ctx = driver.traced()
        for m in bench["per_layer"]:
            if not applies(m, cell_name, reported):
                continue
            read = common.metric_reader(m["name"], root)
            value = None if read is None else read(ctx)
            if value is None:
                continue
            if m["unit"] == "%" and not value >= 0.0:
                raise RuntimeError(f"{m['name']} read {value!r}%: a share is never below 0")
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        dev["busy_s"] = ctx["trace"].busy_s()
        dev["window_s"] = ctx["trace"].window_s()
        breakdown = {"device_ops": ctx["trace"].top_ops(),
                     "idle_gaps": ctx.get("host_trace", ctx["trace"]).idle_gaps()}
    else:
        values = dict(e2e, setup_s=setup_s)
        for m in bench["end_to_end"]:
            if m["name"] in reported:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    if on_card:
        dev["kind"] = torch.cuda.get_device_name(device)
        dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    driver.release()
    correct, checks = driver.check(traffic["limits"])
    attempted, failed = driver.counts()
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics if on_card else {}, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser("benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd()
    bench = common.load_json(root / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    fixed_caches(root)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"cell {args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.init()
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), device)
    found = banned_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)} (the JAX package or JAX)",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
