"""What the port's spans cost on the card, and where a cell's set-up goes.

Builds the benchmark's ``v1_sm.train384`` cell from ``--seed`` through its
own driver (benchmark/drivers/train.py), timing each part of the set-up,
then runs the cell's window in turns with tracing off and on
(``linnaeus_tpu_torch.utils.tracing.enabled()``, no profiler): images a
second, the median host ms of a step on the host clock around each call,
and, on, the recorder's phases by device ms a step against the step's.
Last, three steps under torch.profiler (host and device), summed up as the
Trainer's DEBUG.PROFILE window is (``train/loop.py::profile_window_summary``).

    python3 tools/trace_cost.py --seed 2147483711 --seconds 10 --turns 3 \
        --out build/trace_cost.json

It runs on the CUDA device; one JSON object is the last line of its output.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark import common, run  # noqa: E402
from benchmark.drivers import train as drivers  # noqa: E402
from linnaeus_tpu_torch.utils import tracing  # noqa: E402

PHASES = ("collate", "forward", "loss", "backward", "clip", "update")


def timed(parts: dict, name: str, fn):
    """``fn`` with the host seconds of its calls added to ``parts[name]``."""
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0
    return wrapper


def window(driver, seconds: float) -> dict:
    """The benchmark's window, each step's host ms read around its call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = []
    while time.perf_counter() - t0 < seconds:
        a = time.perf_counter()
        driver.step()
        host.append(1000.0 * (time.perf_counter() - a))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"img_per_s": len(host) * driver.batch / wall, "steps": len(host),
            "step_host_ms": statistics.median(host), "first_step_host_ms": host[0]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("trace_cost")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--turns", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    run.fixed_caches(root)
    bench = common.load_json(root / "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == "v1_sm.train384")
    setup = {"imports_s": time.perf_counter() - START}
    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.init()
    torch.zeros(1, device=device)
    setup["cuda_start_s"] = time.perf_counter() - t0

    parts: dict[str, float] = {}
    drivers.common.make_weights = timed(parts, "weights_s", drivers.common.make_weights)
    drivers.data.train_ring = timed(parts, "ring_s", drivers.data.train_ring)
    drivers.TrainDriver._first_steps = timed(parts, "checked_steps_s",
                                             drivers.TrainDriver._first_steps)
    doc = common.config_file(cell["config"], root / "benchmark")
    traffic = common.traffic_file(cell["traffic"], root / "benchmark")
    t0 = time.perf_counter()
    driver = drivers.TrainDriver(doc, traffic, args.seed, device)
    driver.setup()
    setup["driver_setup_s"] = time.perf_counter() - t0
    setup["setup_s"] = time.perf_counter() - START
    spans = tracing.summary()
    setup.update(parts)
    for name in ("setup/build_training", "setup/kernels", "setup/kernels/build"):
        if name in spans:
            setup[name] = spans[name]["host_ms"] / 1000.0

    turns = []
    for i in range(args.turns):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            tracing.reset()
            if on:
                with tracing.enabled():
                    row = window(driver, args.seconds)
                s = tracing.summary()
                row["recorder_step_host_ms"] = s["train_step"]["host_ms_median"]
                n = s["train_step"]["calls"]
                row["device_ms_per_step"] = {name: v["device_ms"] / n for name, v in s.items()}
                phases = sum(s[f"train_step/{ph}"]["device_ms"] for ph in PHASES) / n
                row["phases_over_step"] = phases / row["device_ms_per_step"]["train_step"]
            else:
                row = window(driver, args.seconds)
            row["tracing"] = "on" if on else "off"
            turns.append(row)
            print(json.dumps(row), flush=True)

    from torch.profiler import ProfilerActivity, profile

    from linnaeus_tpu_torch.train.loop import profile_window_summary
    from linnaeus_tpu_torch.utils.device import profile_events

    tracing.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            driver.step()
        torch.cuda.synchronize()
    wall_ms = 1000.0 * (time.perf_counter() - t0) / 3
    window_summary = profile_window_summary(profile_events(prof), tracing.summary(since=t0),
                                            3, wall_ms)
    result = {"card": torch.cuda.get_device_name(device), "seed": args.seed, "setup": setup,
              "turns": turns, "profiled_window": window_summary}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
