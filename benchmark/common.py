"""What every driver of the benchmark shares: the files found by name, seeds,
the weights drawn from a seed, the device's trace read into busy time, and
the per-layer metric readers."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import re
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def subseed(seed: int, tag: str) -> int:
    """A 62-bit seed of its own for each use of the run's ``--seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 2


def config_file(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "configs" / f"{name}.json")


def traffic_file(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "traffic" / f"{name}.json")


def metric_reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<name>.py``, or None without one."""
    path = root / "metrics" / f"{name}.py"
    if not path.is_file():
        return None
    module_name = "benchmark_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def weight_scale(name: str, shape) -> tuple[float, float]:
    """(mean, std) of a parameter's draw: LayerNorm scales about 1, the
    ConvNeXt layer scales and the rotary frequencies at std 0.1, the rest
    as a trunc-normal init of std 0.02 would be."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight" and len(shape) == 1:
        return 1.0, 0.02
    if leaf == "gamma":  # ConvNeXt layer scale: a trained net's residual branches speak
        return 0.0, 0.1
    if leaf == "freqs":
        return 0.0, 0.1
    return 0.0, 0.02


def make_weights(shapes: dict, seed: int, device) -> dict:
    """Every parameter drawn from ``seed`` on ``device`` in one normal draw,
    float32, split by the layout's order and scaled per parameter."""
    total = sum(int(torch.Size(s).numel()) for s in shapes.values())
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = int(torch.Size(shape).numel())
        mean, std = weight_scale(name, shape)
        out[name] = (flat[at:at + n] * std + mean).view(shape)
        at += n
    return out


# ---------------------------------------------------------------------------
# the device's trace


class Trace:
    """A profiled window read from the profiler's events: the device
    operations (kernels, copies, sets) with their times, the host's
    operations and ranges, and which launch each device operation came from.
    Every time is the trace's own, so the busy time and the window it is
    set against come from one clock."""

    def __init__(self, prof):
        self.device: list[tuple[str, int, int]] = []  # name, start, end (ns)
        self.host: list[tuple[str, int, int]] = []
        for e in prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            if "cuda" in str(e.device_type()).lower():
                if e.is_user_annotation() or ("#" in e.name() and " " not in e.name()):
                    continue
                if e.name().endswith(" Sync") or e.name() == "Stream Wait Event":
                    continue  # a wait recorded on the device's timeline, not an operation
                self.device.append((e.name(), start, start + dur))
            else:
                self.host.append((e.name(), start, start + dur))
        # device ms of what each host range (record_function) launched,
        # summed by the profiler over the range's operations and their kernels
        self.ranges: dict[str, float] = {}
        for e in prof.events():
            if getattr(e, "is_user_annotation", False) and "cuda" not in str(e.device_type).lower():
                self.ranges[e.name] = self.ranges.get(e.name, 0.0) + e.device_time_total / 1e3

    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran (the union)."""
        total, end = 0, None
        for _, s, e in sorted(self.device, key=lambda r: r[1]):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e9

    def window_s(self) -> float:
        """Seconds from the first device operation's start to the last one's
        end. The traced steps begin and end with the device idle, so this
        is their window on the trace's clock."""
        if not self.device:
            return 0.0
        return (max(e for _, _, e in self.device) - min(s for _, s, _ in self.device)) / 1e9

    def device_ms(self, pattern: str) -> float:
        """Milliseconds of device operations whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(e - s for name, s, e in self.device if rx.search(name)) / 1e6

    def within_ms(self, range_name: str) -> float | None:
        """Device milliseconds of the operations launched inside the host
        ranges named ``range_name``; None where no such range ran."""
        return self.ranges.get(range_name)

    def top_ops(self, n: int = 10) -> list[list]:
        by_name: dict[str, int] = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0) + (e - s)
        rows = sorted(by_name.items(), key=lambda r: -r[1])[:n]
        return [[name[:160], ns / 1e9] for name, ns in rows]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The longest stretches with no device operation, each named by the
        innermost host operation running in its middle."""
        spans = sorted((s, e) for _, s, e in self.device)
        gaps, end = [], None
        for s, e in spans:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        out = []
        for length, lo, hi in gaps[:n]:
            mid = (lo + hi) // 2
            covering = [(e - s, name) for name, s, e in self.host if s <= mid <= e]
            doing = min(covering)[1][:160] if covering else "host in Python, no torch op"
            out.append([doing, length / 1e9])
        return out
