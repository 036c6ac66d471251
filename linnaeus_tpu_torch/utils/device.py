"""Where the port runs: on the card unless the caller asks for the CPU; and
what a finished torch.profiler window shows of the device: its rows by
kernel name, its busy time (the union of its operations' intervals) and its
idle gaps by program span."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``None`` and ``"auto"`` mean the CUDA device and raise where there is
    none; anything else (``"cpu"``, ``"cuda:1"``, a ``torch.device``) is
    taken as given. The CPU is never chosen silently: the port's kernels
    and its measurements are for the card."""
    if device is None or device == "auto":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: torch.cuda.is_available() is False, and linnaeus_tpu_torch "
                "runs on the GPU unless the CPU is asked for (pass device=\"cpu\")"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def describe_device() -> tuple[str, str]:
    """``(device, backend)`` for a receipt: the current card's name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them and "cuda", or ("cpu", "cpu") where
    torch sees no card."""
    import subprocess

    if not torch.cuda.is_available():
        return "cpu", "cpu"
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return lines[min(torch.cuda.current_device(), len(lines) - 1)], "cuda"


def profiled_device_rows(prof) -> list[tuple[str, float, int]]:
    """The device rows of a finished ``torch.profiler.profile``: each
    kernel or copy by name, with its total self device milliseconds and its
    count, longest first. User-annotation ranges are left out (the
    optimizer's "Optimizer.step#..." span covers kernels that have rows of
    their own): an annotation's name holds a '#' and no space, where a
    kernel's '#' sits in a lambda of its template arguments
    ("void at::native::elementwise_kernel<...{lambda()#1}...>"), which must
    count. A table by name: kernels that overlap in time each count whole
    here, so the rows' sum is not the busy time (``busy_window``)."""
    rows = []
    for e in prof.key_averages():
        on_device = "cuda" in str(getattr(e, "device_type", "")).lower()
        annotation = getattr(e, "is_user_annotation", False) or (
            "#" in e.key and " " not in e.key)
        if not on_device or annotation:
            continue
        device_us = getattr(e, "self_device_time_total", None)
        if device_us is None:
            device_us = getattr(e, "self_cuda_time_total", 0.0)
        if device_us > 0:
            rows.append((e.key, device_us / 1000.0, e.count))
    rows.sort(key=lambda r: -r[1])
    return rows


def profile_events(prof) -> list:
    """The events of a finished ``torch.profiler.profile``, each with its
    start and duration on the trace's own clock."""
    return list(prof.profiler.kineto_results.events())


def device_intervals(events) -> list[tuple[int, int]]:
    """(start, end) in ns of every operation the device ran (kernels,
    copies, sets), sorted: ranges (user annotations, the optimizer's
    "Optimizer.step#..."), and waits recorded on the device's timeline
    ("... Sync", "Stream Wait Event"), are left out."""
    out = []
    for e in events:
        if "cuda" not in str(e.device_type()).lower():
            continue
        name = e.name()
        if e.is_user_annotation() or ("#" in name and " " not in name):
            continue
        if name.endswith(" Sync") or name == "Stream Wait Event":
            continue
        out.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return sorted(out)


def _gaps(intervals) -> tuple[int, list[tuple[int, int]]]:
    """The union's length of sorted intervals and the gaps between them."""
    busy, gaps, end = 0, [], None
    for s, e in intervals:
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, gaps


def busy_window(events) -> tuple[float, float]:
    """(busy ms, window ms) of a profiled window: the union of the device's
    operations' intervals, each instant counted once however many
    operations overlap it, and the span from the first one's start to the
    last one's end, both on the trace's clock. The idle share is one less
    their ratio."""
    intervals = device_intervals(events)
    if not intervals:
        return 0.0, 0.0
    busy, _ = _gaps(intervals)
    return busy / 1e6, (max(e for _, e in intervals) - intervals[0][0]) / 1e6


def idle_by_span(events, names) -> dict[str, float]:
    """Device-idle ms of the profiled window by program span: each gap
    between the device's operations goes to the innermost host range
    named in ``names`` (utils/tracing.py's spans) that covers the gap's
    middle on the trace's clock, else to "between spans"."""
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
              if "cuda" not in str(e.device_type()).lower() and e.name() in names]
    out: dict[str, float] = {}
    for lo, hi in _gaps(device_intervals(events))[1]:
        mid = (lo + hi) // 2
        covering = [(e - s, name) for s, e, name in ranges if s <= mid <= e]
        name = min(covering)[1] if covering else "between spans"
        out[name] = out.get(name, 0.0) + (hi - lo) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
