"""Spans of the port's work, kept in memory by one recorder.

``span(name)`` brackets a piece of work. Off, the default, it costs one
check and returns a shared no-op context: no range, no event, no clock
read. It is on while a torch profiler records (so a profiled window of the
Trainer, of ``tools/profile_step.py`` or of the benchmark sees every span
with no setting) and inside ``enabled()``. An on span

* opens ``torch.profiler.record_function(name)``: the span lands in the
  profiler's trace, on the clock of the device's operations;
* reads the host clock at both ends;
* where CUDA is in use, records a timed CUDA event at both ends on the
  current stream. The span's device time is the stream's time between them.
  A backward's kernels are launched from autograd's own thread, outside the
  main thread's range in the profiler's tree, but the stream's order puts
  them between the two events.

``span(name, always=True)`` records host time and device events on or off;
it is for work that runs once a process (``setup/...``) and for the
Trainer's iterations, which it always timed. ``summary()`` synchronizes
once and gives, by name, the calls and the host and device milliseconds
(totals and medians a call); ``records()`` gives every record, timed;
``take(name)`` hands over the records of one name and forgets them;
``reset()`` clears the recorder.

``count(name, value)`` keeps a tensor of counts on its device, unread, when
tracing is on (``on()``), and nothing when it is off; a caller that has
work to do to make the value asks ``on()`` first, so that off it launches
nothing. ``counters()`` reads every kept value in one transfer.
"""

from __future__ import annotations

import contextlib
import statistics
import threading
import time
from typing import NamedTuple

import torch

_profiling = torch._C._autograd._profiler_enabled
_by_hand = 0
_records: list[tuple] = []  # (name, parent, start s, end s, (start, end) events or None)
_counts: list[tuple] = []  # (name, host clock s, tensor on its device)
_local = threading.local()
_OFF = contextlib.nullcontext()


class Record(NamedTuple):
    name: str
    parent: str | None
    start: float  # host clock (time.perf_counter), seconds
    end: float
    device_ms: float | None  # None where CUDA was not in use


def _stack() -> list[str]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "parent", "range", "events", "start")

    def __init__(self, name: str, on: bool):
        self.name = name
        self.range = torch.profiler.record_function(name) if on else None
        self.events = None

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        if self.range is not None:
            self.range.__enter__()
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        if self.events is not None:
            self.events[1].record()
        if self.range is not None:
            self.range.__exit__(*exc)
        _stack().pop()
        _records.append((self.name, self.parent, self.start, end, self.events))
        return False


def on() -> bool:
    """Whether tracing is on: a torch profiler records, or inside
    ``enabled()``."""
    return _by_hand > 0 or _profiling()


def span(name: str, always: bool = False):
    """A context that records ``name`` when tracing is on (module
    docstring), or with ``always`` whether on or not."""
    recording = on()
    if not (recording or always):
        return _OFF
    return _Span(name, recording)


def count(name: str, value: torch.Tensor) -> None:
    """Keep ``value`` under ``name`` when tracing is on, as it is (no
    copy to the host, no synchronisation); nothing when off."""
    if on():
        _counts.append((name, time.perf_counter(), value.detach()))


@contextlib.contextmanager
def enabled():
    """Spans on inside the block, with or without a profiler."""
    global _by_hand
    _by_hand += 1
    try:
        yield
    finally:
        _by_hand -= 1


def _finished(rows) -> list[Record]:
    if any(r[4] is not None for r in rows):
        torch.cuda.synchronize()
    return [Record(name, parent, start, end,
                   None if ev is None else ev[0].elapsed_time(ev[1]))
            for name, parent, start, end, ev in rows]


def take(name: str) -> list[Record]:
    """The records of ``name``, in order, removed from the recorder."""
    kept, taken = [], []
    for r in list(_records):
        (taken if r[0] == name else kept).append(r)
    _records[:] = kept
    return _finished(taken)


def records(since: float | None = None) -> list[Record]:
    """Every record that started at or after ``since``, in order, timed
    (one synchronisation), the recorder left as it was."""
    return _finished([r for r in list(_records) if since is None or r[2] >= since])


def counters(since: float | None = None) -> dict[str, torch.Tensor]:
    """By name, the values ``count`` kept at or after ``since``, stacked
    in call order on the host as float64 (calls, *shape); read in one
    transfer."""
    rows = [(name, value) for name, at, value in list(_counts) if since is None or at >= since]
    if not rows:
        return {}
    flat = torch.cat([v.reshape(-1).to(torch.float64) for _, v in rows]).cpu()
    by_name: dict[str, list[torch.Tensor]] = {}
    at = 0
    for name, value in rows:
        n = value.numel()
        by_name.setdefault(name, []).append(flat[at:at + n].view(value.shape))
        at += n
    return {name: torch.stack(values) for name, values in by_name.items()}


def summary(since: float | None = None) -> dict[str, dict]:
    """By span name: ``calls``, ``parent`` (its first call's), ``host_ms``
    (total), ``host_ms_median`` (a call), ``device_ms`` (total) and
    ``device_ms_median`` (a call; both None where CUDA was not in use), of
    the spans that started at or after ``since`` (``time.perf_counter``)."""
    by_name: dict[str, list[Record]] = {}
    for r in records(since):
        by_name.setdefault(r.name, []).append(r)
    out = {}
    for name, rows in by_name.items():
        host = [1000.0 * (r.end - r.start) for r in rows]
        device = [r.device_ms for r in rows if r.device_ms is not None]
        out[name] = {"calls": len(rows), "parent": rows[0].parent, "host_ms": sum(host),
                     "host_ms_median": statistics.median(host),
                     "device_ms": sum(device) if device else None,
                     "device_ms_median": statistics.median(device) if device else None}
    return out


def reset() -> None:
    """Forget every record and every count."""
    _records.clear()
    _counts.clear()
