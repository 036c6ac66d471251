"""Where the port runs: on the card unless the caller asks for the CPU."""

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


def profiled_device_rows(prof) -> list[tuple[str, float, int]]:
    """The device rows of a finished ``torch.profiler.profile``: each
    kernel or copy by name, with its total self device milliseconds and its
    count, longest first. User-annotation ranges are left out (the
    optimizer's "Optimizer.step#..." span covers kernels that have rows of
    their own): an annotation's name holds a '#' and no space, where a
    kernel's '#' sits in a lambda of its template arguments
    ("void at::native::elementwise_kernel<...{lambda()#1}...>"), which must
    count. Their sum is the device-busy time of the profiled window."""
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
