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
