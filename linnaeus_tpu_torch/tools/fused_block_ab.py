"""A/B of the fused ConvNeXt block kernel (ops/fused_dwconv_mlp.py, K3) at a
chosen geometry; the default is stage 1 of mFormerV1_sm at 384 px,
(64, 96, 96, 96).

Port of linnaeus_tpu/tools/fused_block_ab.py. Three contenders, forward and
train (forward + backward + an SGD-like update of 1e-6):
  * block:  the whole block as one CUDA kernel (K3); its backward recomputes
            the plain chain, as in the TPU package
  * mlp:    the library's depthwise convolution + the K2 kernel, forward and
            backward: the route the model takes
  * plain:  the plain chain of PyTorch operators

Each measurement times ``n`` chained iterations with CUDA events after a
warm-up; in forward mode each block's output (scaled as in the TPU tool, so
a long chain stays finite in bf16) is the next one's input. Pairs run
interleaved in one process, so the contenders share the card's state. One
JSON line per measurement and one with the medians, each with the card's
name and power limit. K3 is this tool's alone: nothing routes a model's
ConvNeXt blocks to it.

It runs on the CUDA device unless the caller passes ``device="cpu"`` (host
clock, for a dry run of the control flow).

    python -m linnaeus_tpu_torch.tools.fused_block_ab --pairs 3
    python -m linnaeus_tpu_torch.tools.fused_block_ab --train --pairs 3
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Callable

import torch
import torch.nn.functional as F

from linnaeus_tpu_torch.ops import fused_dwconv_mlp as fb
from linnaeus_tpu_torch.ops import fused_mlp as fm
from linnaeus_tpu_torch.utils.device import resolve_device

MODES = ("block", "mlp", "plain")
PARAM_ORDER = ("k", "kb", "ls", "lb", "w1", "b1", "w2", "b2", "g")


def block_fn(mode: str) -> Callable[[dict, torch.Tensor], torch.Tensor]:
    """The ConvNeXt block of contender ``mode`` as f(params, x)."""

    def via_block(p, h):
        return fb.fused_convnext_block(h, *(p[n] for n in PARAM_ORDER))

    def via_mlp(p, h):
        y = F.conv2d(h.permute(0, 3, 1, 2), p["k"].to(h.dtype), p["kb"].to(h.dtype),
                     padding=3, groups=h.shape[-1]).permute(0, 2, 3, 1)
        return fm.fused_convnext_mlp(y, h, *(p[n] for n in PARAM_ORDER[2:]))

    def via_plain(p, h):
        return fb.convnext_block_chain(h, *(p[n] for n in PARAM_ORDER), 1e-6, True)

    return {"block": via_block, "mlp": via_mlp, "plain": via_plain}[mode]


def build(mode: str, train: bool, B: int, H: int, W: int, C: int,
          dtype: torch.dtype = torch.bfloat16,
          device: torch.device | str | None = None, seed: int = 0):
    """``(run, params, x)``: seeded parameters in the torch layouts, the
    input, and ``run(n)``, which takes ``n`` chained iterations of contender
    ``mode`` (forward, or forward + backward + update when ``train``) and
    returns the last output (forward) or the summed loss (train)."""
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    randn = lambda *shape: torch.randn(*shape, generator=g, device=device)  # noqa: E731
    x = randn(B, H, W, C).to(dtype)
    params = {
        "k": randn(C, 1, 7, 7) * 0.2,
        "kb": randn(C) * 0.1,
        "ls": randn(C) * 0.1 + 1.0,
        "lb": randn(C) * 0.1,
        "w1": (randn(4 * C, C) * 0.05).to(dtype),
        "b1": randn(4 * C) * 0.1,
        "w2": (randn(C, 4 * C) * 0.05).to(dtype),
        "b2": randn(C) * 0.1,
        "g": torch.full((C,), 0.5, device=device),
    }
    f = block_fn(mode)

    if not train:
        def run(n: int) -> torch.Tensor:
            h = x
            with torch.no_grad():
                for _ in range(n):
                    # renormalise so a chain of blocks stays finite in bf16
                    h = f(params, h) * (1.0 / (1.0 + 1e-6))
            return h

        return run, params, x

    for t in params.values():
        t.requires_grad_()

    def run(n: int) -> torch.Tensor:
        total = torch.zeros((), device=device)
        for _ in range(n):
            loss = f(params, x).float().square().mean()
            grads = torch.autograd.grad(loss, list(params.values()))
            with torch.no_grad():
                for t, dt in zip(params.values(), grads):
                    t -= (1e-6 * dt).to(t.dtype)
            total += loss.detach()
        return total

    return run, params, x


def measure(mode: str, train: bool, B: int, H: int, W: int, C: int, n: int = 10,
            dtype: torch.dtype = torch.bfloat16,
            device: torch.device | str | None = None, seed: int = 0) -> float:
    """ms per iteration (one block) of contender ``mode``: CUDA events around
    ``n`` chained iterations after one warm-up iteration; on the CPU, the
    host clock."""
    device = resolve_device(device)
    run, _, _ = build(mode, train, B, H, W, C, dtype, device, seed)
    value = run(1)
    if not torch.isfinite(value.float()).all():
        raise RuntimeError(f"fused_block_ab: {mode} gave a non-finite result")
    if device.type != "cuda":
        t0 = time.perf_counter()
        run(n)
        return 1000.0 * (time.perf_counter() - t0) / n
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    run(n)
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / n


def card_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu" on
    the CPU."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[device.index or 0]


def run_ab(geometry: str = "64x96x96x96", train: bool = False, pairs: int = 3,
           modes: tuple[str, ...] = MODES, n: int = 10,
           dtype: torch.dtype = torch.bfloat16,
           device: torch.device | str | None = None) -> dict:
    """Interleaved pairs of every contender; prints one JSON line per
    measurement and returns (and prints) the medians."""
    device = resolve_device(device)
    card = card_name(device)
    B, H, W, C = (int(v) for v in geometry.split("x"))
    results: dict[str, list[float]] = {m: [] for m in modes}
    for i in range(pairs):
        for m in modes:
            ms = measure(m, train, B, H, W, C, n, dtype, device)
            results[m].append(ms)
            print(json.dumps({"pair": i, "mode": m, "ms_per_block": ms, "card": card}),
                  flush=True)
    summary = {
        "geometry": geometry, "train": train, "dtype": str(dtype)[6:], "card": card,
        "ms_median": {m: sorted(v)[len(v) // 2] for m, v in results.items()},
        "ms_all": results,
    }
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None) -> None:
    p = argparse.ArgumentParser("fused_block_ab")
    p.add_argument("--geometry", default="64x96x96x96",
                   help="BxHxWxC (default: stage 1 of mFormerV1_sm at 384 px)")
    p.add_argument("--train", action="store_true",
                   help="forward + backward + update instead of forward only")
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--n", type=int, default=10, help="chained iterations per measurement")
    p.add_argument("--modes", default=",".join(MODES))
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    p.add_argument("--device", default=None, help='"cpu" to run without a card')
    args = p.parse_args(argv)
    modes = tuple(args.modes.split(","))
    unknown = set(modes) - set(MODES)
    if unknown:
        p.error(f"unknown modes {sorted(unknown)}; choose from {MODES}")
    run_ab(args.geometry, args.train, args.pairs, modes, args.n,
           getattr(torch, args.dtype), args.device)


if __name__ == "__main__":
    main()
