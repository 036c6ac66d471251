#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (linnaeus_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
nvcc. It builds the CUDA kernels from linnaeus_tpu_torch/csrc/ and holds
each one (K1 forward, fused backward and the split dQ and dK/dV backward
pair; K2 forward and backward; K3, the fused ConvNeXt block) against its
plain PyTorch version at the shapes its path gives it, in float32 and in
bfloat16 (all of K1, K2 and K3's MLP tail then run on the tensor cores, in
float32 on the CUDA cores; K1's and K2's times are medians of three repeats,
with the spread; K2 must give the same bits twice, forward and backward; the
bf16 library chain LN -> linear -> GELU -> linear is timed beside K2 and K3
as a yardstick of several calls). It checks the width rule of the ConvNeXt
block: left to choose, a block runs at the lg and xl presets' widths through
the route the rule names, and told to fuse past the kernels' widths it
raises by name. Then it serves mFormerV1_sm at
384 px in bf16 (seeded random weights) through LinnaeusInferenceHandler with
its default options but for the batch size, so with the
hierarchical-consistency pass on against a seeded taxonomy tree over the
four tasks: three predict requests of 1, 7 and 64 images, with launch
counters proving every forward went through both forward kernels and every
result held to the tree; it compares the whole
forward with the kernels on and off and reports serving throughput. Then it
trains: a few steps of make_train_step through tools/train_bench at the
same width (B = 64, bf16 compute over float32 parameters, AdamW, cosine
schedule, clip 5.0), with launch counters proving every step went through
all four kernels, against the same steps from the same seed with the
kernels off. Then it trains the same model at 512 px, where stage 3 holds
1028 tokens and K1's backward takes the split dQ and dK/dV kernels, and
runs tools/fused_block_ab (K3 against the library convolution + K2 and
against the plain chain, forward and train). It prints one JSON line about
the seven kernels, and as its last line

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failed check raises, so the exit code is non-zero and that line is not
printed. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
IMG = 384
BATCH = 64
TASKS = {"taxa_L10": 1000, "taxa_L20": 400, "taxa_L30": 100, "taxa_L40": 30}
# K1: stage 3 (24x24 + 4 extra tokens, 6 heads) and stage 4 (12x12 + 4, 12 heads)
K1_SHAPES = [(BATCH, 580, 6, 64), (BATCH, 148, 12, 64), (2, 37, 3, 64)]
# at 512 px: stage 3 (32x32 + 4, past 1024: the split backward) and stage 4 (16x16 + 4)
IMG_LARGE = 512
K1_SHAPES_LARGE = [(BATCH, 1028, 6, 64), (BATCH, 260, 12, 64)]
# K3: stage 1 and stage 2 of the 384 px model, and a small odd image
K3_SHAPES = [(BATCH, 96, 96, 96), (BATCH, 48, 48, 192), (2, 9, 11, 96)]
# K2: stage 1 (B*96*96 rows, C=96) and stage 2 (B*48*48 rows, C=192)
K2_SHAPES = [(BATCH * 96 * 96, 96), (BATCH * 48 * 48, 192), (70, 96)]
# the TPU kernel tests' bars against their own plain versions
K1_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
K2_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
K1_STAGE3, K1_STAGE4 = 5, 2  # RoPE blocks of mFormerV1_sm's stages 3 and 4
K1_PER_FORWARD = K1_STAGE3 + K1_STAGE4
K2_PER_FORWARD = 3 + 3  # ConvNeXt blocks of stages 1 and 2
# backward kernels against their plain versions, relative to each gradient's
# largest magnitude: fp32 runs the same math in another summation order (dQ
# through float32 atomics); in bf16 a rounding of P, dS, h1 or da1 that
# falls the other way moves a sum by a bf16 step (2**-8) or two
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
TRAIN_STEPS = 3
# first train step, kernels on vs off, same seed and draws: the loss is a
# float32 mean over 64 samples of logits that differ by bf16 roundings; the
# gradient norm sums 22 blocks of bf16 backward, rounded at other places by
# the two routes
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_NORM_RTOL = 1e-2
# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
# whole-forward bars for kernels on vs off (random-init logits stay below
# ~1 in magnitude): fp32 runs the same math in another summation order;
# bf16 (8-bit mantissa, 2**-8 relative) rounds at other places (p per
# 64-key tile in K1, the GELU input kept in fp32 by K2) through 22 blocks,
# so the bar is about a dozen bf16 steps at |logit| ~1
LOGIT_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms_median(fn, iters: int = 50, repeats: int = 3) -> tuple[float, float]:
    """(median, spread) of ``repeats`` mean device times of ``fn`` over
    ``iters`` calls each, after one warm-up: the timing of K1's kernels and
    of the library call beside them, which take well under a millisecond.
    The spread is the largest repeat minus the smallest."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    times.sort()
    return times[len(times) // 2], times[-1] - times[0]


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after one warm-up."""
    return cuda_ms_median(fn, iters, repeats=1)[0]


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def bound(flops: float, nbytes: float, dtype: torch.dtype) -> dict:
    """The least time the card could take: the larger of the operations over
    its peak rate for ``dtype`` and the bytes (each input read once, each
    output written once) over its memory rate."""
    by_ops = 1e3 * flops / PEAK_FLOPS[dtype]
    by_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    return {"bound_ms": max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes"}


def k1_bound(shape, dtype, kind) -> dict:
    """``kind``: False/"fwd", True/"bwd" (the fused backward), "dq" or "dkv"."""
    B, N, H, D = shape
    elems, size = B * N * H * D, torch.finfo(dtype).bits // 8
    product = 2 * B * H * N * N * D  # one N x N x D matrix product per head
    stats = B * H * N * 4
    if kind in (True, "bwd"):  # S, dP, dV, dQ, dK; reads q k v o dO lse, writes dq dk dv
        return bound(5 * product, 8 * elems * size + stats, dtype)
    if kind == "dq":  # S, dP, dQ; reads q k v dO lse delta, writes dq
        return bound(3 * product, 5 * elems * size + 2 * stats, dtype)
    if kind == "dkv":  # S, dP, dV, dK; reads q k v dO lse delta, writes dk dv
        return bound(4 * product, 6 * elems * size + 2 * stats, dtype)
    return bound(2 * product, 4 * elems * size + stats, dtype)


def k2_bound(shape, dtype, backward: bool) -> dict:
    M, C = shape
    size = torch.finfo(dtype).bits // 8
    weights = 2 * 4 * C * C
    vectors = (4 * C + 4 * C) * 4
    if backward:  # the forward's two products again and four for the gradients;
        # reads y dout and the parameters, writes dy and float32 gradients
        return bound(6 * 2 * M * C * 4 * C,
                     3 * M * C * size + weights * size + vectors + weights * 4 + vectors, dtype)
    return bound(2 * 2 * M * C * 4 * C, 3 * M * C * size + weights * size + vectors, dtype)


def k3_bound(shape, dtype) -> dict:
    """The two products and the 49 taps; x read once, out written once, the
    parameters once."""
    B, H, W, C = shape
    M, size = B * H * W, torch.finfo(dtype).bits // 8
    params = 2 * 4 * C * C * size + (49 * C + 5 * C + 4 * C) * 4
    return bound(2 * 2 * M * C * 4 * C + 2 * 49 * M * C, 2 * M * C * size + params, dtype)


def sdpa_ms(q, k, v, do=None) -> float:
    """Time of the one PyTorch call for K1's function on the same operands,
    forward, or backward through torch.autograd.grad when ``do`` is given:
    the yardstick, used nowhere in the port. Timed as K1's kernels are."""
    import torch.nn.functional as F

    if do is None:
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        return cuda_ms_median(lambda: F.scaled_dot_product_attention(qh, kh, vh))[0]
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qh, kh, vh)
    doh = do.transpose(1, 2)
    return cuda_ms_median(
        lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True))[0]


def mlp_chain_ms(y, residual, ln_w, ln_b, w1, b1, w2, b2, gamma) -> float:
    """Time of K2's function as a chain of PyTorch's own operators in y's
    dtype on the same operands (layer_norm, linear, gelu, linear, scale and
    add: several calls and an (M, 4C) intermediate in device memory): the
    yardstick where no single call exists, used nowhere in the port. Timed
    as K2 is."""
    import torch.nn.functional as F

    dt = y.dtype
    lw, lb, b1c, b2c, g = (t.to(dt) for t in (ln_w, ln_b, b1, b2, gamma))

    def chain():
        h = F.layer_norm(y, (y.shape[-1],), lw, lb, 1e-6)
        h = F.linear(F.gelu(F.linear(h, w1, b1c), approximate="tanh"), w2, b2c)
        return residual + h * g

    return cuda_ms_median(chain, iters=20)[0]


def check_kernels(dev, fa, fm) -> dict:
    """Each kernel against its plain version; returns per-kernel records."""
    from linnaeus_tpu_torch import _kernels

    g = torch.Generator(device=dev).manual_seed(SEED)
    rec = {"K1": {"max_abs_err": 0.0, "other_shapes": []},
           "K2": {"max_abs_err": 0.0, "other_shapes": []}}
    for dt in (torch.float32, torch.bfloat16):
        for B, N, H, D in K1_SHAPES + K1_SHAPES_LARGE:
            # q, k, v as strided views of one qkv projection output
            q, k, v = torch.randn(B, N, 3, H, D, generator=g, device=dev).to(dt).unbind(2)
            out, lse = fa.flash_attention_fwd(q, k, v)
            ref, ref_lse = fa.flash_attention_reference(q, k, v)
            err = max(max_err(out, ref), max_err(lse, ref_lse))
            ms, spread = cuda_ms_median(lambda: fa.flash_attention_fwd(q, k, v))
            plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v))
            print(f"K1 flash_attention_fwd {str(dt)[6:]} (B,N,H,D)={(B, N, H, D)}: "
                  f"max|err| {err:.3e} (tol {K1_TOL[dt]:g}), kernel {ms:.4f} ms "
                  f"(median of 3 x 50 calls, spread {spread:.4f}), plain {plain_ms:.3f} ms",
                  flush=True)
            check(err <= K1_TOL[dt], f"K1 {dt} {(B, N, H, D)} error {err}")
            if dt == torch.bfloat16:
                rec["K1"]["max_abs_err"] = max(rec["K1"]["max_abs_err"], err)
                if B == BATCH:
                    lib_ms = sdpa_ms(q, k, v)
                    print(f"   F.scaled_dot_product_attention on the same operands: "
                          f"{lib_ms:.4f} ms", flush=True)
                    timed = dict(ms=ms, ms_spread=spread, plain_ms=plain_ms, shape=[B, N, H, D],
                                 library_ms=lib_ms, **k1_bound((B, N, H, D), dt, False))
                    if N == 580:
                        rec["K1"].update(timed)
                    else:
                        rec["K1"]["other_shapes"].append(timed)
        for M, C in K2_SHAPES:
            y, x = (torch.randn(M, C, generator=g, device=dev).to(dt) for _ in range(2))
            vec = lambda n, s, m=0.0: m + s * torch.randn(n, generator=g, device=dev)  # noqa: E731
            ln_w, ln_b, b1, b2, gamma = vec(C, 0.1, 1.0), vec(C, 0.1), vec(4 * C, 0.1), vec(C, 0.1), vec(C, 0.1, 0.5)
            w1 = (0.1 * torch.randn(4 * C, C, generator=g, device=dev)).to(dt)
            w2 = (0.1 * torch.randn(C, 4 * C, generator=g, device=dev)).to(dt)
            route = fm.forward_kernel(C, dt)
            reported = _kernels.library().lt_fused_mlp_fwd_route(C, 4 * C, _kernels.DTYPE_CODES[dt])
            check(fm.KERNELS[1 - reported] == route,
                  f"K2 forward route: the library reports {reported}, the rule says {route}")
            check(route == ("wgmma" if dt == torch.bfloat16 else "cuda_cores"),
                  f"K2 forward {dt} C={C} takes {route}")
            iters = 50 if route == "wgmma" else 5
            for residual, approx in ((x, True), (None, True), (x, False)):
                args = (y, residual, ln_w, ln_b, w1, b1, w2, b2, gamma)
                out = fm.fused_convnext_mlp(*args, approximate_gelu=approx)
                again = fm.fused_convnext_mlp(*args, approximate_gelu=approx)
                ref = fm.fused_convnext_mlp_reference(*args, 1e-6, approx)
                err = max_err(out, ref)
                same = torch.equal(out, again)
                del again, ref
                ms, spread = cuda_ms_median(
                    lambda: fm.fused_convnext_mlp(*args, approximate_gelu=approx), iters=iters)
                plain_ms = cuda_ms(lambda: fm.fused_convnext_mlp_reference(*args, 1e-6, approx))
                print(f"K2 fused_convnext_mlp {str(dt)[6:]} (M,C)={(M, C)} "
                      f"residual={residual is not None} gelu={'tanh' if approx else 'erf'} "
                      f"({route}): max|err| {err:.3e} (tol {K2_TOL[dt]:g}), bit-identical over "
                      f"two launches: {same}, kernel {ms:.4f} ms (median of 3 x {iters} calls, "
                      f"spread {spread:.4f}), plain {plain_ms:.3f} ms", flush=True)
                check(torch.isfinite(out).all().item(), f"K2 {dt} {(M, C)} finite")
                check(err <= K2_TOL[dt], f"K2 {dt} {(M, C)} error {err}")
                check(same, f"K2 {dt} {(M, C)} differs between two launches")
                if dt == torch.bfloat16:
                    rec["K2"]["max_abs_err"] = max(rec["K2"]["max_abs_err"], err)
                    if M > 70 and residual is not None and approx:
                        chain_ms = mlp_chain_ms(y, residual, ln_w, ln_b, w1, b1, w2, b2, gamma)
                        print(f"   the bf16 library chain (layer_norm, linear, gelu, linear, "
                              f"scale and add: several calls) on the same operands: "
                              f"{chain_ms:.4f} ms", flush=True)
                        timed = dict(ms=ms, ms_spread=spread, plain_ms=plain_ms, shape=[M, C],
                                     library_ms=None, library_chain_ms=chain_ms,
                                     **k2_bound((M, C), dt, False))
                        if C == 96:
                            rec["K2"].update(timed)
                        else:
                            rec["K2"]["other_shapes"].append(timed)
    return rec


def check_width_rule(dev, fm) -> None:
    """The widths on either side of the kernels' limits. bfloat16 C = 256:
    the forward kernel takes it (on the tensor cores), the backward does
    not. A ConvNeXt block left to choose (``fused_mlp=None``) runs forward
    at 384 and 512 and forward and backward at 256, 384 and 512 through its
    plain modules, and at 192 through both kernels; told to fuse at 288 it
    raises a ValueError that names the width."""
    from linnaeus_tpu_torch.models.blocks.convnext import ConvNeXtBlock

    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    dt = torch.bfloat16
    for C, fwd, bwd in ((192, True, True), (256, True, False), (288, False, False)):
        check((fm.kernel_takes(C, dt, False), fm.kernel_takes(C, dt, True)) == (fwd, bwd),
              f"kernel_takes at C={C}")
    M, C = 4096, 256
    y, x = (torch.randn(M, C, generator=g, device=dev).to(dt) for _ in range(2))
    vec = lambda n, s, m=0.0: m + s * torch.randn(n, generator=g, device=dev)  # noqa: E731
    args = (y, x, vec(C, 0.1, 1.0), vec(C, 0.1),
            (0.1 * torch.randn(4 * C, C, generator=g, device=dev)).to(dt), vec(4 * C, 0.1),
            (0.1 * torch.randn(C, 4 * C, generator=g, device=dev)).to(dt), vec(C, 0.1),
            vec(C, 0.1, 0.5))
    err = max_err(fm.fused_convnext_mlp(*args), fm.fused_convnext_mlp_reference(*args, 1e-6, True))
    print(f"K2 forward at its widest, bfloat16 (M,C)={(M, C)} ({fm.forward_kernel(C, dt)}): "
          f"max|err| {err:.3e} (tol {K2_TOL[dt]:g})", flush=True)
    check(err <= K2_TOL[dt] and fm.forward_kernel(C, dt) == "wgmma", f"K2 at C=256: {err}")
    for dim in (192, 256, 384, 512):
        for train in (False, True):
            block = ConvNeXtBlock(dim, layer_scale_init_value=0.5).to(dev)
            plain = ConvNeXtBlock(dim, layer_scale_init_value=0.5, fused_mlp=False).to(dev)
            plain.load_state_dict(block.state_dict())
            xb = torch.randn(2, 12, 12, dim, generator=g, device=dev).to(dt)
            before = (fm.LAUNCHES, fm.BWD_LAUNCHES)
            with torch.set_grad_enabled(train):
                out, ref = block(xb), plain(xb)
                if train:
                    out.float().square().sum().backward()
            torch.cuda.synchronize()
            took = (fm.LAUNCHES - before[0], fm.BWD_LAUNCHES - before[1])
            want = fm.kernel_takes(dim, dt, needs_grad=train)
            err = max_err(out, ref)
            print(f"ConvNeXtBlock({dim}, fused_mlp=None) bf16 {'forward + backward' if train else 'forward'}: "
                  f"K2 launches {took} ({'kernels' if want else 'plain modules'}), max|diff| to "
                  f"the plain modules {err:.3e}", flush=True)
            check(took == (int(want), int(want and train)), f"block {dim} train={train}: {took}")
            check(torch.isfinite(out).all().item() and err <= 2 * K2_TOL[dt], f"block {dim}: {err}")
            check(not train or all(p.grad is not None and torch.isfinite(p.grad).all().item()
                                   for p in block.parameters()), f"block {dim} gradients")
    forced = ConvNeXtBlock(288, fused_mlp=True).to(dev)
    try:
        with torch.no_grad():
            forced(torch.randn(1, 8, 8, 288, device=dev))
    except ValueError as e:
        print(f"ConvNeXtBlock(288, fused_mlp=True) raises: {e}", flush=True)
        check("C=288" in str(e), f"the error names the width: {e}")
    else:
        check(False, "ConvNeXtBlock(288, fused_mlp=True) did not raise")


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return max_err(a, b) / max(b.float().abs().max().item(), 1e-12)


def check_backward_kernels(dev, fa, fm) -> dict:
    """Each backward kernel against its plain version at the training shapes
    (and a ragged small one); returns per-kernel records."""
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    rec = {"K1": {"max_abs_err": 0.0, "other_shapes": []},
           "K2": {"max_abs_err": 0.0, "other_shapes": []}}
    for dt in (torch.float32, torch.bfloat16):
        for B, N, H, D in K1_SHAPES + K1_SHAPES_LARGE[1:]:
            q, k, v = torch.randn(B, N, 3, H, D, generator=g, device=dev).to(dt).unbind(2)
            do = torch.randn(B, N, H, D, generator=g, device=dev).to(dt)
            o, lse = fa.flash_attention_fwd(q, k, v)
            got = fa._launch_bwd(q, k, v, o, lse, do, D ** -0.5)
            want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
            torch.cuda.synchronize()
            err = max(rel_err(a, b) for a, b in zip(got, want))
            abs_err = max(max_err(a, b) for a, b in zip(got, want))
            ms, spread = cuda_ms_median(
                lambda: fa._launch_bwd(q, k, v, o, lse, do, D ** -0.5))
            plain_ms = cuda_ms(
                lambda: fa.flash_attention_bwd_reference(q, k, v, o, lse, do), iters=5)
            print(f"K1 flash_attention_bwd {str(dt)[6:]} (B,N,H,D)={(B, N, H, D)}: "
                  f"max rel err {err:.3e} (tol {BWD_TOL[dt]:g}), max|err| {abs_err:.3e}, "
                  f"kernel {ms:.4f} ms (median of 3 x 50 calls, spread {spread:.4f}), "
                  f"plain {plain_ms:.3f} ms", flush=True)
            check(all(torch.isfinite(t).all().item() for t in got), f"K1 bwd {dt} finite")
            check(err <= BWD_TOL[dt], f"K1 bwd {dt} {(B, N, H, D)} error {err}")
            if dt == torch.bfloat16:
                rec["K1"]["max_abs_err"] = max(rec["K1"]["max_abs_err"], abs_err)
                if B == BATCH:
                    lib_ms = sdpa_ms(q, k, v, do)
                    print(f"   F.scaled_dot_product_attention on the same operands: backward "
                          f"{lib_ms:.4f} ms", flush=True)
                    timed = dict(ms=ms, ms_spread=spread, plain_ms=plain_ms, shape=[B, N, H, D],
                                 library_ms=lib_ms, **k1_bound((B, N, H, D), dt, True))
                    if N == 580:
                        rec["K1"].update(timed)
                    else:
                        rec["K1"]["other_shapes"].append(timed)
        for M, C in K2_SHAPES:
            y, dout = (torch.randn(M, C, generator=g, device=dev).to(dt) for _ in range(2))
            vec = lambda n, s, m=0.0: m + s * torch.randn(n, generator=g, device=dev)  # noqa: E731
            ln_w, ln_b, b1, b2, gamma = vec(C, 0.1, 1.0), vec(C, 0.1), vec(4 * C, 0.1), vec(C, 0.1), vec(C, 0.1, 0.5)
            w1 = (0.1 * torch.randn(4 * C, C, generator=g, device=dev)).to(dt)
            w2 = (0.1 * torch.randn(C, 4 * C, generator=g, device=dev)).to(dt)
            for approx in (True, False):
                args = (y, dout, ln_w, ln_b, w1, b1, w2, b2, gamma, 1e-6, approx)
                got = fm._launch_bwd(*args)
                again = fm._launch_bwd(*args)
                want = fm.fused_convnext_mlp_bwd_reference(*args)
                torch.cuda.synchronize()
                # both passes sum their slabs in a fixed order: all eight
                # gradients are the same bits from run to run
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                del again
                err = max(rel_err(a, b) for a, b in zip(got, want))
                abs_err = max_err(got[0], want[0])  # dy; the sums over M rows are large
                del want
                iters = 10 if fm.backward_kernel(C, dt) == "wgmma" else 3
                ms, spread = cuda_ms_median(lambda: fm._launch_bwd(*args), iters=iters)
                plain_ms = cuda_ms(lambda: fm.fused_convnext_mlp_bwd_reference(*args), iters=3)
                print(f"K2 fused_convnext_mlp_bwd {str(dt)[6:]} (M,C)={(M, C)} "
                      f"gelu={'tanh' if approx else 'erf'} ({fm.backward_kernel(C, dt)}): "
                      f"max rel err {err:.3e} (tol {BWD_TOL[dt]:g}), max|err dy| {abs_err:.3e}, "
                      f"bit-identical over two launches: {same}, kernel {ms:.3f} ms (median of "
                      f"3 x {iters} calls, spread {spread:.3f}), plain {plain_ms:.3f} ms",
                      flush=True)
                check(all(torch.isfinite(t).all().item() for t in got), f"K2 bwd {dt} finite")
                check(err <= BWD_TOL[dt], f"K2 bwd {dt} {(M, C)} error {err}")
                check(same, f"K2 bwd {dt} {(M, C)} differs between two launches")
                if dt == torch.bfloat16:
                    rec["K2"]["max_abs_err"] = max(rec["K2"]["max_abs_err"], abs_err)
                    if M > 70 and approx:
                        timed = dict(ms=ms, ms_spread=spread, plain_ms=plain_ms, shape=[M, C],
                                     library_ms=None, **k2_bound((M, C), dt, True))
                        if C == 96:
                            rec["K2"].update(timed)
                        else:
                            rec["K2"]["other_shapes"].append(timed)
    return rec


def check_split_backward(dev, fa) -> dict:
    """The split backward's dQ and dK/dV kernels against their plain versions
    at the 512 px stage-3 shape; the split route forced at two shapes the
    fused kernel serves, against its plain versions and against the fused
    kernel; dQ bit-identical over two launches; dK and dV bit-identical to
    the fused kernel's (both come from one key-tile body). Returns
    per-kernel records."""
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    rec = {"dq": {"max_abs_err": 0.0}, "dkv": {"max_abs_err": 0.0}}
    shape = K1_SHAPES_LARGE[0]
    for dt in (torch.float32, torch.bfloat16):
        for B, N, H, D in (shape, K1_SHAPES[0], K1_SHAPES[2]):
            scale = D ** -0.5
            q, k, v = torch.randn(B, N, 3, H, D, generator=g, device=dev).to(dt).unbind(2)
            do = torch.randn(B, N, H, D, generator=g, device=dev).to(dt)
            o, lse = fa.flash_attention_fwd(q, k, v)
            delta = fa._launch_delta(o, do)
            dq = fa._launch_bwd_dq(q, k, v, do, lse, delta, scale)
            dq_again = fa._launch_bwd_dq(q, k, v, do, lse, delta, scale)
            dk, dv = fa._launch_bwd_dkv(q, k, v, do, lse, delta, scale)
            _, fused_dk, fused_dv = fa._launch_bwd(q, k, v, o, lse, do, scale)
            torch.cuda.synchronize()
            same = torch.equal(dq, dq_again)
            # one key-tile body serves the dK/dV kernel and the fused kernel
            same_dkv = torch.equal(dk, fused_dk) and torch.equal(dv, fused_dv)
            del fused_dk, fused_dv
            want_delta = fa.attention_delta(o, do)
            want_dq = fa.flash_attention_bwd_dq_reference(q, k, v, do, lse, want_delta, scale)
            want_dk, want_dv = fa.flash_attention_bwd_dkv_reference(
                q, k, v, do, lse, want_delta, scale)
            errs = {"delta": rel_err(delta, want_delta), "dq": rel_err(dq, want_dq),
                    "dk": rel_err(dk, want_dk), "dv": rel_err(dv, want_dv)}
            abs_dq = max_err(dq, want_dq)
            abs_dkv = max(max_err(dk, want_dk), max_err(dv, want_dv))
            del want_dq, want_dk, want_dv
            print(f"K1 split backward {str(dt)[6:]} (B,N,H,D)={(B, N, H, D)}: max rel err "
                  + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
                  + f" (tol {BWD_TOL[dt]:g}); dQ bit-identical over two launches: {same}; "
                  f"dK and dV bit-identical to the fused kernel's: {same_dkv}", flush=True)
            check(all(torch.isfinite(t).all().item() for t in (dq, dk, dv)),
                  f"K1 split bwd {dt} finite")
            check(max(errs.values()) <= BWD_TOL[dt],
                  f"K1 split bwd {dt} {(B, N, H, D)} errors {errs}")
            check(same, f"dQ of the split route differs between two launches, {dt} N={N}")
            check(same_dkv, f"dK or dV of the dK/dV kernel differ from the fused kernel's, "
                            f"{dt} N={N}")
            if N == 580:
                # the whole split route through autograd, against the fused kernel
                got = fa._launch_bwd_split(q, k, v, o, lse, do, scale)
                fused = fa._launch_bwd(q, k, v, o, lse, do, scale)
                torch.cuda.synchronize()
                err = max(rel_err(a, b) for a, b in zip(got, fused))
                print(f"   split route vs fused kernel at N=580: max rel err {err:.3e}",
                      flush=True)
                check(err <= BWD_TOL[dt], f"split vs fused backward {dt}: {err}")
            if (B, N, H, D) != shape or dt != torch.bfloat16:
                continue
            lib_ms = sdpa_ms(q, k, v, do)
            print(f"   F.scaled_dot_product_attention backward (dq, dk and dv in one call) "
                  f"on the same operands: {lib_ms:.4f} ms", flush=True)
            for key, abs_err, run, plain in (
                ("dq", abs_dq,
                 lambda: fa._launch_bwd_dq(q, k, v, do, lse, delta, scale),
                 lambda: fa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, scale)),
                ("dkv", abs_dkv,
                 lambda: fa._launch_bwd_dkv(q, k, v, do, lse, delta, scale),
                 lambda: fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale)),
            ):
                (ms, spread), plain_ms = cuda_ms_median(run), cuda_ms(plain, iters=3)
                print(f"   {key} kernel {ms:.4f} ms (median of 3 x 50 calls, spread "
                      f"{spread:.4f}), plain {plain_ms:.3f} ms", flush=True)
                rec[key].update(max_abs_err=abs_err, ms=ms, ms_spread=spread, plain_ms=plain_ms,
                                shape=[B, N, H, D], library_ms=lib_ms,
                                **k1_bound((B, N, H, D), dt, key))
            fused_ms, _ = cuda_ms_median(lambda: fa._launch_bwd(q, k, v, o, lse, do, scale))
            split_ms, _ = cuda_ms_median(
                lambda: fa._launch_bwd_split(q, k, v, o, lse, do, scale))
            print(f"   whole backward at this shape: split route {split_ms:.4f} ms (delta, dQ, "
                  f"dK/dV), fused kernel {fused_ms:.4f} ms", flush=True)
            rec["dkv"]["fused_ms_at_this_shape"] = fused_ms
            rec["dkv"]["split_route_ms"] = split_ms
    return rec


def check_block_kernel(dev, fb) -> dict:
    """K3 against its plain version at the two ConvNeXt stages' shapes and a
    small odd one, the residual always on, both GELUs."""
    from linnaeus_tpu_torch import _kernels

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    rec = {"max_abs_err": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        for B, H, W, C in K3_SHAPES:
            randn = lambda *shape: torch.randn(*shape, generator=g, device=dev)  # noqa: E731
            x = randn(B, H, W, C).to(dt)
            args = (0.2 * randn(C, 1, 7, 7), 0.1 * randn(C), 1.0 + 0.1 * randn(C),
                    0.1 * randn(C), (0.1 * randn(4 * C, C)).to(dt), 0.1 * randn(4 * C),
                    (0.1 * randn(C, 4 * C)).to(dt), 0.1 * randn(C), 0.5 + 0.1 * randn(C))
            route = fb.forward_kernel(C, dt)
            reported = _kernels.library().lt_fused_convnext_block_fwd_route(
                C, 4 * C, _kernels.DTYPE_CODES[dt])
            check(fb.fused_mlp.KERNELS[1 - reported] == route,
                  f"K3 tail route: the library reports {reported}, the rule says {route}")
            check(route == ("wgmma" if dt == torch.bfloat16 else "cuda_cores"),
                  f"K3 {dt} C={C} runs its tail on {route}")
            iters = 20 if route == "wgmma" else 5
            for approx in (True, False):
                out = fb.fused_convnext_block(x, *args, approximate_gelu=approx)
                torch.cuda.synchronize()
                ref = fb.fused_convnext_block_reference(x, *args, 1e-6, approx)
                err = max_err(out, ref)
                del ref
                ms, spread = cuda_ms_median(
                    lambda: fb.fused_convnext_block(x, *args, approximate_gelu=approx),
                    iters=iters)
                plain_ms = cuda_ms(
                    lambda: fb.fused_convnext_block_reference(x, *args, 1e-6, approx), iters=2)
                print(f"K3 fused_convnext_block {str(dt)[6:]} (B,H,W,C)={(B, H, W, C)} "
                      f"gelu={'tanh' if approx else 'erf'} (tail on {route}): max|err| {err:.3e} "
                      f"(tol {K2_TOL[dt]:g}), kernel {ms:.4f} ms (median of 3 x {iters} calls, "
                      f"spread {spread:.4f}), plain {plain_ms:.3f} ms", flush=True)
                check(torch.isfinite(out).all().item(), f"K3 {dt} finite")
                check(err <= K2_TOL[dt], f"K3 {dt} {(B, H, W, C)} error {err}")
                if dt == torch.bfloat16:
                    rec["max_abs_err"] = max(rec["max_abs_err"], err)
                    if not (approx and B == BATCH):
                        continue
                    # the block as a chain of PyTorch's own operators in bf16
                    # (conv2d, layer norm by hand, linear, gelu, linear): the
                    # yardstick of several calls, as tools/fused_block_ab times it
                    chain_ms = cuda_ms_median(
                        lambda: fb.convnext_block_chain(x, *args, 1e-6, approx), iters=10)[0]
                    print(f"   the bf16 library chain (several calls) on the same operands: "
                          f"{chain_ms:.4f} ms", flush=True)
                    timed = dict(ms=ms, ms_spread=spread, plain_ms=plain_ms, shape=[B, H, W, C],
                                 library_ms=None, library_chain_ms=chain_ms,
                                 **k3_bound((B, H, W, C), dt))
                    if (B, H, W, C) == K3_SHAPES[0]:
                        rec.update(timed)
                    else:
                        rec.setdefault("other_shapes", []).append(timed)
    return rec


def block_ab_phase(dev, fm, fb) -> int:
    """tools/fused_block_ab at its default geometry, one pair, forward and
    train; returns K3's launch count over the tool's run."""
    from linnaeus_tpu_torch.tools import fused_block_ab as ab

    fb.LAUNCHES = fm.LAUNCHES = fm.BWD_LAUNCHES = 0
    n = 5
    for train in (False, True):
        before = (fb.LAUNCHES, fm.LAUNCHES, fm.BWD_LAUNCHES)
        summary = ab.run_ab(train=train, pairs=1, n=n, device=dev)
        check(set(summary["ms_median"]) == set(ab.MODES), "fused_block_ab ran its three modes")
        check(all(np.isfinite(v) and v > 0 for v in summary["ms_median"].values()),
              f"fused_block_ab times {summary['ms_median']}")
        k3, k2, k2_bwd = (a - b for a, b in zip((fb.LAUNCHES, fm.LAUNCHES, fm.BWD_LAUNCHES),
                                                before))
        # each mode runs one warm-up iteration and n timed ones
        check(k3 == n + 1, f"fused_block_ab block mode launched K3 {k3} times, not {n + 1}")
        check(k2 == n + 1 and k2_bwd == (n + 1 if train else 0),
              f"fused_block_ab mlp mode launched K2 {k2} + {k2_bwd} times")
    launches = fb.LAUNCHES
    B, H, W, C = 64, 96, 96, 96
    outs = {m: ab.build(m, False, B, H, W, C, device=dev)[0](1) for m in ab.MODES}
    torch.cuda.synchronize()
    errs = {m: max_err(outs[m], outs["plain"]) for m in ("block", "mlp")}
    errs["block vs mlp"] = max_err(outs["block"], outs["mlp"])
    tol = K2_TOL[torch.bfloat16]
    print("fused_block_ab, one block forward in bf16, max|diff| " +
          ", ".join(f"{m} {e:.3e}" for m, e in errs.items()) + f" (tol {tol:g})", flush=True)
    check(max(errs.values()) <= tol, f"fused_block_ab modes disagree: {errs}")
    return launches


def train_phase(dev, card, fa, fm, img: int = IMG) -> dict:
    """A few train steps of mFormerV1_sm at ``img`` px with the kernels on,
    then the same steps from the same seed with them off; returns the launch
    counts. K1's backward takes the fused kernel for a stage of at most 1024
    tokens and the split pair past that (stage 3 at 512 px)."""
    from linnaeus_tpu_torch.tools import train_bench

    def counts():
        return {"K1": fa.LAUNCHES, "K1_bwd": fa.BWD_LAUNCHES, "K1_dq": fa.DQ_LAUNCHES,
                "K1_dkv": fa.DKV_LAUNCHES, "K2": fm.LAUNCHES, "K2_bwd": fm.BWD_LAUNCHES}

    split = [fa.backward_route((img // px) ** 2 + 4) == "split" for px in (16, 32)]
    n_split = K1_STAGE3 * split[0] + K1_STAGE4 * split[1]
    results = {}
    for name, kernels in (("on", True), ("off", False)):
        run, state = train_bench.build_step(BATCH, img, kernels, "mFormerV1_sm", TASKS,
                                            device=dev, seed=SEED)
        check(all(p.dtype == torch.float32 for p in state.model.parameters())
              and state.model.dtype == torch.bfloat16, "bf16 compute over float32 parameters")
        before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fa.LAUNCHES = fa.BWD_LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
        fm.LAUNCHES = fm.BWD_LAUNCHES = 0
        first = run()  # also warms up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        history = [first] + [run() for _ in range(TRAIN_STEPS)]
        end.record()
        torch.cuda.synchronize()
        launched = counts()
        ms = start.elapsed_time(end) / TRAIN_STEPS
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        losses = [float(m["loss"]) for m in history]
        pre = [float(m["grad_norm_pre_clip"]) for m in history]
        post = [float(m["grad_norm_post_clip"]) for m in history]
        per_task = {t: float(history[0][f"loss/{t}"]) for t in TASKS}
        # a tensor without weight decay may stand still over a few steps: a
        # bias that a LayerNorm cancels has a zero gradient, and behind the
        # 1e-6 layer scale a LayerNorm weight's gradient is far below AdamW's
        # eps, so its update at the warm-up's rate is lost beside 1.0
        still = [n for n, p in state.model.named_parameters() if torch.equal(before[n], p.detach())]
        stuck = [n for n in still if state.model.get_parameter(n).grad is None
                 or state.model.get_parameter(n).dim() > 1]
        changed = len(before) - len(still)
        print(f"train, kernels {name}: {len(history)} steps, loss "
              + " ".join(f"{v:.4f}" for v in losses) + "; grad norm before clip "
              + " ".join(f"{v:.3f}" for v in pre) + "; after clip "
              + " ".join(f"{v:.3f}" for v in post) + f"; {changed}/{len(before)} parameter "
              f"tensors changed (still: {still}); launches {launched}", flush=True)
        print(f"[{card}] mFormerV1_sm {img}px B={BATCH} bf16 train step, kernels {name}: "
              f"{ms:.2f} ms per step (CUDA events over {TRAIN_STEPS} steps), peak memory "
              f"{peak:.2f} GiB", flush=True)
        check(all(np.isfinite(v) for v in losses + pre + post + list(per_task.values())),
              f"finite losses and gradient norms, kernels {name}")
        check(all(v <= 5.0 + 1e-3 for v in post), "gradient norm after the clip is at most 5.0")
        check(not stuck and changed >= 0.95 * len(before),
              f"{changed} of {len(before)} parameter tensors changed; stuck: {stuck}")
        check(state.step == len(history), f"step counter {state.step}")
        n = len(history)
        want = ({"K1": n * K1_PER_FORWARD, "K1_bwd": n * (K1_PER_FORWARD - n_split),
                 "K1_dq": n * n_split, "K1_dkv": n * n_split,
                 "K2": n * K2_PER_FORWARD, "K2_bwd": n * K2_PER_FORWARD} if kernels
                else dict.fromkeys(launched, 0))
        check(launched == want, f"train launch counts {launched}, expected {want}")
        results[name] = {"loss": losses[0], "grad_norm": pre[0], "launches": launched,
                         "ms": ms, "peak_gib": peak}
        del run, state, before, history, first
        torch.cuda.empty_cache()
    on, off = results["on"], results["off"]
    d_loss = abs(on["loss"] - off["loss"]) / abs(off["loss"])
    d_norm = abs(on["grad_norm"] - off["grad_norm"]) / abs(off["grad_norm"])
    print(f"first train step at {img} px, kernels on vs off: loss {on['loss']:.5f} vs {off['loss']:.5f} "
          f"(rel {d_loss:.2e}, tol {TRAIN_LOSS_RTOL:g}); grad norm {on['grad_norm']:.4f} vs "
          f"{off['grad_norm']:.4f} (rel {d_norm:.2e}, tol {TRAIN_GRAD_NORM_RTOL:g})", flush=True)
    check(d_loss <= TRAIN_LOSS_RTOL, f"first-step loss, kernels on vs off: rel {d_loss}")
    check(d_norm <= TRAIN_GRAD_NORM_RTOL, f"first-step grad norm, kernels on vs off: rel {d_norm}")
    return results


def serving_config():
    """Every inference option at its default (the hierarchical-consistency
    pass on, data_parallel "auto") but for the batch size, which is the
    deployment's."""
    from linnaeus_tpu_torch.inference.config import InferenceConfig

    return InferenceConfig.from_dict({
        "model": {
            "architecture_name": "mFormerV1_sm",
            "weights_path": "random-seeded",
            "model_task_keys_ordered": list(TASKS),
            "num_classes_per_task": list(TASKS.values()),
            "null_class_indices": {t: 0 for t in TASKS},
        },
        "input_preprocessing": {"image_size": [3, IMG, IMG]},
        # TEMPORAL(2) + SPATIAL(3) + ELEVATION(6): 4 extra tokens, N = 580
        "metadata_preprocessing": {"use_temporal": True, "use_geolocation": True,
                                   "use_elevation": True},
        "taxonomy_data": {"taxonomy_tree_path": "-", "class_index_map_path": "-",
                          "source_name": "synthetic"},
        "inference_options": {"batch_size": BATCH},
    })


def serving_taxonomy(cfg):
    """A seeded random taxonomy over the four tasks (fine -> coarse): every
    class but the null class 0 gets a parent among the next coarser rank's
    classes; taxon ids are 100000 * rank + class index. Returns the
    handler's taxonomy data and class maps."""
    from linnaeus_tpu_torch.inference.artifacts import class_index_maps, taxonomy_data
    from linnaeus_tpu_torch.utils.taxonomy import TaxonomyTree

    rng = np.random.default_rng(SEED + 7)
    keys = list(TASKS)
    hierarchy = {child: {c: int(rng.integers(1, TASKS[parent])) for c in range(1, TASKS[child])}
                 for child, parent in zip(keys[:-1], keys[1:])}
    tree = TaxonomyTree(hierarchy, keys, dict(TASKS))
    raw = {t: {str(i): 100000 * int(t.split("_L")[1]) + i for i in range(n)}
           for t, n in TASKS.items()}
    m = cfg.model
    maps = class_index_maps(raw, m.model_task_keys_ordered, m.num_classes_per_task,
                            m.null_class_indices)
    return taxonomy_data(tree, cfg.taxonomy_data.source_name), maps


def requests(n: int, rng: np.random.Generator):
    images = [rng.integers(0, 256, (IMG, IMG, 3), dtype=np.uint8) for _ in range(n)]
    metas = [{"lat": float(rng.uniform(-60, 70)), "lon": float(rng.uniform(-180, 180)),
              "datetime": f"2024-{1 + i % 12:02d}-15T12:00:00",
              "elevation_m": float(rng.uniform(0, 3000))} for i in range(n)]
    return images, metas


def check_results(results, n: int, taxonomy, maps) -> int:
    """Shape and range of every result, and the tree: below the coarsest
    rank a top taxon is null or a child of the coarser rank's top taxon.
    Returns how many task results the consistency pass nulled."""
    check(len(results) == n, f"{len(results)} results for {n} images")
    tree, nulled = taxonomy.taxonomy_tree, 0
    for r in results:
        check([t.task_key for t in r.tasks] == list(TASKS), "task keys")
        check(r.taxonomy_context["source"] == taxonomy.source, "taxonomy context")
        for t in r.tasks:
            probs = [p for _, p in t.predictions]
            was_nulled = t.predictions == [(maps.null_taxon_ids[t.rank_level], 1.0)]
            nulled += was_nulled
            check(was_nulled or len(probs) == min(5, TASKS[t.task_key]),
                  f"top-k length {len(probs)}")
            check(all(np.isfinite(p) and 0.0 <= p <= 1.0 for p in probs), f"probabilities {probs}")
            check(probs == sorted(probs, reverse=True), "probabilities sorted")
        for fine, coarse in zip(r.tasks[:-1], r.tasks[1:]):
            top_f, top_c = fine.predictions[0][0], coarse.predictions[0][0]
            if top_f == maps.null_taxon_ids[fine.rank_level]:
                continue
            check(top_c != maps.null_taxon_ids[coarse.rank_level],
                  f"{fine.task_key} is not null under a null {coarse.task_key}")
            child = (fine.task_key, maps.taxon_id_to_idx[fine.rank_level][top_f])
            parent = (coarse.task_key, maps.taxon_id_to_idx[coarse.rank_level][top_c])
            check(tree.get_parent(child) == parent,
                  f"{child} on top under {parent}, whose child it is not")
    return nulled


def compare_forward(on, off, dt, n: int, dev) -> tuple[float, dict]:
    """Whole forward, kernels on vs off, on the same weights and inputs."""
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn(n, IMG, IMG, 3, generator=g, device=dev)
    aux = torch.randn(n, 11, generator=g, device=dev)
    with torch.inference_mode():
        a, b = on(x, aux), off(x, aux)
    err = max(max_err(a[t], b[t]) for t in TASKS)
    scale = max(b[t].abs().max().item() for t in TASKS)
    top1 = {t: (a[t].argmax(-1) == b[t].argmax(-1)).float().mean().item() for t in TASKS}
    print(f"forward {str(dt)[6:]} B={n}, kernels on vs off: max|dlogit| {err:.3e} "
          f"(tol {LOGIT_TOL[dt]:g}, max|logit| {scale:.3f}), top-1 agreement "
          + ", ".join(f"{t} {v:.4f}" for t, v in top1.items()), flush=True)
    check(all(torch.isfinite(a[t]).all().item() for t in TASKS), "finite logits")
    check(err <= LOGIT_TOL[dt], f"{dt} kernels on vs off: max|dlogit| {err}")
    return err, top1


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from linnaeus_tpu_torch import _kernels
    from linnaeus_tpu_torch.inference.handler import LinnaeusInferenceHandler
    from linnaeus_tpu_torch.inference.model_utils import build_model_for_inference
    from linnaeus_tpu_torch.ops import flash_attention as fa
    from linnaeus_tpu_torch.ops import fused_dwconv_mlp as fb
    from linnaeus_tpu_torch.ops import fused_mlp as fm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # 1. build
    start = time.perf_counter()
    _kernels.library()
    built = _kernels.build_seconds
    print(f"kernel build: {'%.1f s (nvcc)' % built if built is not None else 'reused'}; "
          f"library ready in {time.perf_counter() - start:.1f} s: {_kernels.library_path()}",
          flush=True)

    # 2. each kernel against its plain version at the model's shapes
    rec = check_kernels(dev, fa, fm)
    rec_bwd = check_backward_kernels(dev, fa, fm)
    rec_split = check_split_backward(dev, fa)
    rec_block = check_block_kernel(dev, fb)
    check_width_rule(dev, fm)

    # 3. serve mFormerV1_sm through the handler with its default options
    # (the hierarchical-consistency pass on), kernels on
    cfg = serving_config()
    opts = cfg.inference_options
    check(opts.enable_hierarchical_consistency_check and opts.data_parallel == "auto",
          "the serving phase runs with the default inference options")
    model = build_model_for_inference(cfg, dtype=torch.bfloat16, device=dev,
                                      use_flash_attn=True, fused_convnext_mlp=None, seed=SEED)
    taxonomy, maps = serving_taxonomy(cfg)
    handler = LinnaeusInferenceHandler(cfg, model, taxonomy, maps)
    rng = np.random.default_rng(SEED)
    reqs = [requests(n, rng) for n in (1, 7, 64)]
    fa.LAUNCHES = fm.LAUNCHES = 0
    answers = [handler.predict(images, metas) for images, metas in reqs]
    launches = {"K1": fa.LAUNCHES, "K2": fm.LAUNCHES}
    print(f"served requests of 1, 7, 64 images; launches K1 {launches['K1']}, "
          f"K2 {launches['K2']} over 3 forwards", flush=True)
    nulled = sum(check_results(results, len(images), taxonomy, maps)
                 for (images, _), results in zip(reqs, answers))
    print(f"every result obeys the taxonomy tree; the consistency pass nulled {nulled} of "
          f"{72 * len(TASKS)} task results (random weights)", flush=True)
    check(launches == {"K1": 3 * K1_PER_FORWARD, "K2": 3 * K2_PER_FORWARD},
          f"launch counts {launches}")
    again = handler.predict(*reqs[1])
    drift = max(abs(p - q) for r1, r2 in zip(answers[1], again)
                for t1, t2 in zip(r1.tasks, r2.tasks)
                for (_, p), (_, q) in zip(t1.predictions, t2.predictions))
    same_ids = all([i for i, _ in t1.predictions] == [i for i, _ in t2.predictions]
                   for r1, r2 in zip(answers[1], again) for t1, t2 in zip(r1.tasks, r2.tasks))
    print(f"repeat of the 7-image request: same top-k ids {same_ids}, max|dp| {drift:.3e}",
          flush=True)
    check(same_ids and drift <= 1e-6, "repeat request gives the same answer")

    # 4. the whole forward, kernels on vs off, same weights
    off = build_model_for_inference(cfg, dtype=torch.bfloat16, device=dev,
                                    use_flash_attn=False, fused_convnext_mlp=False, seed=SEED)
    off.load_state_dict(model.state_dict())
    compare_forward(model, off, torch.bfloat16, BATCH, dev)
    on32 = build_model_for_inference(cfg, dtype=torch.float32, device=dev,
                                     use_flash_attn=True, fused_convnext_mlp=True, seed=SEED)
    off32 = build_model_for_inference(cfg, dtype=torch.float32, device=dev,
                                      use_flash_attn=False, fused_convnext_mlp=False, seed=SEED)
    compare_forward(on32, off32, torch.float32, 8, dev)
    del on32, off32

    # 5. throughput at B = 64
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    x = torch.randn(BATCH, IMG, IMG, 3, generator=g, device=dev)
    aux = torch.randn(BATCH, 11, generator=g, device=dev)
    with torch.inference_mode():
        times = {}
        for name, net in (("on", model), ("off", off), ("off", off), ("on", model)):
            times.setdefault(name, []).append(cuda_ms(lambda: net(x, aux), iters=5))
    fwd = {k: sum(v) / len(v) for k, v in times.items()}
    images, metas = reqs[2]
    handler.predict(images, metas)
    iters = 5
    start = time.perf_counter()
    for _ in range(iters):
        handler.predict(images, metas)
    img_s = iters * BATCH / (time.perf_counter() - start)
    print(f"[{card}] mFormerV1_sm {IMG}px bf16 B={BATCH}: forward {fwd['on']:.2f} ms "
          f"with kernels, {fwd['off']:.2f} ms without; serving {img_s:.1f} img/s "
          f"(predict of 64 uint8 images, host preprocessing included)", flush=True)

    # 6. train: a few steps with the kernels on, the same steps with them off
    del model, off, handler
    torch.cuda.empty_cache()
    trained = train_phase(dev, card, fa, fm)["on"]["launches"]

    # 7. train at 512 px: stage 3 holds 1028 tokens, so K1's backward takes
    # the split dQ and dK/dV kernels there and the fused kernel at stage 4
    trained_large = train_phase(dev, card, fa, fm, IMG_LARGE)["on"]["launches"]
    trained["K1_dq"], trained["K1_dkv"] = trained_large["K1_dq"], trained_large["K1_dkv"]

    # 8. K3's path: the fused-block A/B tool, forward and train
    trained["K3"] = block_ab_phase(dev, fm, fb)

    kernels = []
    for r, key, name, src, replaces in (
        (rec["K1"], "K1", "flash_attention_fwd",
         "linnaeus_tpu_torch/csrc/flash_attention_fwd.cu", "linnaeus_tpu/ops/flash_attention.py:57"),
        (rec_bwd["K1"], "K1_bwd", "flash_attention_bwd",
         "linnaeus_tpu_torch/csrc/flash_attention_bwd.cu", "linnaeus_tpu/ops/flash_attention.py:156"),
        (rec["K2"], "K2", "fused_convnext_mlp_fwd",
         "linnaeus_tpu_torch/csrc/fused_mlp_fwd_wgmma.cu", "linnaeus_tpu/ops/fused_mlp.py:39"),
        (rec_bwd["K2"], "K2_bwd", "fused_convnext_mlp_bwd",
         "linnaeus_tpu_torch/csrc/fused_mlp_bwd_wgmma.cu", "linnaeus_tpu/ops/fused_mlp.py:155"),
        (rec_split["dq"], "K1_dq", "flash_attention_bwd_dq",
         "linnaeus_tpu_torch/csrc/flash_attention_bwd_split.cu",
         "linnaeus_tpu/ops/flash_attention.py:112"),
        (rec_split["dkv"], "K1_dkv", "flash_attention_bwd_dkv",
         "linnaeus_tpu_torch/csrc/flash_attention_bwd_split.cu",
         "linnaeus_tpu/ops/flash_attention.py:207"),
        (rec_block, "K3", "fused_convnext_block_fwd",
         "linnaeus_tpu_torch/csrc/fused_dwconv_mlp_fwd.cu",
         "linnaeus_tpu/ops/fused_dwconv_mlp.py:50"),
    ):
        # launches: over its path's run (the 384 px train steps; the 512 px
        # train steps for the split backward; the A/B tool for K3), counted
        # from zero; the forwards also served the requests
        check(trained[key] > 0, f"kernel {name} was not launched on its path")
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": trained[key], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "ms_spread": r.get("ms_spread"),
                        "library_chain_ms": r.get("library_chain_ms"),
                        "serving_launches": launches.get(key),
                        "launches_512px": trained_large.get(key), "shape": r["shape"],
                        "dtype": "bfloat16", "other_shapes": r.get("other_shapes", [])})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
