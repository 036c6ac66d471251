#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (linnaeus_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
nvcc. It builds the CUDA kernels from linnaeus_tpu_torch/csrc/ and holds
each one (K1 forward and backward, the backward's dQ and dK/dV kernels
also alone; K2 forward and backward; K3, the fused ConvNeXt block) against its
plain PyTorch version at the shapes its path gives it, in float32 and in
bfloat16 (all of K1, K2 and K3's MLP tail then run on the tensor cores, in
float32 on the CUDA cores; K1's and K2's times are medians of three repeats,
with the spread; K2 must give the same bits twice, forward and backward; the
bf16 library chain LN -> linear -> GELU -> linear is timed beside K2 and K3
as a yardstick of several calls, and its backward, through autograd, beside
K2's backward). It checks the width rule of the ConvNeXt
block: left to choose, a block runs at the lg and xl presets' widths through
the route the rule names, and told to fuse past the kernels' widths it
raises by name. It holds drop path's per-sample scale at the 384 px train
step's shapes (B = 128): the scale-add kernel forward and backward at the
RoPE residuals against its plain version (a dropped sample bit for bit;
timed with no sample dropped against its byte bound and the eager chain it
replaced; the host time of one residual through drop_path_add and through
that chain), and K2 with the scale, forward and its eight gradients. Then
it serves mFormerV1_sm at 384 px in bf16 (seeded random weights) through LinnaeusInferenceHandler with
its default options but for the batch size, so with the
hierarchical-consistency pass on against a seeded taxonomy tree over the
four tasks: three predict requests of 1, 7 and 64 images, with launch
counters proving every forward went through both forward kernels and every
result held to the tree. Then it serves a bundle from disk: it writes
config.yaml (the same model and options), an architecture variant file (K1
on, HierarchicalSoftmax heads), taxonomy.json, class_map.json and a
state_dict, loads them with LinnaeusInferenceHandler.load_from_artifacts,
and serves the handler through tools/serve.make_server to concurrent HTTP
clients (8 clients x 32 requests x 4 images, some seconds of traffic)
sending base64 JPEG and PNG images with metadata: every answer held
to the tree and to handler.predict on the same bytes, K1 and K2 launches
counted against the forwards the batcher ran, requests/s and p50/p95/p99
latency printed with the host side of one 64-image predict. Then (phase 7h
(a)-(c)) the host data plane (linnaeus_tpu_torch/native/: the batched JPEG
decode with DCT prescale and area resize over cv2, in threads off the GIL)
under that handler: 64 seeded photo-size JPEGs (640x480 to 4032x3024, one
grayscale, one progressive, one shorter than 384 px on one side) through
the data plane against the per-image PIL path at the TPU package's bars,
the batch decode with cv2's own threads and with one, the host side of one
predict of them with the data plane and with LINNAEUS_TPU_NATIVE=0, and
the HTTP run again with JPEG-only requests (the batch decode takes only
batches of JPEG bytes: the mixed run measures PIL). It compares the whole
forward with the kernels on and off and reports serving throughput. Then it
trains: a few steps of make_train_step through tools/train_bench at the
same width (B = 64, bf16 compute over float32 parameters, AdamW, cosine
schedule, clip 5.0), with launch counters proving every step went through
all four kernels, against the same steps from the same seed with the
kernels off. Then it trains the same model at 512 px, where stage 3 holds
1028 tokens (where the TPU package too splits its backward). Then
(phase 7b) it trains it from the default config: AutoAugment, colour
jitter and random erasing on the device, per-block rematerialisation
('dots') on normal and GradNorm steps, GradNorm's task-weight update every
second step, the heads' parameter group of
configs/experiments/generic_mformer_example.yaml at 10x the rate, AdamW on
a cosine schedule: the first step against the same step without remat
(loss and gradient norm within the train bars, peak memory lower), one
step's and one GradNorm update's launches of K1 and K2 against the counts
the recompute implies, six steps counted from zero (finite, clipped, the
task weights move, stay positive and sum to the task count, the heads'
group at 10x), the GradNorm re-forward's batch collated again from the
step's saved generator states against what the step's forward consumed (bit
for bit) with the step's peak memory with such a batch held across it and
without, the augmentation's range, the step's, the update's and the
augmentation's times, then one Muon and one AdEMAMix step. Then (phase 7c)
it trains through the Trainer: it writes 1,280 observations (a seeded
four-rank taxonomy whose heads, with the null class, are 1000/400/100/30
wide; null upper ranks; temporal, spatial and elevation metadata; labels as
.h5, or .npz where h5py is absent; smooth 384 px JPEGs) and runs the CLI
(linnaeus_tpu_torch.train.main.main) from the default config: hybrid
images, B = 64, a 0.8 split (16 train steps and 4 val batches an epoch), 2
epochs, GradNorm every 8 steps, a checkpoint every epoch with the last 2
kept; then the CLI again with 3 epochs on the same output directory, which
auto-resumes. It checks every step's loss is finite, the launches of K1 and
K2 against the steps, GradNorm updates and validation forwards, every
validation pass reports every task, the checkpoints retention keeps, that a
resume loads the saved state bit for bit and starts at step 32, and that
the resumed epoch reads the sampler's batches for its epoch; it prints the
step under the Trainer against phase 7b's, the span between each step's
CUDA events, the device-busy share of seven profiled steps of the resumed
epoch (torch.profiler), the loader's rate and wait, peak memory, and the
validation, checkpoint and resume seconds; the loader reads the JPEG
directory a batch at a time through the host data plane (phase 7h (e):
its batch calls counted). Phase 7h (d) then runs
tools/pipeline_benchmark on 2,048 photo-like 1024x768 JPEGs at 384 px and
B = 64, one epoch of the train split a run, the loader on the card, with
the data plane on and off. Then (phase 7d) it goes from
pretrained weights to a served bundle on the same dataset: it writes seeded
ConvNeXt-Tiny and RoPE-ViT DeiT-Small checkpoints in the official layouts,
builds the Trainer of configs/experiments/generic_mformer_example.yaml
through the CLI's construction (train.main.build_trainer) with AutoBatch for
both batches under 0.10 of the card's memory, and checks every mapped tensor
against its source bit for bit before the first step, the loaders' reports
against the same mapping on the CPU, the peak at the chosen batch (its
steps and one GradNorm update) within the budget and the next larger trial
above it, BASE_LR scaled once; it trains one epoch (its peak within the
budget), builds the run again
(it resumes at the checkpoint's batches and base LR, without a search),
bundles the last checkpoint with tools/prepare_inference_bundle,
serves it (logits bit for bit against the checkpoint's model, 64
validation JPEGs through predict and over HTTP), and runs --throughput and
inspect_checkpoints. Then (phase 7e) the mFormerV0 family on the same
dataset: mFormerV0_sm (configs/model/archs/mFormerV0_sm.yaml over the
defaults) at 384 px, bf16, three metadata sources: its forward at B = 64
(CUDA events, device-busy ms under torch.profiler, peak memory; bf16
against fp32 logits of the same weights); the CLI trains it one epoch with
validation, GradNorm and a checkpoint (every BatchNorm's running
statistics moved and finite), a probe Trainer resumes it bit for bit,
running statistics included, and the CLI runs on to a second epoch with a
profiled window; a seeded MetaFG-layout file loads through
MODEL.PRETRAINED_SOURCE 'metaformer' (the same reports as on the CPU); the
handler serves the training checkpoint directory with the logits of the
bundle tool's weights.pt bit for bit, then over HTTP. None of the seven
kernels is on mFormerV0's path, and the phase checks none was launched.
Then (phase 7g) mFormerV1_sm_moe (configs/model/archs/mFormerV1_sm_moe.yaml:
8 experts, top-2, capacity factor 1.25 on stage 3 blocks 1 and 3 and stage
4 block 1) at 384 px in bf16: the config form's model with seeded weights
serves 64 images through the handler with its default options (K1 7 and K2
6 launches a forward), its forward timed against its dense twin's,
device-busy ms, peak, bf16 against fp32 logits; train_bench --moe steps at
B=64 with the kernels on and off (the first step's loss within the train
bar, the statistics finite, the dropped share in [0, 1), K1 7 + 7 and K2
6 + 6 a step); then the CLI's Trainer upcycles phase 7d's seeded
ConvNeXt-Tiny and DeiT-S files into it (every expert of every bank the
dense twin's MLP bit for bit before the first step), trains one epoch on
phase 7c's dataset with the statistics at every step, the handler serves
the checkpoint directory with the checkpoint's model's logits bit for bit,
and tools/export_torch.py exports it to the reference layout, which loads
strict into mFormerV1_sm.
Then (phase 7f) it goes from phase 1 to phase 2 on the receipt data: K1's
forward and K2's forward at the rollout's one image (B = 1) and K1's fused
backward and K2's forward and backward at the PPO update's batch of 128
rollout steps, each against its plain version at the kernel bars, timed
beside its bound and the library call; then the counts from zero:
tools/e2e_train_bench.generate_dataset writes 1,024 learnable 384 px
samples of 125 species with a tenth null (JPEGs, .npz labels); the CLI trains
configs/experiments/tpu_trainrun_synth_384.yaml on them for 2 epochs (cut
from 8, warm-up cut to 8 steps) with the kernels on and again with them
off (no launch), tools/train_run_receipt distils each run (every field, the
loss falling), and the val loss at the last step agrees on vs off within
RECEIPT_VAL_RTOL; then rl/train_abstention fine-tunes the kernels-on
checkpoint with PPO (configs/experiments/rl_abstention_384.yaml, 2
iterations of 128 actions, 64 eval samples, abstain prior 0.2): a complete
finite receipt, the saved policy loaded back, the rollout's ms an action,
the update's ms an epoch and the device-busy share of one more profiled
iteration; K3 not launched in the phase.
Before 7f, phase 7i (more than one GPU, at world size 1: the card is one
H100 and NCCL refuses two ranks on one card) runs phase 7c's experiment cut
to 8 steps through the CLI in this process, then under ``python -m
torch.distributed.run --standalone --nproc_per_node 1`` with
PARALLEL.PARAM_SHARDING 'replicated' and 'fsdp' (FSDP2) over NCCL: every
step's loss and pre-clip norm against the one-process run's (bit-equality
printed, the first step held to the train bars), the step ms, the
device-busy share of a profiled window and the kernels' launches, counted
from 0 in the run's own process (``chip_smoke.py --train-child``), for
each (both bit for bit; FSDP2 wraps each block and the root, a unit a
block); the fsdp run's checkpoint
(whole, the one-process format) resumed bit for bit in a one-process
Trainer and served through the handler against the one-process
checkpoint's answers within PROB_TOL; data_parallel 'auto' resolving to 1
and 2 raising the ValueError that names the device count; a probe of
whether gloo takes CUDA tensors for the step's collectives and, if it does,
two gloo ranks on the one card each taking 32 rows of the B=64 step (the
first step within the train bars); estimate_model_complexity of
mFormerV1_sm at 384 px (params exactly the stored table's, FLOPs within
5%, the activation MB printed beside the stored one); and F10: K1's
backward twice on the same operands, bit for bit, and its time. Then
(phase 7j) tools/shard_plan for mFormerV1_sm at 384 px, 64 rows a data
rank, under dp (data 8), fsdp (data 8), tp (data 4, model 2) and pp (data 4,
model 5): rank 0's bytes, its step's collectives over the fake process
group, the partner rows fetched at each mixup group level of the default
config ('mixed-pairs' batches of scale_receipt's labels) and the steps'
peak; no image row all-gathered under dp, FSDP2's largest gather one
unit's. Then it runs tools/fused_block_ab (K3 against the library convolution + K2 and
against the plain chain, forward and train). It prints its own time, one
JSON line about the seven kernels, and as its last line

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failed check raises, so the exit code is non-zero and that line is not
printed. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import gc
import json
import shutil
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
# at 512 px: stage 3 (32x32 + 4, past 1024, where the TPU package splits its
# backward) and stage 4 (16x16 + 4)
IMG_LARGE = 512
K1_SHAPES_LARGE = [(BATCH, 1028, 6, 64), (BATCH, 260, 12, 64)]
# K3: stage 1 and stage 2 of the 384 px model, and a small odd image
K3_SHAPES = [(BATCH, 96, 96, 96), (BATCH, 48, 48, 192), (2, 9, 11, 96)]
# K2: stage 1 (B*96*96 rows, C=96) and stage 2 (B*48*48 rows, C=192)
K2_SHAPES = [(BATCH * 96 * 96, 96), (BATCH * 48 * 48, 192), (70, 96)]
# drop path's per-sample scale at the 384 px train step's shapes, B = 128
# (benchmark/traffic/train384.json): the RoPE residuals of stages 3 and 4,
# K2's rows of stages 1 and 2
DROP_PATH_BATCH = 128
DROP_PATH_SHAPES = [(DROP_PATH_BATCH, 580, 384), (DROP_PATH_BATCH, 148, 768)]
K2_SCALED_SHAPES = [(DROP_PATH_BATCH * 96 * 96, 96), (DROP_PATH_BATCH * 48 * 48, 192)]
# the scale-add kernel's one FMA against the plain version's product and
# sum, relative to the largest output: a rounding of the output's dtype
SCALE_ADD_TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-2}
# the TPU kernel tests' bars against their own plain versions
K1_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
K2_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
K1_STAGE3, K1_STAGE4 = 5, 2  # RoPE blocks of mFormerV1_sm's stages 3 and 4
K1_PER_FORWARD = K1_STAGE3 + K1_STAGE4
K2_PER_FORWARD = 3 + 3  # ConvNeXt blocks of stages 1 and 2
# scale-add launches a forward (and as many backward): the attention and
# MLP residuals of every RoPE block under drop path (all of them at 0.05)
DROP_PATH_PER_FORWARD = 2 * K1_PER_FORWARD
# backward kernels against their plain versions, relative to each gradient's
# largest magnitude: fp32 runs the same math in another summation order;
# in bf16 a rounding of P, dS, h1 or da1 that
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
    """``kind``: False/"fwd", True/"bwd" (the whole backward: its least work
    is the one-pass kernel's five products), "dq" or "dkv"."""
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


def mlp_chain_bwd_ms(y, dout, ln_w, ln_b, w1, b1, w2, b2, gamma) -> float:
    """Time of K2's backward as autograd of the same chain of PyTorch's
    own operators in y's dtype (layer_norm, linear, gelu, linear, scale):
    the eight gradients K2's backward gives, through torch.autograd.grad,
    the forward's saved activations in device memory. The yardstick where
    no single call exists, used nowhere in the port. Timed as K2 is."""
    import torch.nn.functional as F

    dt = y.dtype
    ins = [t.detach().to(dt).requires_grad_() for t in (y, ln_w, ln_b, w1, b1, w2, b2, gamma)]
    yy, lw, lb, w1c, b1c, w2c, b2c, g = ins
    h = F.layer_norm(yy, (yy.shape[-1],), lw, lb, 1e-6)
    out = F.linear(F.gelu(F.linear(h, w1c, b1c), approximate="tanh"), w2c, b2c) * g
    return cuda_ms_median(lambda: torch.autograd.grad(out, ins, dout, retain_graph=True),
                          iters=10)[0]


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


def host_us_per_call(fn, calls: int = 300) -> float:
    """Host microseconds a call of ``fn`` over ``calls`` calls, after 20
    warm-up calls: at shapes whose device work takes a few microseconds
    the device keeps up, and this is the Python, autograd and launch cost."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - start) / calls


def check_drop_path_kernels(dev, fm) -> dict:
    """Drop path's per-sample scale at the 384 px train step's shapes
    (B = 128). The scale-add kernel (ops/drop_path.py), forward and
    backward at the RoPE residuals, against its plain version: a dropped
    sample's output is its residual and its gradient zero, bit for bit;
    the backward is the plain version's bits; two launches give the same
    bits. It is timed with no sample dropped, so that every byte of its
    bound (3T forward, 2T backward) moves, beside the plain version and
    the eager chain it replaced (a division, a zero tensor, a broadcast
    ``where`` and the add; its backward by autograd). Then the host time of
    one residual forward and backward at a small shape, through
    ``drop_path_add`` and through that eager chain, and K2 with the scale,
    forward and its eight gradients, against its plain version. Returns
    the scale-add kernel's record and K2's scaled rows."""
    from linnaeus_tpu_torch.models.blocks.common import DropPath, drop_path_add
    from linnaeus_tpu_torch.ops import drop_path as dpk

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    keep = 0.95  # the cell's rate 0.05

    def drop_scale(B):  # every seventh sample dropped
        u = torch.rand(B, generator=g, device=dev)
        u[::7] = 0.99
        return dpk.SampleScale(u, keep)

    def dropped(scale):
        return [b for b, k in enumerate((scale.u < scale.keep).tolist()) if not k]

    def eager(residual, branch, mask):  # the parent's route
        return residual + torch.where(mask, branch / keep, torch.zeros_like(branch))

    rec = {"max_abs_err": 0.0, "other_shapes": [], "k2_scaled": []}
    for dt in (torch.float32, torch.bfloat16):
        for shape in DROP_PATH_SHAPES:
            residual, branch, dout = (torch.randn(shape, generator=g, device=dev).to(dt)
                                      for _ in range(3))
            scale = drop_scale(shape[0])
            out, d_branch = dpk._launch(residual, branch, scale), dpk._launch_bwd(dout, scale)
            same = (torch.equal(out, dpk._launch(residual, branch, scale))
                    and torch.equal(d_branch, dpk._launch_bwd(dout, scale)))
            want = dpk.scale_add_reference(residual, branch, scale)
            err = rel_err(out, want)
            bwd_bits = torch.equal(d_branch, dpk.scale_samples_reference(dout, scale))
            gone = dropped(scale)
            kept_out = all(torch.equal(out[b], residual[b]) and not d_branch[b].any()
                           for b in gone)
            print(f"drop path scale-add {str(dt)[6:]} {shape}: max rel err {err:.3e} (tol "
                  f"{SCALE_ADD_TOL[dt]:g}); backward the plain version's bits: {bwd_bits}; "
                  f"{len(gone)} dropped samples their residual and no gradient: {kept_out}; "
                  f"bit-identical over two launches: {same}", flush=True)
            check(err <= SCALE_ADD_TOL[dt], f"scale-add {dt} {shape} error {err}")
            check(bwd_bits, f"scale-add backward {dt} {shape} differs from its plain version")
            check(bool(gone) and kept_out, f"scale-add {dt} {shape}: a dropped sample")
            check(same, f"scale-add {dt} {shape} differs between two launches")
            if dt != torch.bfloat16:
                continue
            rec["max_abs_err"] = max(rec["max_abs_err"], max_err(out, want))
            full = dpk.SampleScale(torch.zeros_like(scale.u), keep)  # every sample kept
            ms, spread = cuda_ms_median(lambda: dpk._launch(residual, branch, full))
            bwd_ms, bwd_spread = cuda_ms_median(lambda: dpk._launch_bwd(dout, full))
            plain_ms = cuda_ms(lambda: dpk.scale_add_reference(residual, branch, full))
            mask = torch.ones((shape[0],) + (1,) * (len(shape) - 1), dtype=torch.bool, device=dev)
            eager_ms = cuda_ms_median(lambda: eager(residual, branch, mask))[0]
            leaf = branch.detach().requires_grad_()
            summed = eager(residual, leaf, mask)
            eager_bwd_ms = cuda_ms_median(
                lambda: torch.autograd.grad(summed, leaf, dout, retain_graph=True))[0]
            del leaf, summed
            T = residual.numel() * residual.element_size()
            fwd_bound, bwd_bound = bound(0, 3 * T, dt), bound(0, 2 * T, dt)
            print(f"   no sample dropped: kernel {ms:.4f} ms forward (spread {spread:.4f}; "
                  f"{ms / fwd_bound['bound_ms']:.2f}x its bound of 3T, "
                  f"{fwd_bound['bound_ms']:.4f} ms), {bwd_ms:.4f} ms backward (spread "
                  f"{bwd_spread:.4f}; {bwd_ms / bwd_bound['bound_ms']:.2f}x its bound of 2T, "
                  f"{bwd_bound['bound_ms']:.4f} ms); plain {plain_ms:.3f} ms; the eager chain "
                  f"{eager_ms:.4f} ms forward, {eager_bwd_ms:.4f} ms backward", flush=True)
            timed = dict(ms=ms, ms_spread=spread, bwd_ms=bwd_ms, bwd_ms_spread=bwd_spread,
                         plain_ms=plain_ms, library_ms=None, eager_ms=eager_ms,
                         eager_bwd_ms=eager_bwd_ms, bwd_bound_ms=bwd_bound["bound_ms"],
                         dropped_share=0.0, shape=list(shape), **fwd_bound)
            if shape == DROP_PATH_SHAPES[0]:
                check(ms <= 1.5 * fwd_bound["bound_ms"] and bwd_ms <= 1.5 * bwd_bound["bound_ms"],
                      f"scale-add at {shape}: {ms:.4f} / {bwd_ms:.4f} ms against bounds "
                      f"{fwd_bound['bound_ms']:.4f} / {bwd_bound['bound_ms']:.4f} ms")
                rec.update(timed)
            else:
                rec["other_shapes"].append(timed)
            del residual, branch, dout, out, d_branch, want

    # host time of one residual, forward and backward, where the device work
    # is a few microseconds: the helper against the parent's eager chain
    block = DropPath(1.0 - keep).train()
    block.generator = torch.Generator(device=dev).manual_seed(SEED)
    small = [torch.randn(8, 16, 64, generator=g, device=dev).bfloat16().requires_grad_()
             for _ in range(2)]
    cot = torch.randn(8, 16, 64, generator=g, device=dev).bfloat16()

    def helper():
        drop_path_add(small[0], small[1], block).backward(cot)

    def parent():
        mask = torch.rand((8, 1, 1), generator=block.generator, device=dev) < keep
        eager(small[0], small[1], mask).backward(cot)

    host = {"helper": [], "eager": []}
    for name, fn in (("helper", helper), ("eager", parent), ("eager", parent),
                     ("helper", helper)):
        host[name].append(host_us_per_call(fn))
    rec["host_us"] = {k: sum(v) / len(v) for k, v in host.items()}
    print(f"host time of one residual, forward and backward (8x16x64 bf16): drop_path_add "
          f"{rec['host_us']['helper']:.1f} us, the parent's eager chain "
          f"{rec['host_us']['eager']:.1f} us (each the mean of two runs of 300 calls; runs "
          f"{host})", flush=True)

    # K2 with the scale at the train step's rows, forward and eight gradients
    for M, C in K2_SCALED_SHAPES:
        dt = torch.bfloat16
        y, x, dout = (torch.randn(M, C, generator=g, device=dev).to(dt) for _ in range(3))
        vec = lambda n, s, m=0.0: m + s * torch.randn(n, generator=g, device=dev)  # noqa: E731
        ln_w, ln_b, b1, b2, gamma = vec(C, 0.1, 1.0), vec(C, 0.1), vec(4 * C, 0.1), vec(C, 0.1), vec(C, 0.1, 0.5)
        w1 = (0.1 * torch.randn(4 * C, C, generator=g, device=dev)).to(dt)
        w2 = (0.1 * torch.randn(C, 4 * C, generator=g, device=dev)).to(dt)
        scale = drop_scale(DROP_PATH_BATCH)
        params = (ln_w, ln_b, w1, b1, w2, b2, gamma, 1e-6, True)
        out = fm._launch(y, x, *params, scale=scale)
        grads = fm._launch_bwd(y, dout, *params, scale=scale)
        same = (torch.equal(out, fm._launch(y, x, *params, scale=scale))
                and all(torch.equal(a, b) for a, b in
                        zip(grads, fm._launch_bwd(y, dout, *params, scale=scale))))
        want = fm.fused_convnext_mlp_reference(y, x, *params, scale=scale)
        err = max_err(out, want)
        del want
        want_grads = fm.fused_convnext_mlp_bwd_reference(y, dout, *params, scale=scale)
        bwd_err = max(rel_err(a, b) for a, b in zip(grads, want_grads))
        del want_grads
        rows = M // DROP_PATH_BATCH
        gone = dropped(scale)
        kept_out = all(torch.equal(out[b * rows:(b + 1) * rows], x[b * rows:(b + 1) * rows])
                       and not grads[0][b * rows:(b + 1) * rows].any() for b in gone)
        ms, spread = cuda_ms_median(lambda: fm._launch(y, x, *params, scale=scale), iters=20)
        bwd_ms, bwd_spread = cuda_ms_median(
            lambda: fm._launch_bwd(y, dout, *params, scale=scale), iters=10)
        print(f"K2 with the drop-path scale bf16 (M,C)={(M, C)} B={DROP_PATH_BATCH}: forward "
              f"max|err| {err:.3e} (tol {K2_TOL[dt]:g}), backward max rel err {bwd_err:.3e} "
              f"over the eight gradients (tol {BWD_TOL[dt]:g}); {len(gone)} dropped samples "
              f"their residual and no dy: {kept_out}; bit-identical over two launches: {same}; "
              f"forward {ms:.4f} ms (spread {spread:.4f}), backward {bwd_ms:.4f} ms (spread "
              f"{bwd_spread:.4f})", flush=True)
        check(err <= K2_TOL[dt], f"K2 scaled {(M, C)} error {err}")
        check(bwd_err <= BWD_TOL[dt], f"K2 scaled backward {(M, C)} error {bwd_err}")
        check(bool(gone) and kept_out, f"K2 scaled {(M, C)}: a dropped sample")
        check(same, f"K2 scaled {(M, C)} differs between two launches")
        rec["k2_scaled"].append(dict(shape=[M, C], max_abs_err=err, bwd_max_rel_err=bwd_err,
                                     ms=ms, ms_spread=spread, bwd_ms=bwd_ms,
                                     bwd_ms_spread=bwd_spread))
        del y, x, dout, out, grads
    torch.cuda.empty_cache()
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
                        chain_ms = mlp_chain_bwd_ms(y, dout, ln_w, ln_b, w1, b1, w2, b2, gamma)
                        print(f"   the bf16 library chain's backward (autograd of layer_norm, "
                              f"linear, gelu, linear) on the same operands: {chain_ms:.4f} ms",
                              flush=True)
                        timed = dict(ms=ms, ms_spread=spread, plain_ms=plain_ms, shape=[M, C],
                                     library_ms=None, library_chain_ms=chain_ms,
                                     **k2_bound((M, C), dt, True))
                        if C == 96:
                            rec["K2"].update(timed)
                        else:
                            rec["K2"]["other_shapes"].append(timed)
    return rec


def check_split_backward(dev, fa) -> dict:
    """K1's backward is its dQ and dK/dV kernels (after the delta prologue)
    at every length: each launched alone against its plain version at the
    two 384 px stages' shapes, the 512 px stage-3 shape and a ragged small
    one; dQ bit-identical over two launches; dK and dV of the kernel alone
    the same bits as the whole backward's. Each kernel's time at the main
    path's shapes (64, 580, 6, 64), then (64, 148, 12, 64) and (64, 1028,
    6, 64) under ``other_shapes``. Returns per-kernel records."""
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    rec = {"dq": {"max_abs_err": 0.0, "other_shapes": []},
           "dkv": {"max_abs_err": 0.0, "other_shapes": []}}
    for dt in (torch.float32, torch.bfloat16):
        for B, N, H, D in (K1_SHAPES[0], K1_SHAPES[1], K1_SHAPES_LARGE[0], K1_SHAPES[2]):
            scale = D ** -0.5
            q, k, v = torch.randn(B, N, 3, H, D, generator=g, device=dev).to(dt).unbind(2)
            do = torch.randn(B, N, H, D, generator=g, device=dev).to(dt)
            o, lse = fa.flash_attention_fwd(q, k, v)
            delta = fa._launch_delta(o, do)
            dq = fa._launch_bwd_dq(q, k, v, do, lse, delta, scale)
            dq_again = fa._launch_bwd_dq(q, k, v, do, lse, delta, scale)
            dk, dv = fa._launch_bwd_dkv(q, k, v, do, lse, delta, scale)
            whole = fa._launch_bwd(q, k, v, o, lse, do, scale)
            torch.cuda.synchronize()
            same = torch.equal(dq, dq_again)
            same_whole = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), whole))
            del whole
            want_delta = fa.attention_delta(o, do)
            want_dq = fa.flash_attention_bwd_dq_reference(q, k, v, do, lse, want_delta, scale)
            want_dk, want_dv = fa.flash_attention_bwd_dkv_reference(
                q, k, v, do, lse, want_delta, scale)
            errs = {"delta": rel_err(delta, want_delta), "dq": rel_err(dq, want_dq),
                    "dk": rel_err(dk, want_dk), "dv": rel_err(dv, want_dv)}
            abs_dq = max_err(dq, want_dq)
            abs_dkv = max(max_err(dk, want_dk), max_err(dv, want_dv))
            del want_dq, want_dk, want_dv
            print(f"K1 dQ and dK/dV kernels {str(dt)[6:]} (B,N,H,D)={(B, N, H, D)}: max rel err "
                  + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
                  + f" (tol {BWD_TOL[dt]:g}); dQ bit-identical over two launches: {same}; "
                  f"the kernels alone give the whole backward's bits: {same_whole}", flush=True)
            check(all(torch.isfinite(t).all().item() for t in (dq, dk, dv)),
                  f"K1 dQ, dK/dV kernels {dt} finite")
            check(max(errs.values()) <= BWD_TOL[dt],
                  f"K1 dQ, dK/dV kernels {dt} {(B, N, H, D)} errors {errs}")
            check(same, f"dQ differs between two launches, {dt} N={N}")
            check(same_whole, f"the dQ and dK/dV kernels alone differ from the whole backward, "
                              f"{dt} N={N}")
            if dt != torch.bfloat16 or B != BATCH:
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
                b = k1_bound((B, N, H, D), dt, key)
                print(f"   {key} kernel {ms:.4f} ms (median of 3 x 50 calls, spread "
                      f"{spread:.4f}), plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms "
                      f"({b['bound_by']})", flush=True)
                rec[key]["max_abs_err"] = max(rec[key]["max_abs_err"], abs_err)
                timed = dict(ms=ms, ms_spread=spread, plain_ms=plain_ms, shape=[B, N, H, D],
                             library_ms=lib_ms, **b)
                if N == 580:
                    rec[key].update(timed)
                else:
                    rec[key]["other_shapes"].append(timed)
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
    counts. K1's backward is one call of its dQ and dK/dV kernels a block at
    every length (stage 3 at 512 px holds 1028 tokens, where the TPU package
    too takes its split pair). Under the preset's drop path each RoPE
    residual launches the scale-add kernel forward and backward with the
    kernels on, and runs in plain PyTorch with them off."""
    from linnaeus_tpu_torch.models.blocks.rope_mhsa import RoPE2DMHSABlock
    from linnaeus_tpu_torch.ops import drop_path as dpk
    from linnaeus_tpu_torch.tools import train_bench

    def counts():
        return {"K1": fa.LAUNCHES, "K1_bwd": fa.BWD_LAUNCHES, "K1_dq": fa.DQ_LAUNCHES,
                "K1_dkv": fa.DKV_LAUNCHES, "K2": fm.LAUNCHES, "K2_bwd": fm.BWD_LAUNCHES,
                "drop_path_add": dpk.LAUNCHES, "drop_path_add_bwd": dpk.BWD_LAUNCHES}

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
        dpk.LAUNCHES = dpk.BWD_LAUNCHES = 0
        scaled = 2 * sum(1 for m in state.model.modules()
                         if isinstance(m, RoPE2DMHSABlock) and m.drop_path.rate > 0)
        if img == IMG:
            check(scaled == DROP_PATH_PER_FORWARD, f"{scaled} RoPE residuals under drop path")
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
        want = ({"K1": n * K1_PER_FORWARD, "K1_bwd": n * K1_PER_FORWARD,
                 "K1_dq": n * K1_PER_FORWARD, "K1_dkv": n * K1_PER_FORWARD,
                 "K2": n * K2_PER_FORWARD, "K2_bwd": n * K2_PER_FORWARD,
                 "drop_path_add": n * scaled, "drop_path_add_bwd": n * scaled} if kernels
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

# the default-config phase: remat "dots" on both kinds of step recomputes
# every tower block in the backward, and the policies see no product inside
# K1 or K2 (models/utils.py), so each block launches its forward kernel once
# in the forward and once in the recompute; the backward kernels run once.
# A GradNorm update re-forwards the collated batch once per task (four),
# each with its recompute and its backward (loss/gradnorm.py).
DEFAULT_CFG_STEPS = 6
GRADNORM_INTERVAL = 2
K1_PER_REMAT_STEP = {"K1": 2 * K1_PER_FORWARD, "K1_bwd": K1_PER_FORWARD,
                     "K1_dq": K1_PER_FORWARD, "K1_dkv": K1_PER_FORWARD,
                     "K2": 2 * K2_PER_FORWARD, "K2_bwd": K2_PER_FORWARD}
PER_GRADNORM = {k: len(TASKS) * v for k, v in K1_PER_REMAT_STEP.items()}


def default_config(remat: bool = True, optimizer: str = "adamw"):
    """The TPU package's default config (the port's copy) with mFormerV1_sm
    at 384 px, K1 on (K2 by the 'auto' rule), GradNorm every
    GRADNORM_INTERVAL steps and the parameter groups of
    configs/experiments/generic_mformer_example.yaml; every other option at
    its default (AutoAugment 'original', jitter 0.4, erasing 0.25, remat
    'dots' for both kinds of step, AdamW, cosine)."""
    import yaml

    from linnaeus_tpu_torch.tools import train_bench

    cfg = train_bench.default_train_config(IMG, True, "mFormerV1_sm", tuple(TASKS))
    with open("configs/experiments/generic_mformer_example.yaml") as f:
        groups = yaml.safe_load(f)["OPTIMIZER"]["PARAMETER_GROUPS"]
    cfg.merge_from_other_cfg({"OPTIMIZER": {"NAME": optimizer, "PARAMETER_GROUPS": groups},
                              "LOSS": {"GRAD_WEIGHTING": {"TASK": {
                                  "UPDATE_INTERVAL": GRADNORM_INTERVAL}}}})
    cfg.OPTIMIZER.PARAMETER_GROUPS.DEFAULT.OPTIMIZER = optimizer
    gc = cfg.TRAIN.GRADIENT_CHECKPOINTING
    check(gc.ENABLED_NORMAL_STEPS and gc.ENABLED_GRADNORM_STEPS and gc.POLICY == "dots"
          and cfg.AUG.AUTOAUG.POLICY == "original" and cfg.AUG.SINGLE_AUG_DEVICE == "device"
          and cfg.LOSS.GRAD_WEIGHTING.TASK.TYPE == "gradnorm"
          and cfg.LR_SCHEDULER.NAME == "cosine", "the default config's training options")
    gc.ENABLED_NORMAL_STEPS = remat
    return cfg


def default_config_phase(dev, card, fa, fm) -> dict:
    """Train mFormerV1_sm at 384 px, B = 64, bf16 from the default config
    through tools/train_bench: DEFAULT_CFG_STEPS steps with GradNorm's
    update after every GRADNORM_INTERVAL-th, and the checks and times listed
    in main; returns the launch counts of the driven run."""
    from linnaeus_tpu_torch.loss.gradnorm import should_update_gradnorm
    from linnaeus_tpu_torch.tools import train_bench

    def counts():
        return {"K1": fa.LAUNCHES, "K1_bwd": fa.BWD_LAUNCHES, "K1_dq": fa.DQ_LAUNCHES,
                "K1_dkv": fa.DKV_LAUNCHES, "K2": fm.LAUNCHES, "K2_bwd": fm.BWD_LAUNCHES}

    def delta(before):
        return {k: v - before[k] for k, v in counts().items()}

    def zero():
        fa.LAUNCHES = fa.BWD_LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
        fm.LAUNCHES = fm.BWD_LAUNCHES = 0

    first = {}
    for remat in (False, True):
        cfg = default_config(remat)
        bench, state = train_bench.build_step(BATCH, config=cfg, num_classes=TASKS, device=dev,
                                              seed=SEED)
        check(state.model.gradient_checkpointing is remat
              and state.model.remat_policy == "dots", f"remat {remat} from the config")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        m = bench.train()
        torch.cuda.synchronize()
        first[remat] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm_pre_clip"]),
                        "peak_gib": (torch.cuda.max_memory_allocated(dev) - base) / 2**30,
                        "ms": cuda_ms(bench.train, iters=3)}
        if remat:
            break
        del bench, state
        torch.cuda.empty_cache()
    d_loss = abs(first[True]["loss"] - first[False]["loss"]) / abs(first[False]["loss"])
    d_norm = (abs(first[True]["grad_norm"] - first[False]["grad_norm"])
              / abs(first[False]["grad_norm"]))
    print(f"default config, first step with remat 'dots' vs without, same seed, weights and "
          f"collated batch: loss {first[True]['loss']:.5f} vs {first[False]['loss']:.5f} "
          f"(rel {d_loss:.2e}, tol {TRAIN_LOSS_RTOL:g}); grad norm {first[True]['grad_norm']:.4f} "
          f"vs {first[False]['grad_norm']:.4f} (rel {d_norm:.2e}, tol {TRAIN_GRAD_NORM_RTOL:g}); "
          f"peak memory of the step {first[True]['peak_gib']:.2f} vs "
          f"{first[False]['peak_gib']:.2f} GiB", flush=True)
    check(d_loss <= TRAIN_LOSS_RTOL, f"remat vs not: first-step loss rel {d_loss}")
    check(d_norm <= TRAIN_GRAD_NORM_RTOL, f"remat vs not: first-step grad norm rel {d_norm}")
    check(first[True]["peak_gib"] < first[False]["peak_gib"],
          f"peak memory with remat {first[True]['peak_gib']} is not below "
          f"{first[False]['peak_gib']} without")

    # one train step and one GradNorm update alone: their launch counts
    before = counts()
    bench.train()
    step_counts = delta(before)
    before = counts()
    bench.gradnorm()
    gn_counts = delta(before)
    torch.cuda.synchronize()
    print(f"default config launches: a train step {step_counts} (expected "
          f"{K1_PER_REMAT_STEP}), a GradNorm update {gn_counts} (expected {PER_GRADNORM})",
          flush=True)
    for got, want, what in ((step_counts, K1_PER_REMAT_STEP, "train step"),
                            (gn_counts, PER_GRADNORM, "GradNorm update")):
        check(got == {**dict.fromkeys(got, 0), **want}, f"{what} launch counts {got}, "
              f"expected {want}")

    # the driven run: DEFAULT_CFG_STEPS steps from a fresh state, counted from 0
    del bench, state
    torch.cuda.empty_cache()
    bench, state = train_bench.build_step(BATCH, config=default_config(), num_classes=TASKS,
                                          device=dev, seed=SEED)
    gw = state.gradnorm
    w0 = gw.task_weights.clone()
    before_params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    torch.cuda.synchronize()
    zero()
    history = [bench() for _ in range(DEFAULT_CFG_STEPS)]
    torch.cuda.synchronize()
    launched = counts()
    n_gn = sum("gradnorm" in m for m in history)
    want_gn = sum(should_update_gradnorm(bench.gradnorm_cfg, s)
                  for s in range(1, DEFAULT_CFG_STEPS + 1))
    check(n_gn == want_gn == DEFAULT_CFG_STEPS // GRADNORM_INTERVAL,
          f"{n_gn} GradNorm updates in {DEFAULT_CFG_STEPS} steps, expected {want_gn}")
    want = {k: DEFAULT_CFG_STEPS * K1_PER_REMAT_STEP.get(k, 0) + n_gn * PER_GRADNORM.get(k, 0)
            for k in launched}
    losses = [float(m["loss"]) for m in history]
    pre = [float(m["grad_norm_pre_clip"]) for m in history]
    post = [float(m["grad_norm_post_clip"]) for m in history]
    weights = [m["gradnorm"]["gradnorm/weights"].tolist() for m in history if "gradnorm" in m]
    w = state.gradnorm.task_weights
    groups = {g["label"]: g for g in state.optimizer.param_groups}
    heads, default = groups["HEADS"], groups["default"]
    moved = sum(not torch.equal(before_params[n], p.detach())
                for n, p in state.model.named_parameters())
    print(f"default config, {DEFAULT_CFG_STEPS} steps: loss " + " ".join(f"{v:.4f}" for v in losses)
          + "; grad norm before clip " + " ".join(f"{v:.3f}" for v in pre) + "; after clip "
          + " ".join(f"{v:.3f}" for v in post) + f"; task weights after each update {weights}; "
          f"lr default {default['lr']:.4e}, HEADS {heads['lr']:.4e}; {moved}/{len(before_params)} "
          f"parameter tensors changed; launches {launched} (expected {want})", flush=True)
    check(all(np.isfinite(v) for v in losses + pre + post), "finite losses and norms")
    check(all(v <= 5.0 + 1e-3 for v in post), "gradient norm after the clip is at most 5.0")
    check(bool((w > 0).all()) and abs(float(w.sum()) - len(TASKS)) < 1e-4
          and not torch.equal(w, w0), f"task weights {w.tolist()} move, stay positive, "
          f"sum to {len(TASKS)}")
    check(heads["lr_multiplier"] == 10.0 and heads["lr"] == 10.0 * default["lr"] > 0,
          f"the heads' group steps at 10x: {heads['lr']} vs {default['lr']}")
    check(moved >= 0.9 * len(before_params), f"{moved} parameter tensors changed")
    check(launched == want, f"default-config launch counts {launched}, expected {want}")

    # the GradNorm re-forward's batch, collated again from the step's batch
    # and its saved generator states, against what the step's forward
    # consumed (kept by a hook, as the port kept it before); the step's
    # peak memory with such a kept batch held across it and without
    seen = []
    hook = state.model.register_forward_pre_hook(
        lambda mod, args: seen.append((args[0].detach().to(state.model.dtype),
                                       args[1].detach().clone())))
    bench.train()
    hook.remove()
    images, _, meta = bench.step.collated(state, bench.data, bench.scalars)
    regen_same = torch.equal(images, seen[0][0]) and torch.equal(meta, seen[0][1])
    kept_mb = sum(t.numel() * t.element_size() for t in seen[0]) / 1e6
    del images, meta
    peaks = {}
    for kept in (True, False):  # the peak of a step, the kept batch held or not
        if not kept:
            seen.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        bench.train()
        torch.cuda.synchronize()
        peaks[kept] = torch.cuda.max_memory_allocated(dev) / 2**20
    torch.cuda.reset_peak_memory_stats(dev)
    bench.gradnorm()
    torch.cuda.synchronize()
    gn_peak = torch.cuda.max_memory_allocated(dev) / 2**20
    print(f"[{card}] GradNorm's batch collated again on the card from the step's generator "
          f"states: bit for bit what the step's forward consumed: {regen_same} (images "
          f"{tuple(bench.data['images'].shape)} in {str(state.model.dtype)[6:]} and metadata, "
          f"{kept_mb:.1f} MB, no longer held between steps); peak memory of the "
          f"default-config step {peaks[True]:.1f} MiB with such a batch held across it (the "
          f"earlier layout), {peaks[False]:.1f} MiB without ({peaks[True] - peaks[False]:.1f} "
          f"MiB less); of a GradNorm update {gn_peak:.1f} MiB", flush=True)
    check(regen_same, "the GradNorm batch collated again on the card differs from the one the "
          "step consumed")

    # the augmentation alone, on the batch in [0, 1]
    x = bench.data["images"].float() * (1.0 / 255.0)
    a, b = bench.augment(x, state.generator), bench.augment(x, state.generator)
    check(float(a.min()) >= 0.0 and float(a.max()) <= 1.0 and a.shape == x.shape,
          "augmented images stay in [0, 1]")
    check(float((a - x).abs().mean()) > 1e-2 and float((a - b).abs().mean()) > 1e-2,
          "augmented images differ from their inputs and between two draws")
    aug_ms = cuda_ms(lambda: bench.augment(x, state.generator), iters=5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = cuda_ms(bench.train, iters=3)
    gn_ms = cuda_ms(bench.gradnorm, iters=2)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[{card}] mFormerV1_sm {IMG}px B={BATCH} bf16 default-config train step: "
          f"{step_ms:.2f} ms with remat 'dots' ({first[False]['ms']:.2f} ms without; CUDA events), "
          f"GradNorm update {gn_ms:.2f} ms ({len(TASKS)} re-forwards with backward, remat), "
          f"augmentation {aug_ms:.2f} ms; peak memory {peak:.2f} GiB", flush=True)
    del bench, state, history
    torch.cuda.empty_cache()

    # one Muon and one AdEMAMix step from the same config
    for name in ("muon", "ademamix"):
        cfg = default_config(optimizer=name)
        cfg.LR_SCHEDULER.WARMUP_FRACTION = 0.0
        cfg.LR_SCHEDULER.WARMUP_STEPS = 0
        bench, state = train_bench.build_step(16, config=cfg, num_classes=TASKS, device=dev,
                                              seed=SEED)
        before_params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        m = bench.train()
        moved = sum(not torch.equal(before_params[n], p.detach())
                    for n, p in state.model.named_parameters())
        finite = all(bool(torch.isfinite(p).all()) for p in state.model.parameters())
        print(f"{name} step from the default config (B=16): loss {float(m['loss']):.4f}, "
              f"{moved}/{len(before_params)} parameter tensors changed, finite {finite}",
              flush=True)
        check(np.isfinite(float(m["loss"])) and finite and moved >= 0.9 * len(before_params),
              f"{name} step: finite and the parameters move")
        del bench, state
        torch.cuda.empty_cache()
    return {"launches": launched, "step_ms": step_ms, "gradnorm_ms": gn_ms, "aug_ms": aug_ms,
            "peak_gib": peak, "no_remat_ms": first[False]["ms"], "regen_same": regen_same,
            "step_peak_mib": peaks, "gradnorm_peak_mib": gn_peak}


# the Trainer phase (7c): the CLI trains from a dataset on disk
TRAINER_OBS = 1280
TRAINER_EPOCHS, TRAINER_RESUME_EPOCHS = 2, 3
TRAINER_GRADNORM_INTERVAL = 8  # the default is 100: cut so that 32 steps hold 4 updates
TRAINER_KEEP_LAST = 2


def write_trainer_dataset(d: str, rng: np.random.Generator) -> dict:
    """A hybrid dataset of TRAINER_OBS observations in ``d``: labels
    (``.h5`` where h5py is installed, else ``.npz`` through
    data/processor.py::write_labels_npz) and one smooth IMG px JPEG an
    observation under ``d/images``. The taxonomy is seeded: ``TASKS[r] - 1``
    taxa at rank r, each with a parent one rank up and every parent with a
    child, so that with the null class the heads have the widths of TASKS;
    the first observations hold every L10 taxon once;
    some of the rest are null from a rank upward. Metadata: temporal (2),
    spatial (3), elevation (10) columns."""
    import importlib.util
    import os

    from PIL import Image

    from linnaeus_tpu_torch.data.processor import write_labels_npz

    img, n_obs = IMG, TRAINER_OBS
    taxa = [w - 1 for w in TASKS.values()]
    parents = [rng.permutation(taxa[r]) % taxa[r + 1] + 1 for r in range(len(taxa) - 1)]
    leaf = np.concatenate([np.arange(1, taxa[0] + 1),
                           rng.integers(1, taxa[0] + 1, n_obs - taxa[0])])
    ranks = [leaf]
    for parent in parents:
        ranks.append(parent[ranks[-1] - 1])
    ranks = np.stack(ranks).astype(np.int64)  # [4, N]
    extra = np.arange(taxa[0], n_obs)
    nulled = rng.choice(extra, len(extra) // 3, replace=False)
    cut = rng.integers(1, len(taxa), len(nulled))
    for row, k in zip(nulled, cut):
        ranks[k:, row] = 0
    order = rng.permutation(n_obs)
    ranks = ranks[:, order]
    ids = np.array([f"obs{i:05d}" for i in range(n_obs)], dtype="S12")
    day = rng.uniform(0, 2 * np.pi, n_obs)
    datasets = {
        "img_identifiers": ids,
        **{key: ranks[r] for r, key in enumerate(TASKS)},
        "temporal": np.stack([np.sin(day), np.cos(day)], 1).astype(np.float32),
        "spatial": rng.normal(size=(n_obs, 3)).astype(np.float32),
        "elevation": rng.normal(size=(n_obs, 10)).astype(np.float32),
    }
    if importlib.util.find_spec("h5py") is not None:
        import h5py

        labels = os.path.join(d, "labels.h5")
        with h5py.File(labels, "w") as f:
            for k, v in datasets.items():
                f.create_dataset(k, data=v)
    else:
        labels = os.path.join(d, "labels.npz")
        write_labels_npz(labels, datasets)
    images = os.path.join(d, "images")
    os.makedirs(images)
    yy, xx = np.mgrid[0:img, 0:img].astype(np.float32) / img
    phase = rng.uniform(0, 1, (n_obs, 3, 4)).astype(np.float32)
    freq = rng.uniform(0.5, 3.0, (n_obs, 3, 2)).astype(np.float32)
    for i in range(n_obs):
        chans = [127 + 60 * np.sin(2 * np.pi * (freq[i, c, 0] * xx + phase[i, c, 0]))
                 + 60 * np.cos(2 * np.pi * (freq[i, c, 1] * yy + phase[i, c, 1]))
                 for c in range(3)]
        pixels = np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)
        Image.fromarray(pixels).save(os.path.join(images, ids[i].decode() + ".jpg"),
                                     quality=90)
    return {"labels": labels, "images": images, "ranks": ranks}


def trainer_yaml(d: str, data: dict) -> str:
    """The experiment: the default config with mFormerV1_sm at IMG px,
    B = BATCH for training and validation, the
    four tasks with null labels (DATA.PARTIAL.LEVELS), hybrid images, a
    0.8 split, TRAINER_EPOCHS epochs, GradNorm every TRAINER_GRADNORM_INTERVAL
    steps, a checkpoint every epoch of which retention keeps the last
    TRAINER_KEEP_LAST, the metadata with elevation on, and the step's
    metrics logged every step; everything else (AutoAugment, jitter,
    erasing, remat 'dots', AdamW on cosine, bf16) at its default."""
    import os

    import yaml

    exp = {
        "EXPERIMENT": {"NAME": "trainer", "PROJECT": "chip_smoke", "GROUP": "phase9"},
        "ENV": {"OUTPUT": {"BASE_DIR": os.path.join(d, "out")}},
        "MODEL": {"BASE": [os.path.abspath("configs/model/archs/mFormerV1_sm.yaml")],
                  "IMG_SIZE": IMG, "USE_FLASH_ATTN": True},
        "DATA": {
            "IMG_SIZE": IMG, "BATCH_SIZE": BATCH, "BATCH_SIZE_VAL": BATCH,
            "TASK_KEYS_H5": list(TASKS), "PARTIAL": {"LEVELS": True},
            "H5": {"LABELS_PATH": data["labels"], "TRAIN_VAL_SPLIT_RATIO": 0.8},
            "HYBRID": {"USE_HYBRID": True, "IMAGES_DIR": data["images"],
                       "FILE_EXTENSION": ".jpg"},
            "META": {"COMPONENTS": {"ELEVATION": {"ENABLED": True, "SOURCE": "elevation"}}},
        },
        "TRAIN": {"EPOCHS": TRAINER_EPOCHS},
        "LOSS": {"GRAD_WEIGHTING": {"TASK": {"UPDATE_INTERVAL": TRAINER_GRADNORM_INTERVAL}}},
        "SCHEDULE": {"CHECKPOINT": {"INTERVAL_EPOCHS": 1, "KEEP_LAST_N": TRAINER_KEEP_LAST},
                     "METRICS": {"CONSOLE_INTERVAL": 1, "WANDB_INTERVAL": 1}},
    }
    path = os.path.join(d, "trainer.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(exp, f)
    return path


def _same_bits(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu()))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_bits(x, y) for x, y in zip(a, b))
    return a == b


@contextlib.contextmanager
def process_handlers_restored():
    """Each Trainer installs process-wide handlers (SIGINT, SIGTERM,
    SIGUSR1, sys.excepthook, an atexit drain: utils/hpc.py). On leaving,
    drain the shutdown registry (at exit it would log after the result
    line) and put back what was there before, so that a signal to the
    later phases ends the process again."""
    import atexit
    import signal

    from linnaeus_tpu_torch.utils.hpc import get_shutdown_registry

    signals = (signal.SIGINT, signal.SIGTERM, signal.SIGUSR1)
    handlers, excepthook = {sig: signal.getsignal(sig) for sig in signals}, sys.excepthook
    try:
        yield
    finally:
        registry = get_shutdown_registry()
        registry.drain()
        atexit.unregister(registry.drain)
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
        sys.excepthook = excepthook


def trainer_phase(dev, card, fa, fm, synthetic_step_ms: float) -> dict:
    """Phase 7c: write a dataset, train it through the CLI
    (``linnaeus_tpu_torch.train.main.main``) for TRAINER_EPOCHS epochs,
    then run the CLI again on the same output directory for
    TRAINER_RESUME_EPOCHS epochs, which must auto-resume and profiles the
    seven steps between two GradNorm updates; the checks and times are
    listed in main. Returns the kernels' launches over both runs."""
    import json as _json
    import os
    import tempfile

    from linnaeus_tpu_torch.data.sampler import build_sampler
    from linnaeus_tpu_torch.native import get_dataplane
    from linnaeus_tpu_torch.train.loop import Trainer
    from linnaeus_tpu_torch.train.main import main as train_main
    from linnaeus_tpu_torch.train.main import parse_option
    from linnaeus_tpu_torch.utils import checkpoint as ckpt

    def counts():
        return {"K1": fa.LAUNCHES, "K1_bwd": fa.BWD_LAUNCHES, "K1_dq": fa.DQ_LAUNCHES,
                "K1_dkv": fa.DKV_LAUNCHES, "K2": fm.LAUNCHES, "K2_bwd": fm.BWD_LAUNCHES}

    def zero():
        fa.LAUNCHES = fa.BWD_LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
        fm.LAUNCHES = fm.BWD_LAUNCHES = 0

    os.makedirs("build", exist_ok=True)
    d = tempfile.mkdtemp(prefix="trainer_", dir="build")
    t0 = time.perf_counter()
    data = write_trainer_dataset(d, np.random.default_rng(SEED + 9))
    write_s = time.perf_counter() - t0
    cfg_path = trainer_yaml(d, data)
    argv = ["--cfg", cfg_path, "--device", str(dev)]
    n_obs, batch = TRAINER_OBS, BATCH
    print(f"trainer phase: {n_obs} observations written in {write_s:.1f} s "
          f"({os.path.basename(data['labels'])}, {IMG} px JPEGs); cut: GradNorm every "
          f"{TRAINER_GRADNORM_INTERVAL} steps (default 100), {TRAINER_EPOCHS} + 1 epochs",
          flush=True)

    # run 1: train from scratch; the loader reads the JPEG directory a batch
    # at a time through the host data plane (phase 7h (e))
    plane = get_dataplane()
    file_batches = plane.file_batches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero()
    t0 = time.perf_counter()
    first = train_main(argv)
    run1_s = time.perf_counter() - t0
    launched = counts()
    bulk_reads = plane.file_batches - file_batches
    check(first.bundle["train_dataset"]._can_bulk_read() and bulk_reads > 0,
          f"the Trainer's loader read through the data plane's bulk path: {bulk_reads} calls")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    steps1 = first.progress.global_step
    spe = first.steps_per_epoch
    n_val = len(first.val_loader) if first.val_loader is not None else 0
    n_gn = sum(t["gradnorm_updates"] for t in first.epoch_timings.values())
    passes = [stage for stage, _ in first.validation_seconds]
    check(spe == int(0.8 * n_obs) // batch and n_val == (n_obs - int(0.8 * n_obs)) // batch,
          f"{spe} train steps and {n_val} val batches an epoch")
    check(steps1 == TRAINER_EPOCHS * spe, f"run 1 took {steps1} steps")
    check(n_gn == steps1 // TRAINER_GRADNORM_INTERVAL, f"{n_gn} GradNorm updates")
    check(first.num_classes == TASKS, f"the heads' widths {first.num_classes}")
    val_forwards = n_val * len(passes)
    want = {k: steps1 * K1_PER_REMAT_STEP.get(k, 0) + n_gn * PER_GRADNORM.get(k, 0)
            for k in launched}
    want["K1"] += val_forwards * K1_PER_FORWARD
    want["K2"] += val_forwards * K2_PER_FORWARD
    print(f"trainer launches over run 1 ({steps1} steps, {n_gn} GradNorm updates, "
          f"{val_forwards} validation forwards): {launched} (expected {want})", flush=True)
    check(launched == want, f"trainer launch counts {launched}, expected {want}")
    log_dir = first.config.ENV.OUTPUT.DIRS.LOGS
    ckpt_dir = first.ckpt_dir

    def step_losses():
        out = {}
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            for line in f:
                row = _json.loads(line)
                if "train/loss" in row:
                    out[row["step"]] = row["train/loss"]
        return out

    losses = step_losses()
    check(sorted(losses) == list(range(1, steps1 + 1))
          and all(np.isfinite(v) for v in losses.values()), f"finite loss at every step: {losses}")

    def every_task(trainer):
        for phase in ("val", "val_mask_meta"):
            summary = trainer.metrics.phase_summary(phase)
            check(all(f"acc1/{t}" in summary and f"loss/{t}" in summary for t in TASKS)
                  and np.isfinite(summary["loss"]), f"{phase} reports every task: {summary}")

    every_task(first)
    check(passes == ["VALIDATION_NORMAL", "VALIDATION_MASK_META"] * TRAINER_EPOCHS,
          f"validation passes {passes}")
    kept = sorted(os.listdir(ckpt_dir))
    want_kept = [ckpt._ckpt_name(s * spe) for s in range(1, TRAINER_EPOCHS + 1)][-TRAINER_KEEP_LAST:]
    check(kept == want_kept, f"checkpoints {kept}, retention keeps {want_kept}")
    saved = ckpt.snapshot_state(first.state)
    timing = [first.epoch_timings[e] for e in range(TRAINER_EPOCHS)]
    pipeline1 = first.train_loader.pipeline_metrics()
    val_s = [round(s, 3) for _, s in first.validation_seconds]
    async_block, async_write = first.ckpt_writer.last_save_seconds, first.ckpt_writer.last_write_seconds
    sync = ckpt.CheckpointWriter(async_save=False)
    sync.save(os.path.join(d, "sync_ckpt"), saved)
    batches_epoch1 = [b.copy() for b in first.train_loader.epoch_indices]
    del first
    gc.collect()
    torch.cuda.empty_cache()

    # the state a resume loads, held to the state run 1 ended with
    args, config = parse_option(argv + ["--opts", "TRAIN.EPOCHS", str(TRAINER_RESUME_EPOCHS)])
    probe = Trainer(config, device=dev)
    check(probe.try_resume(), "a Trainer on the same output directory resumes")
    loaded = ckpt.snapshot_state(probe.state)
    check(_same_bits(loaded, saved), "resumed parameters, optimizer moments, GradNorm state "
          "and generator state equal the saved ones bit for bit")
    probe.close()
    del probe, loaded
    gc.collect()

    # run 2: the CLI again, on the same output directory; torch.profiler
    # over the steps after the first GradNorm update up to the step before
    # the next (steps1 is a multiple of the interval)
    prof_start = steps1 + TRAINER_GRADNORM_INTERVAL
    prof_end = prof_start + TRAINER_GRADNORM_INTERVAL - 1
    t0 = time.perf_counter()
    second = train_main(argv + ["--opts", "TRAIN.EPOCHS", str(TRAINER_RESUME_EPOCHS),
                                "DEBUG.PROFILE.START_STEP", str(prof_start),
                                "DEBUG.PROFILE.END_STEP", str(prof_end)])
    run2_s = time.perf_counter() - t0
    total = counts()
    check(second.resumed_from is not None and second.resumed_from.endswith(
        ckpt._ckpt_name(steps1)), f"run 2 resumed from {second.resumed_from}")
    resumed = second.epoch_timings[TRAINER_RESUME_EPOCHS - 1]
    check(list(second.epoch_timings) == [TRAINER_RESUME_EPOCHS - 1]
          and resumed["first_step"] == steps1 + 1
          and second.progress.global_step == TRAINER_RESUME_EPOCHS * spe,
          f"run 2 took steps {resumed['first_step']}..{second.progress.global_step}")
    sampler = build_sampler(second.config, second.bundle["train_dataset"].labels.group_ids,
                            second.bundle["train_indices"], batch, is_train=True)
    sampler.set_current_group_level(second.ops_schedule.get_mixup_group_level())
    sampler.set_epoch(TRAINER_RESUME_EPOCHS - 1)
    want_batches = sampler.batches()
    got = second.train_loader.epoch_indices
    check(len(got) == len(want_batches) and all(np.array_equal(a, b)
                                                for a, b in zip(got, want_batches))
          and not all(np.array_equal(a, b) for a, b in zip(got, batches_epoch1)),
          "the resumed epoch reads the sampler's batches for its epoch")
    losses = step_losses()
    check(sorted(losses) == list(range(1, TRAINER_RESUME_EPOCHS * spe + 1))
          and all(np.isfinite(v) for v in losses.values()), "finite loss at every resumed step")
    every_task(second)
    kept = sorted(os.listdir(ckpt_dir))
    want_kept = [ckpt._ckpt_name(s * spe)
                 for s in range(1, TRAINER_RESUME_EPOCHS + 1)][-TRAINER_KEEP_LAST:]
    check(kept == want_kept, f"checkpoints after the resume {kept}, retention keeps {want_kept}")
    timing.append(resumed)
    pipeline2 = second.train_loader.pipeline_metrics()
    resume_s = second.resume_seconds
    prof = second.profile_summary
    check(prof is not None and prof["steps"] == prof_end - prof_start,
          f"the profiled window of steps {prof_start + 1}-{prof_end}: {prof}")

    fmt = lambda v: "n/a" if v is None else f"{v:.2f}"  # noqa: E731
    print(f"[{card}] mFormerV1_sm {IMG}px B={batch} bf16 through the Trainer (the CLI, "
          f"hybrid JPEGs, default config): step under the Trainer "
          + ", ".join(f"epoch {e}: median {fmt(t['median_step_ms'])} ms, event span "
                      f"{fmt(t['median_event_span_ms'])} ms (the device's waits for the "
                      f"host included), span share {fmt(t['event_span_share'])}, wall "
                      f"{fmt(t['wall_s'])} s"
                      for e, t in enumerate(timing))
          + f" (phase 7b's synthetic-batch step: {fmt(synthetic_step_ms)} ms); "
          f"under torch.profiler, steps {prof_start + 1}-{prof_end} of epoch "
          f"{TRAINER_RESUME_EPOCHS - 1}: {prof['wall_ms_per_step']:.2f} ms a step, device "
          f"busy {prof['device_busy_ms_per_step']:.2f} ms, device-busy share "
          f"{1.0 - prof['idle_share']:.3f}; loader "
          f"{pipeline1['throughput_samples_per_sec']:.1f} img/s, wait "
          f"{pipeline1['avg_wait_ms']:.2f} ms a batch (run 1's last epoch, cache warm), "
          f"{pipeline2['throughput_samples_per_sec']:.1f} img/s, wait "
          f"{pipeline2['avg_wait_ms']:.2f} ms (the resumed epoch, cache cold); peak memory "
          f"{fmt(peak)} GiB; validation passes {val_s} s; checkpoint save held the loop "
          f"{async_block:.3f} s (async), its file {fmt(async_write)} s, a sync save "
          f"{sync.last_save_seconds:.3f} s; resume {resume_s:.3f} s; runs {run1_s:.1f} + "
          f"{run2_s:.1f} s", flush=True)
    print(f"[{card}] phase 7h(e): run 1 of the CLI read its JPEG directory through the data "
          f"plane's bulk path in {bulk_reads} batch calls; the loader's wait "
          f"{pipeline1['avg_wait_ms']:.2f} ms a batch, the step under the Trainer "
          + ", ".join(f"{fmt(t['median_step_ms'])}" for t in timing) + " ms (epochs 0, 1, 2)",
          flush=True)
    del second
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": total, "run1_launches": launched, "timing": timing,
            "bulk_reads": bulk_reads,
            "pipeline": [pipeline1, pipeline2], "peak_gib": peak, "validation_s": val_s,
            "resume_s": resume_s, "profile": prof, "dir": d, "data": data,
            "yaml": cfg_path}


# phase 7d: from pretrained files to a served bundle
PRETRAINED_MEMORY_FRACTION = 0.10  # cut: AutoBatch's budget, 8 GB of the card's 80
PRETRAINED_BOUNDS, PRETRAINED_BOUNDS_VAL = (16, 512), (16, 256)
PRETRAINED_CLIENTS, PRETRAINED_REQUESTS, PRETRAINED_IMAGES = 8, 2, 4


def write_pretrained_files(d: str, seed: int) -> tuple[str, str]:
    """Two checkpoints in the official layouts from a seeded generator,
    every tensor with values of its own: ConvNeXt-Tiny (depths 3, 3, 9, 3;
    dims 96, 192, 384, 768; wrapped as {"model": ...}) and a RoPE-Mixed
    DeiT-Small (12 blocks of 384, 6 heads, per-block ``attn.freqs``).
    Weights are 0.02 x normal, LayerNorm scales 1 + that, layer scales
    0.1 x normal, so the stitched model trains as a pretrained one would."""
    import os

    g = torch.Generator().manual_seed(seed)

    def t(*shape, kind="weight"):
        offset, scale = {"weight": (0.0, 0.02), "norm": (1.0, 0.02), "gamma": (0.0, 0.1),
                         "freqs": (0.0, 0.5)}[kind]
        return offset + scale * torch.randn(*shape, generator=g)

    dims, depths = (96, 192, 384, 768), (3, 3, 9, 3)
    cn = {"downsample_layers.0.0.weight": t(96, 3, 4, 4), "downsample_layers.0.0.bias": t(96),
          "downsample_layers.0.1.weight": t(96, kind="norm"), "downsample_layers.0.1.bias": t(96)}
    for i in (1, 2, 3):
        cn.update({f"downsample_layers.{i}.0.weight": t(dims[i - 1], kind="norm"),
                   f"downsample_layers.{i}.0.bias": t(dims[i - 1]),
                   f"downsample_layers.{i}.1.weight": t(dims[i], dims[i - 1], 2, 2),
                   f"downsample_layers.{i}.1.bias": t(dims[i])})
    for s, (dim, depth) in enumerate(zip(dims, depths)):
        for j in range(depth):
            p = f"stages.{s}.{j}"
            cn.update({f"{p}.dwconv.weight": t(dim, 1, 7, 7), f"{p}.dwconv.bias": t(dim),
                       f"{p}.norm.weight": t(dim, kind="norm"), f"{p}.norm.bias": t(dim),
                       f"{p}.pwconv1.weight": t(4 * dim, dim), f"{p}.pwconv1.bias": t(4 * dim),
                       f"{p}.pwconv2.weight": t(dim, 4 * dim), f"{p}.pwconv2.bias": t(dim),
                       f"{p}.gamma": t(dim, kind="gamma")})
    cn.update({"norm.weight": t(768, kind="norm"), "norm.bias": t(768),
               "head.weight": t(1000, 768), "head.bias": t(1000)})
    dim, rv = 384, {"cls_token": t(1, 1, 384), "patch_embed.proj.weight": t(384, 3, 16, 16)}
    for i in range(12):
        p = f"blocks.{i}"
        rv.update({f"{p}.norm1.weight": t(dim, kind="norm"), f"{p}.norm1.bias": t(dim),
                   f"{p}.attn.qkv.weight": t(3 * dim, dim), f"{p}.attn.qkv.bias": t(3 * dim),
                   f"{p}.attn.proj.weight": t(dim, dim), f"{p}.attn.proj.bias": t(dim),
                   f"{p}.attn.freqs": t(2, 6, 32, kind="freqs"),
                   f"{p}.norm2.weight": t(dim, kind="norm"), f"{p}.norm2.bias": t(dim),
                   f"{p}.mlp.fc1.weight": t(4 * dim, dim), f"{p}.mlp.fc1.bias": t(4 * dim),
                   f"{p}.mlp.fc2.weight": t(dim, 4 * dim), f"{p}.mlp.fc2.bias": t(dim)})
    paths = os.path.join(d, "convnext_tiny.pth"), os.path.join(d, "rope_mixed_deit_small.pth")
    torch.save({"model": cn}, paths[0])
    torch.save({"model": rv, "epoch": 300}, paths[1])
    return paths


def pretrained_phase(dev, card, fa, fm, trainer: dict) -> dict:
    """Phase 7d, on phase 7c's dataset: the example experiment
    (configs/experiments/generic_mformer_example.yaml: stitched init,
    ConditionalClassifier heads, the heads' group at 10x, GradNorm, AutoAugment)
    through the CLI's own construction (``train.main.build_trainer``) from
    seeded pretrained files, with AutoBatch for the train and validation
    batches; checks the pretrained weights bit for bit before the first step,
    the reports against the same mapping on the CPU, the search's peak (a
    train trial's steps and one GradNorm update) against its budget and
    BASE_LR's scaling; trains one epoch, its peak within the budget too;
    builds the run again, which resumes at the checkpoint's batches and base
    LR without a search; bundles the
    last checkpoint with ``tools/prepare_inference_bundle`` and serves it
    (logits bit for bit against the checkpoint's model, 64 validation JPEGs,
    HTTP); then ``--throughput`` and ``inspect_checkpoints``. Returns the
    kernels' launches and the measurements."""
    import base64
    import os
    import threading
    import urllib.request

    import yaml

    from linnaeus_tpu_torch.inference.handler import LinnaeusInferenceHandler
    from linnaeus_tpu_torch.inference.preprocessing import preprocess_image_batch
    from linnaeus_tpu_torch.models.build import build_model
    from linnaeus_tpu_torch.tools.inspect_checkpoints import inspect_checkpoint
    from linnaeus_tpu_torch.tools.prepare_inference_bundle import prepare_bundle
    from linnaeus_tpu_torch.tools.serve import make_server
    from linnaeus_tpu_torch.tools.serve_latency_bench import percentile
    from linnaeus_tpu_torch.train.main import build_trainer
    from linnaeus_tpu_torch.train.main import main as train_main
    from linnaeus_tpu_torch.utils import checkpoint as ckpt
    from linnaeus_tpu_torch.utils import pretrained as tpre

    def counts():
        return {"K1": fa.LAUNCHES, "K1_bwd": fa.BWD_LAUNCHES, "K2": fm.LAUNCHES,
                "K2_bwd": fm.BWD_LAUNCHES}

    # the example's MODEL.BASE names its preset relative to $CONFIG_DIR, the
    # repository's root, from which this script runs
    os.environ.setdefault("CONFIG_DIR", os.getcwd())
    d = trainer["dir"]
    t0 = time.perf_counter()
    cn_path, rv_path = write_pretrained_files(d, SEED + 20)
    write_s = time.perf_counter() - t0
    data = trainer["data"]
    lo, hi = PRETRAINED_BOUNDS
    lo_val, hi_val = PRETRAINED_BOUNDS_VAL
    argv = ["--cfg", os.path.abspath("configs/experiments/generic_mformer_example.yaml"),
            "--device", str(dev), "--opts",
            "MODEL.PRETRAINED_CONVNEXT", cn_path, "MODEL.PRETRAINED_ROPEVIT", rv_path,
            "MODEL.IMG_SIZE", str(IMG), "MODEL.USE_FLASH_ATTN", "True",
            "DATA.IMG_SIZE", str(IMG), "DATA.H5.LABELS_PATH", data["labels"],
            "DATA.H5.IMAGES_PATH", "", "DATA.H5.TRAIN_VAL_SPLIT_RATIO", "0.8",
            "DATA.HYBRID.USE_HYBRID", "True", "DATA.HYBRID.IMAGES_DIR", data["images"],
            "DATA.HYBRID.FILE_EXTENSION", ".jpg", "DATA.NATIVE_DATAPLANE", "off",
            "DATA.AUTOBATCH.ENABLED", "True", "DATA.AUTOBATCH.ENABLED_VAL", "True",
            "DATA.AUTOBATCH.TARGET_MEMORY_FRACTION", str(PRETRAINED_MEMORY_FRACTION),
            "DATA.AUTOBATCH.TARGET_MEMORY_FRACTION_VAL", str(PRETRAINED_MEMORY_FRACTION),
            "DATA.AUTOBATCH.MIN_BATCH_SIZE", str(lo), "DATA.AUTOBATCH.MAX_BATCH_SIZE", str(hi),
            "DATA.AUTOBATCH.MIN_BATCH_SIZE_VAL", str(lo_val),
            "DATA.AUTOBATCH.MAX_BATCH_SIZE_VAL", str(hi_val),
            "TRAIN.EPOCHS", "1", "ENV.OUTPUT.BASE_DIR", os.path.join(d, "out_pretrained"),
            "SCHEDULE.METRICS.CONSOLE_INTERVAL", "1", "SCHEDULE.METRICS.WANDB_INTERVAL", "1"]
    print(f"pretrained phase: two seeded checkpoints in the official layouts written in "
          f"{write_s:.1f} s; cuts: AutoBatch's budget {PRETRAINED_MEMORY_FRACTION} of the "
          f"card's memory (train bounds {PRETRAINED_BOUNDS}, validation "
          f"{PRETRAINED_BOUNDS_VAL}), 1 epoch of phase 7c's {TRAINER_OBS} observations",
          flush=True)

    fa.LAUNCHES = fa.BWD_LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
    fm.LAUNCHES = fm.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    run = build_trainer(argv)
    build_s = time.perf_counter() - t0
    cfg = run.config
    reports = run.pretrained_reports
    # every mapped tensor holds its source's bits before the first step (the
    # AutoBatch trials ran real steps and must have been undone)
    sources = {**tpre.load_torch_state_dict(cn_path), **tpre.load_torch_state_dict(rv_path)}
    depths = tuple(len(stage) for stage in run.model.stages)
    entries = dict((dst, src) for src, dst in tpre.convnext_entries(depths[:2])
                   + tpre.ropevit_entries(tpre.load_torch_state_dict(rv_path), depths[2:]))
    weights = run.model.state_dict()
    loaded = reports["ConvNeXt"]["loaded"] + reports["RoPE-ViT"]["loaded"]
    check(all(torch.equal(weights[k].cpu(), sources[entries[k]]) for k in loaded),
          "every mapped tensor equals its source tensor bit for bit before the first step")
    check(all(torch.equal(run.state.ema_params[k], weights[k]) for k in loaded)
          if run.state.ema_params is not None else True, "the EMA starts from the loaded weights")
    cpu_model = build_model(cfg, run.num_classes, run.taxonomy_tree, device="cpu", seed=SEED)
    cpu_reports = tpre.load_pretrained(cfg, cpu_model)
    del cpu_model
    check(cpu_reports == reports, "the reports equal the same mapping's on the CPU")
    tally = {name: {k: len(v) for k, v in r.items()} for name, r in reports.items()}
    ab, ab_val = run.autobatch["train"], run.autobatch["val"]
    # the train budget falls between the bounds; the validation step keeps
    # no activations for a backward, so its largest batch may fit whole
    for name, rec, bounds in (("train", ab, PRETRAINED_BOUNDS), ("val", ab_val,
                                                                 PRETRAINED_BOUNDS_VAL)):
        found, trials, budget = rec["found"], rec["trials"], rec["budget_bytes"]
        larger = [bs for bs in trials if bs > found]
        check(bounds[0] < found < bounds[1] or (name == "val" and found == bounds[1]),
              f"AutoBatch ({name}) chose {found} inside {bounds}")
        check(trials[found] is not None and trials[found] <= budget,
              f"AutoBatch ({name}): the peak at {found} is within the budget: {trials}")
        check(found == bounds[1] or (trials[min(larger)] is None or trials[min(larger)] > budget),
              f"AutoBatch ({name}): the next larger trial exceeded the budget: {trials}")
    check(ab["base_lr_after"] == ab["base_lr_before"] * (ab["found"] / ab["batch_before"]),
          f"BASE_LR scaled once by {ab['found']} / {ab['batch_before']}: {ab}")
    check(cfg.DATA.BATCH_SIZE == ab["found"] and cfg.DATA.BATCH_SIZE_VAL == ab_val["found"],
          "the loaders use the batches AutoBatch chose")
    gib = 2.0**30
    ab_steps = int(cfg.DATA.AUTOBATCH.STEPS_PER_TRIAL)
    check(run._gradnorm_update is not None, "the example experiment runs GradNorm, which "
          "AutoBatch's train trials probe")
    print(f"[{card}] the example experiment built by the CLI in {build_s:.1f} s: pretrained "
          f"reports {tally} (the same on the CPU); AutoBatch (train: {ab_steps} steps and one "
          f"GradNorm update a trial, {run.train_loader.device_prefetch_depth} batches ahead "
          f"resident, {ab['seconds']:.1f} s): "
          f"budget {ab['budget_bytes'] / gib:.2f} GiB, trials "
          + ", ".join(f"{bs}: {'OOM' if b is None else '%.2f GiB' % (b / gib)}"
                      for bs, b in ab["trials"].items())
          + f" -> B={ab['found']} (configured {ab['batch_before']}), BASE_LR "
          f"{ab['base_lr_before']:.4e} -> {ab['base_lr_after']:.4e}; AutoBatch (val, "
          f"{ab_val['seconds']:.1f} s): trials "
          + ", ".join(f"{bs}: {'OOM' if b is None else '%.2f GiB' % (b / gib)}"
                      for bs, b in ab_val["trials"].items())
          + f" -> B={ab_val['found']}", flush=True)

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        run.train()
    finally:
        run.close()
    train_s = time.perf_counter() - t0
    epoch_peak = torch.cuda.max_memory_allocated(dev)
    losses = {}
    with open(os.path.join(cfg.ENV.OUTPUT.DIRS.LOGS, "metrics.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            if "train/loss" in row:
                losses[row["step"]] = row["train/loss"]
    check(sorted(losses) == list(range(1, run.steps_per_epoch + 1))
          and all(np.isfinite(v) for v in losses.values()), f"finite loss at every step {losses}")
    summary = run.metrics.phase_summary("val")
    check(np.isfinite(summary["loss"]), f"validation after the pretrained epoch: {summary}")
    timing = run.epoch_timings[0]
    check(epoch_peak <= ab["budget_bytes"], f"the epoch's peak {epoch_peak} B is within "
          f"AutoBatch's budget {ab['budget_bytes']} B")
    print(f"[{card}] one epoch of {run.steps_per_epoch} steps at B={ab['found']} in "
          f"{train_s:.1f} s (median step {timing['median_step_ms']:.1f} ms, a smoke reading of "
          f"{run.steps_per_epoch} steps, the first cold; peak {epoch_peak / gib:.2f} GiB, "
          f"{timing['gradnorm_updates']} GradNorm updates, budget "
          f"{ab['budget_bytes'] / gib:.2f} GiB); losses "
          f"{[round(losses[s], 4) for s in sorted(losses)]}; validation loss "
          f"{summary['loss']:.4f}", flush=True)

    # a new process of the same run resumes: no search, the checkpoint's
    # batches and base LR (a search reads peaks that move with what else the
    # process holds)
    last = ckpt.auto_resume_helper(run.ckpt_dir)
    t0 = time.perf_counter()
    again = build_trainer(argv)
    again_s = time.perf_counter() - t0
    try:
        check(again.autobatch["train"].get("resumed_from") == last
              and "trials" not in again.autobatch["train"]
              and "trials" not in again.autobatch["val"], f"no search on resume: {again.autobatch}")
        check((again.config.DATA.BATCH_SIZE, again.config.DATA.BATCH_SIZE_VAL,
               again.config.LR_SCHEDULER.BASE_LR, again.steps_per_epoch)
              == (ab["found"], ab_val["found"], ab["base_lr_after"], run.steps_per_epoch),
              "the resumed run's batches, base LR and schedule are the checkpoint's")
        check(again.pretrained_reports == {}, "resume wins over pretrained init")
    finally:
        again.close()
    del again
    print(f"the run built again in {again_s:.1f} s resumes from {os.path.basename(last)} at "
          f"B={ab['found']} / {ab_val['found']}, BASE_LR {ab['base_lr_after']:.4e}, without a "
          f"search", flush=True)

    # bundle the last checkpoint and serve it
    bundle_dir = os.path.join(d, "bundle")
    t0 = time.perf_counter()
    prepare_bundle(last, cfg.ENV.OUTPUT.DIRS.ASSETS, bundle_dir, "mFormerV1_sm",
                   list(TASKS), [run.num_classes[t] for t in TASKS], image_size=IMG)
    bundle_s = time.perf_counter() - t0
    # what a user adds to the tool's config for a model that is not the
    # bare preset: the variant (the run's MODEL section: its heads, K1 on)
    # and the serving batch
    variant = os.path.join(bundle_dir, "variant.yaml")
    model_cfg = json.loads(json.dumps(cfg.MODEL))
    for key in ("PRETRAINED_CONVNEXT", "PRETRAINED_ROPEVIT", "PRETRAINED_SOURCE"):
        model_cfg.pop(key, None)
    with open(variant, "w") as f:
        yaml.safe_dump({"MODEL": model_cfg, "TRAIN": {
            "MIXED_PRECISION": json.loads(json.dumps(cfg.TRAIN.MIXED_PRECISION))}}, f)
    with open(os.path.join(bundle_dir, "config.yaml")) as f:
        bundle_cfg = yaml.safe_load(f)
    bundle_cfg["model"]["architecture_variant_config_path"] = variant
    bundle_cfg["inference_options"]["batch_size"] = BATCH
    with open(os.path.join(bundle_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(bundle_cfg, f, sort_keys=False)
    t0 = time.perf_counter()
    handler = LinnaeusInferenceHandler.load_from_artifacts(os.path.join(bundle_dir, "config.yaml"))
    load_s = time.perf_counter() - t0
    direct = build_model(cfg, run.num_classes, run.taxonomy_tree, device=dev, seed=SEED + 1)
    direct.load_state_dict(torch.load(os.path.join(last, ckpt.STATE_DIR, ckpt.STATE_FILE),
                                      map_location="cpu", weights_only=True)["model"])
    direct.eval()
    ids = run.bundle["val_dataset"].labels.img_identifiers
    jpegs = []
    for i in run.bundle["val_indices"][:BATCH]:
        with open(os.path.join(data["images"], f"{ids[i]}.jpg"), "rb") as f:
            jpegs.append(f.read())
    pixels = torch.from_numpy(preprocess_image_batch(jpegs, handler.config)).to(dev)
    aux_dim = handler.config.aux_vector_length()
    aux = torch.randn(BATCH, aux_dim, generator=torch.Generator(device=dev).manual_seed(SEED),
                      device=dev)
    x = (pixels.float() / 255.0 - handler._mean) / handler._std
    with torch.inference_mode():
        a, b = handler.model(x, aux), direct(x, aux)
    check(all(torch.equal(a[t], b[t]) for t in TASKS),
          "the bundle's logits equal the checkpoint's model's bit for bit")
    del direct
    results = handler.predict(jpegs)
    taxonomy, maps = handler.taxonomy, handler.class_maps
    nulled = check_results(results, BATCH, taxonomy, maps)
    print(f"bundle written in {bundle_s:.1f} s, loaded in {load_s:.1f} s; its logits equal the "
          f"checkpoint's model's bit for bit on {BATCH} validation JPEGs; every result obeys "
          f"the tree (the pass nulled {nulled})", flush=True)
    host_ms = predict_breakdown(handler, jpegs, None, card)

    handler.warmup()
    server = make_server(handler, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    n_req = PRETRAINED_CLIENTS * PRETRAINED_REQUESTS
    bodies = [{"instances": [{"image": base64.b64encode(jpegs[(r * PRETRAINED_IMAGES + i)
                                                              % BATCH]).decode()}
                             for i in range(PRETRAINED_IMAGES)]} for r in range(n_req)]
    latencies, answers, errors = [], [None] * n_req, []
    lock = threading.Lock()

    def client(c):
        for r in range(c * PRETRAINED_REQUESTS, (c + 1) * PRETRAINED_REQUESTS):
            req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                         data=json.dumps(bodies[r]).encode(),
                                         headers={"Content-Type": "application/json"})
            t1 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=120) as resp:
                    answers[r] = json.loads(resp.read())
            except Exception as e:  # noqa: BLE001 counted and failed below
                with lock:
                    errors.append(repr(e))
                continue
            with lock:
                latencies.append(1e3 * (time.perf_counter() - t1))

    try:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(PRETRAINED_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.stop()
    check(not errors, f"HTTP errors: {errors[:3]}")
    for answer in answers:
        check_results([as_result(p) for p in answer["predictions"]], PRETRAINED_IMAGES,
                      taxonomy, maps)
    lat = sorted(latencies)
    http = {"requests_per_s": n_req / wall, "images_per_s": n_req * PRETRAINED_IMAGES / wall,
            "p50_ms": percentile(lat, 50), "p99_ms": percentile(lat, 99)}
    print(f"[{card}] HTTP serving of the trained bundle (the data plane's decode; a smoke "
          f"reading, too few requests for a rate), {PRETRAINED_CLIENTS} "
          f"clients x {PRETRAINED_REQUESTS} requests x {PRETRAINED_IMAGES} JPEGs: "
          f"{http['requests_per_s']:.2f} req/s ({http['images_per_s']:.1f} img/s), p50 "
          f"{http['p50_ms']:.1f} ms, p99 {http['p99_ms']:.1f} ms", flush=True)
    del handler, server
    gc.collect()
    torch.cuda.empty_cache()

    # the tools: --throughput of phase 7c's experiment and the checkpoint
    tput = train_main(["--cfg", trainer["yaml"], "--device", str(dev), "--throughput", "--opts",
                       "MODEL.NUM_CLASSES", str(list(TASKS.values())),
                       "ENV.OUTPUT.BASE_DIR", os.path.join(d, "out_throughput")])
    check(all(np.isfinite(r["images_per_sec"]) and r["images_per_sec"] > 0
              for r in tput.values()), f"--throughput {tput}")
    print(f"[{card}] --throughput (mFormerV1_sm {IMG}px bf16, K1 on, fresh normal inputs a "
          f"batch): " + ", ".join(f"B={bs}: {r['images_per_sec']:.1f} img/s, "
                                  f"{r['latency_ms']:.2f} ms" for bs, r in tput.items()),
          flush=True)
    info = inspect_checkpoint(last, show_params=True)
    n_params = sum(p.numel() for p in run.model.parameters())
    check(info["step"] == run.progress.global_step and info["num_params"] == n_params,
          f"inspect_checkpoints: step {info['step']}, {info['num_params']} parameters")
    print(f"inspect_checkpoints: {os.path.basename(last)} at step {info['step']}, epoch "
          f"{info['epoch']}, {info['num_params']} parameters in {len(info['tree'])} tensors",
          flush=True)
    launched = counts()
    for key in ("K1", "K1_bwd", "K2", "K2_bwd"):
        check(launched[key] > 0, f"{key} was not launched from pretrained weights to a bundle")
    print(f"launches over phase 7d: {launched}", flush=True)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launched, "autobatch": {"train": ab, "val": ab_val},
            "reports": tally, "http": http, "host_ms": host_ms, "throughput": tput,
            "build_s": build_s, "train_s": train_s, "epoch_peak_bytes": epoch_peak}


# phase 7i: more than one GPU (parallel/), run at world size 1 over NCCL, the
# card being one H100: NCCL refuses two ranks on one card
MULTI_STEPS = 8
MULTI_PROFILE = (4, 6)  # DEBUG.PROFILE window: steps 5-6


def multi_yaml(d: str, trainer: dict, name: str) -> str:
    """Phase 7c's experiment (mFormerV1_sm at IMG px, B = BATCH, bf16, the
    default config) cut to MULTI_STEPS steps of one epoch, GradNorm every 4,
    a checkpoint at the end, a profiled window, under ``d/name``."""
    import os

    import yaml

    with open(trainer["yaml"]) as f:
        exp = yaml.safe_load(f)
    exp["EXPERIMENT"]["NAME"] = name
    exp["ENV"]["OUTPUT"]["BASE_DIR"] = os.path.join(d, "out")
    exp["TRAIN"]["EPOCHS"] = 1
    exp["LOSS"]["GRAD_WEIGHTING"]["TASK"]["UPDATE_INTERVAL"] = 4
    exp["DEBUG"] = {"EARLY_EXIT_AFTER_N_OPTIMIZER_STEPS": MULTI_STEPS,
                    "PROFILE": {"START_STEP": MULTI_PROFILE[0], "END_STEP": MULTI_PROFILE[1]}}
    path = os.path.join(d, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(exp, f)
    return path


def _run_rows(run_dir: str) -> tuple[dict, dict, dict | None]:
    """(loss by step, pre-clip norm by step, the profiled window) of a run's
    logs."""
    import ast
    import os

    losses, norms, prof, timing = {}, {}, None, None
    with open(os.path.join(run_dir, "logs", "metrics.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            if "train/loss" in row:
                losses[row["step"]] = row["train/loss"]
                norms[row["step"]] = row["train/grad_norm_pre_clip"]
    with open(os.path.join(run_dir, "logs", "main_p0.log")) as f:
        for line in f:
            if "profiled steps" in line:
                prof = ast.literal_eval(line[line.index("{", line.index("profiled steps")):])
            if "timing {" in line:
                timing = json.loads(line[line.index("timing {") + len("timing "):])
    return losses, norms, {"profile": prof, "timing": timing}


CHILD_COUNTS = "train child launches: "


def kernel_counts(fa, fm) -> dict:
    return {"K1": fa.LAUNCHES, "K1_bwd": fa.BWD_LAUNCHES, "K1_dq": fa.DQ_LAUNCHES,
            "K1_dkv": fa.DKV_LAUNCHES, "K2": fm.LAUNCHES, "K2_bwd": fm.BWD_LAUNCHES}


def train_child(argv: list[str]) -> int:
    """``chip_smoke.py --train-child <training CLI arguments>``, started by
    torch.distributed.run in phase 7i: the training CLI in this process with
    the kernels' counts set to 0 just before it; after the run each rank
    prints, on a line that starts with CHILD_COUNTS, its rank, the process
    group's backend, whether FSDP2 wrapped the model and in how many units
    (each block and the root), and its counts."""
    import os

    import torch.distributed as dist

    import linnaeus_tpu_torch.ops.flash_attention as fa
    import linnaeus_tpu_torch.ops.fused_mlp as fm
    from linnaeus_tpu_torch.train.main import main as train_main

    fa.LAUNCHES = fa.BWD_LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
    fm.LAUNCHES = fm.BWD_LAUNCHES = 0
    run = train_main(argv)
    from torch.distributed.fsdp import FSDPModule

    from linnaeus_tpu_torch.parallel.model import fsdp_units

    row = {"rank": int(os.environ.get("RANK", "0")),
           "backend": dist.get_backend() if dist.is_initialized() else None,
           "fsdp": hasattr(next(run.model.parameters()), "to_local"),
           "fsdp_units": sum(isinstance(m, FSDPModule) for m in run.model.modules()),
           "blocks_and_root": len(fsdp_units(run.model)),
           "launches": kernel_counts(fa, fm)}
    print(CHILD_COUNTS + json.dumps(row), flush=True)
    return 0


def _torchrun(cfg_path: str, extra: list[str], nproc: int = 1, timeout: int = 300):
    """``python -m torch.distributed.run --standalone`` of the training CLI
    (through :func:`train_child`); returns (seconds, exit code, the tail of
    its output, each rank's CHILD_COUNTS line by rank)."""
    import os
    import subprocess

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), os.path.abspath(__file__), "--train-child",
           "--cfg", cfg_path] + extra
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    counts = {}
    for line in run.stdout.splitlines():
        if CHILD_COUNTS in line:
            row = json.loads(line[line.index(CHILD_COUNTS) + len(CHILD_COUNTS):])
            counts[row.pop("rank")] = row
    return secs, run.returncode, (run.stdout + run.stderr)[-3000:], counts


def gloo_cuda_probe() -> str | None:
    """Whether this machine's gloo takes CUDA tensors for every collective
    the train step uses (all_gather_into_tensor, all_reduce, broadcast,
    all_gather_object): two processes on the one card; None when it does,
    else the error."""
    import subprocess

    code = r"""
import os, sys, torch, torch.distributed as dist
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="file://" + sys.argv[2], rank=rank, world_size=2)
dev = torch.device("cuda", 0)
x = torch.full((4,), float(rank + 1), device=dev)
out = torch.empty(8, device=dev)
dist.all_gather_into_tensor(out, x)
dist.all_reduce(x)
dist.broadcast(x, src=0)
objs = [None, None]
dist.all_gather_object(objs, {"r": rank})
assert out.is_cuda and float(x[0]) == 3.0 and objs == [{"r": 0}, {"r": 1}], (out, x, objs)
dist.destroy_process_group()
"""
    import tempfile

    store = tempfile.mktemp(prefix="gloo_store_", dir="build")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), store],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            return "the probe did not finish in 120 s"
    bad = [o for p, o in zip(procs, outs) if p.returncode != 0]
    return bad[0][-800:] if bad else None


# the port's shard_plan for mFormerV1_sm at IMG px, 64 rows a data rank:
# (mode, mesh, global batch, microbatches). pp: the stage count is the model
# axis and must divide stage 3's depth, which is 5 in mFormerV1_sm; 8
# microbatches (at least the stage count, dividing 64)
SHARD_PLANS = (("dp", {"data": 8}, 512, 0), ("fsdp", {"data": 8}, 512, 0),
               ("tp", {"data": 4, "model": 2}, 256, 0), ("pp", {"data": 4, "model": 5}, 256, 8))


def shard_plan_phase(dev, card) -> dict:
    """tools/shard_plan.py for each of SHARD_PLANS: rank 0's bytes, its
    step's collectives over the fake process group, the partner rows it
    fetches at each mixup group level of the default config and the steps'
    peak on the card. Checks the two data-parallel repairs: no image row is
    all-gathered under dp (a rank takes only its mixing partners' rows, by
    all-to-all), and FSDP2's largest gather is one unit's (a block), not the
    model's."""
    import torch.distributed as dist

    from linnaeus_tpu_torch.tools.shard_plan import build_plan

    check(not dist.is_initialized(), "shard_plan needs this process without a process group")
    t_phase = time.perf_counter()
    row = IMG * IMG * 3  # one uint8 image
    plans = {}
    for mode, mesh, batch, micro in SHARD_PLANS:
        t0 = time.perf_counter()
        p = build_plan("mFormerV1_sm", mesh, mode, batch, IMG, device=str(dev),
                       microbatches=micro)
        census = p["collectives_per_step"]
        print(f"[{card}] shard_plan mFormerV1_sm {IMG}px {mode} {mesh} global batch {batch}: "
              f"parameters {p['param_bytes_per_device'] / 1e6:.2f} of "
              f"{p['param_bytes_total'] / 1e6:.2f} MB a rank ({p['params_sharded']} of "
              f"{p['params_total_leaves']} leaves sharded), optimizer "
              f"{p['opt_ema_bytes_per_device'] / 1e6:.2f} MB; the step's peak "
              f"{p['memory_analysis']['per_device_total'] / 2**30:.3f} GiB; collectives "
              f"{json.dumps(census)}"
              + (f"; largest FSDP2 unit {p['largest_unit_bytes'] / 1e6:.2f} MB"
                 if mode == "fsdp" else "")
              + "; partner rows fetched a step by mixup group level (the census is "
              f"{p['group_level']}'s): "
              + ", ".join(f"{lvl} {v['rows']} ({v['bytes'] / 1e6:.2f} MB)"
                          for lvl, v in p["partner_fetch"].items())
              + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
        plans[mode] = p
        gc.collect()
        torch.cuda.empty_cache()
    dp = plans["dp"]["collectives_per_step"]
    check(dp["all-gather"]["bytes"] < row, f"dp all-gathers {dp['all-gather']['bytes']} bytes: "
          "image rows")
    check(dp.get("all-to-all", {"bytes": 0})["bytes"] % row == 0,
          "dp's partner fetch moves whole image rows")
    fetch = plans["dp"]["partner_fetch"]
    check(all(v["rows"] <= plans["dp"]["batch_per_device"] for v in fetch.values()),
          f"dp fetches at most a partner a row of its own: {fetch}")
    fsdp = plans["fsdp"]
    check(fsdp["collectives_per_step"]["all-gather"]["max_bytes"] <= fsdp["largest_unit_bytes"]
          < fsdp["param_bytes_total"], "FSDP2's largest gather is one unit's")
    for mode in ("send", "recv"):
        check(plans["pp"]["collectives_per_step"].get(mode, {"count": 0})["count"] > 0,
              f"pp's {mode}")
    print(f"shard_plan phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return plans


def multi_phase(dev, card, fa, fm, trainer: dict) -> dict:
    """Phase 7i (module docstring): (a) the CLI under torch.distributed.run at
    world size 1 over NCCL with PARAM_SHARDING 'replicated' and 'fsdp' against
    the one-process CLI on the same config and seed, each run's kernel
    launches counted in its own process; (b) the fsdp run's
    checkpoint through the handler against the one-process checkpoint's, and
    resumed in a one-process Trainer; the handler's data_parallel rule;
    (c) two ranks on the one card over gloo, after a probe; (d) the
    complexity estimator on mFormerV1_sm at IMG px; (e) F10: K1's backward
    twice on the same operands, and its time. Returns the kernels' launches
    by run ('one', 'replicated', 'fsdp')."""
    import os
    import shutil
    import tempfile

    import yaml

    from linnaeus_tpu_torch.evaluation.complexity import estimate_all_archs
    from linnaeus_tpu_torch.inference.handler import LinnaeusInferenceHandler
    from linnaeus_tpu_torch.tools.prepare_inference_bundle import prepare_bundle
    from linnaeus_tpu_torch.train.loop import Trainer
    from linnaeus_tpu_torch.train.main import main as train_main
    from linnaeus_tpu_torch.train.main import parse_option
    from linnaeus_tpu_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    d = tempfile.mkdtemp(prefix="multi_", dir="build")
    runs = {}
    fmt = lambda v: "n/a" if v is None else f"{v:.2f}"  # noqa: E731

    def run_dir(name):
        return os.path.join(d, "out", "chip_smoke", "phase9", name)

    # (a) the one-process CLI in this process, then the same config under
    # torch.distributed.run, replicated and fsdp; each run's kernel launches
    # are counted from 0 in the process that makes them (the children's by
    # train_child)
    fa.LAUNCHES = fa.BWD_LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
    fm.LAUNCHES = fm.BWD_LAUNCHES = 0
    one_yaml = multi_yaml(d, trainer, "one")
    t0 = time.perf_counter()
    one = train_main(["--cfg", one_yaml, "--device", str(dev)])
    runs["one"] = time.perf_counter() - t0
    launched = {"one": kernel_counts(fa, fm)}
    del one
    gc.collect()
    torch.cuda.empty_cache()
    rows = {"one": _run_rows(run_dir("one"))}
    child_rows = {}
    for mode in ("replicated", "fsdp"):
        cfg_path = multi_yaml(d, trainer, mode)
        # MULTI_HOST: at world size 1 the process group starts only when asked
        secs, rc, tail, ranks = _torchrun(cfg_path, ["--opts", "PARALLEL.MULTI_HOST", "True",
                                                     "PARALLEL.PARAM_SHARDING", mode])
        check(rc == 0, f"torch.distributed.run, PARAM_SHARDING {mode}: exit {rc}\n{tail}")
        check(list(ranks) == [0] and ranks[0]["backend"] == "nccl"
              and ranks[0]["fsdp"] == (mode == "fsdp"),
              f"{mode}: one rank over NCCL, FSDP2 {mode == 'fsdp'}: {ranks}\n{tail}")
        units = ranks[0]["fsdp_units"]
        check(units == (ranks[0]["blocks_and_root"] if mode == "fsdp" else 0) and
              (mode != "fsdp" or units > 1),
              f"{mode}: FSDP2 wraps each block and the root ({ranks[0]['blocks_and_root']} "
              f"units), not {units}")
        launched[mode] = ranks[0]["launches"]
        child_rows[mode] = ranks[0]
        for key, n in launched[mode].items():
            check(n > 0, f"{key} was not launched in the {mode} run under torch.distributed.run")
        runs[mode] = secs
        rows[mode] = _run_rows(run_dir(mode))
    losses1, norms1, extra1 = rows["one"]
    check(sorted(losses1) == list(range(1, MULTI_STEPS + 1)),
          f"the one-process CLI took {MULTI_STEPS} steps: {sorted(losses1)}")
    summary = {}
    for mode in ("replicated", "fsdp"):
        losses, norms, extra = rows[mode]
        check(sorted(losses) == sorted(losses1), f"{mode}: the same steps as one process")
        same = all(losses[k] == losses1[k] and norms[k] == norms1[k] for k in losses1)
        d_loss = abs(losses[1] - losses1[1]) / abs(losses1[1])
        d_norm = abs(norms[1] - norms1[1]) / abs(norms1[1])
        worst = max(abs(losses[k] - losses1[k]) / abs(losses1[k]) for k in losses1)
        check(d_loss <= TRAIN_LOSS_RTOL and d_norm <= TRAIN_GRAD_NORM_RTOL,
              f"{mode}: first-step loss rel {d_loss} (tol {TRAIN_LOSS_RTOL}), norm rel {d_norm} "
              f"(tol {TRAIN_GRAD_NORM_RTOL})")
        prof, timing = extra["profile"], extra["timing"]
        check(same, f"{mode}: the losses and pre-clip norms of {MULTI_STEPS} steps are not the "
              f"one-process CLI's bit for bit")
        summary[mode] = {"bits_equal": same, "first_loss_rel": d_loss, "first_norm_rel": d_norm,
                         "worst_loss_rel": worst, "seconds": runs[mode],
                         "median_step_ms": timing and timing["median_step_ms"],
                         "profile": prof, "launches": launched[mode]}
        print(f"[{card}] phase 7i(a) torch.distributed.run world 1 nccl, PARAM_SHARDING {mode} "
              f"(FSDP2 units {child_rows[mode]['fsdp_units']}): "
              f"{MULTI_STEPS} steps, losses and pre-clip norms equal to the one-process CLI's "
              f"bit for bit: {same}; first step loss rel {d_loss:.3e}, norm rel {d_norm:.3e}; "
              f"worst step loss rel {worst:.3e}; step {fmt(timing and timing['median_step_ms'])} "
              f"ms (one process {fmt(extra1['timing'] and extra1['timing']['median_step_ms'])}); "
              f"profiled steps {MULTI_PROFILE[0] + 1}-{MULTI_PROFILE[1]}: {prof} (one process "
              f"{extra1['profile']}); the run took {runs[mode]:.1f} s with its start "
              f"(one process {runs['one']:.1f} s); kernel launches in the run's own process "
              f"{launched[mode]} (one process {launched['one']}; equal: "
              f"{launched[mode] == launched['one']})", flush=True)

    # (b) serving the fsdp checkpoint against the one-process checkpoint, and
    # a one-process Trainer resuming it
    one_last, fsdp_last = (ckpt.auto_resume_helper(os.path.join(run_dir(name), "checkpoints"))
                           for name in ("one", "fsdp"))
    check(one_last is not None and fsdp_last is not None, "both runs wrote a checkpoint")
    state_one = torch.load(os.path.join(one_last, "state", "state.pt"), weights_only=True)
    state_fsdp = torch.load(os.path.join(fsdp_last, "state", "state.pt"), weights_only=True)
    check(state_one["model"].keys() == state_fsdp["model"].keys()
          and all(state_one["model"][k].shape == state_fsdp["model"][k].shape
                  for k in state_one["model"]),
          "the fsdp run's checkpoint holds the whole model in the one-process format")
    argv = ["--cfg", multi_yaml(d, trainer, "fsdp"), "--device", str(dev),
            "--opts", "TRAIN.EPOCHS", "2"]
    _, probe_cfg = parse_option(argv)
    probe = Trainer(probe_cfg, device=dev)
    check(probe.try_resume(), "a one-process Trainer resumes the fsdp run's checkpoint")
    got = probe.model.state_dict()
    check(all(torch.equal(got[k].cpu(), v) for k, v in state_fsdp["model"].items()),
          "the resumed one-process model holds the fsdp checkpoint bit for bit")
    num_classes = dict(probe.num_classes)
    val_ids = probe.bundle["val_dataset"].labels.img_identifiers
    val_idx = probe.bundle["val_indices"][:BATCH]
    probe.close()
    del probe
    gc.collect()
    jpegs = []
    for i in val_idx:
        with open(os.path.join(trainer["data"]["images"], f"{val_ids[i]}.jpg"), "rb") as f:
            jpegs.append(f.read())
    probs = {}
    for name, last in (("one", one_last), ("fsdp", fsdp_last)):
        bdir = os.path.join(d, f"bundle_{name}")
        prepare_bundle(last, os.path.join(run_dir(name), "assets"), bdir, "mFormerV1_sm",
                       list(TASKS), [num_classes[t] for t in TASKS], image_size=IMG)
        with open(os.path.join(bdir, "config.yaml")) as f:
            bundle_cfg = yaml.safe_load(f)
        bundle_cfg["model"]["weights_path"] = os.path.abspath(last)
        bundle_cfg["inference_options"]["batch_size"] = BATCH
        bundle_cfg["inference_options"]["enable_hierarchical_consistency_check"] = False
        path = os.path.join(bdir, "config_dir.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(bundle_cfg, f, sort_keys=False)
        handler = LinnaeusInferenceHandler.load_from_artifacts(path)
        results = handler.predict(jpegs)
        probs[name] = [[p for task in r.tasks for _, p in task.predictions] for r in results]
        ids = [[tid for task in r.tasks for tid, _ in task.predictions] for r in results]
        probs[name + "_ids"] = ids
        if name == "fsdp":
            opts = handler.config.inference_options
            from dataclasses import replace

            auto = LinnaeusInferenceHandler(
                replace(handler.config, inference_options=replace(opts, data_parallel="auto")),
                handler.model, handler.taxonomy, handler.class_maps)
            check(auto._dp == 1, f"data_parallel 'auto' on one card resolves to {auto._dp}")
            try:
                LinnaeusInferenceHandler(
                    replace(handler.config, inference_options=replace(opts, data_parallel=2)),
                    handler.model, handler.taxonomy, handler.class_maps)
                check(False, "data_parallel 2 on one card raised nothing")
            except ValueError as err:
                dp_error = str(err)
                check("only 1 devices are visible" in dp_error, f"data_parallel 2: {dp_error}")
        del handler
        gc.collect()
    gap = max(abs(a - b) for ra, rb in zip(probs["one"], probs["fsdp"]) for a, b in zip(ra, rb))
    same_top = sum(a[0] == b[0] for a, b in zip(probs["one_ids"], probs["fsdp_ids"]))
    check(gap <= PROB_TOL, f"the fsdp checkpoint's answers against the one-process one's: top-k "
          f"probabilities within {gap} (tol {PROB_TOL})")
    print(f"[{card}] phase 7i(b): the fsdp run's checkpoint (whole, one-process format) resumed "
          f"in a one-process Trainer bit for bit and served {len(jpegs)} validation JPEGs: top-k "
          f"probabilities within {gap:.2e} of the one-process checkpoint's (tol {PROB_TOL}), "
          f"top-1 of the first task equal on {same_top}/{len(jpegs)}; data_parallel 'auto' -> 1, "
          f"2 -> ValueError: {dp_error}", flush=True)

    # (c) two ranks on the one card over gloo, replicated: first the probe
    probe_err = gloo_cuda_probe()
    gloo = {"takes_cuda_tensors": probe_err is None, "error": probe_err}
    if probe_err is None:
        cfg_path = multi_yaml(d, trainer, "gloo2")
        secs, rc, tail, ranks = _torchrun(
            cfg_path, ["--backend", "gloo", "--opts", "DEBUG.EARLY_EXIT_AFTER_N_OPTIMIZER_STEPS",
                       "1", "DEBUG.PROFILE.END_STEP", "0"], nproc=2)
        check(rc == 0, f"two ranks on one card over gloo: exit {rc}\n{tail}")
        counts = {r: row["launches"] for r, row in ranks.items()}
        check(sorted(ranks) == [0, 1] and all(row["backend"] == "gloo" for row in ranks.values())
              and all(c["K1"] > 0 and c["K2"] > 0 for c in counts.values()),
              f"both gloo ranks launched K1 and K2: {ranks}")
        losses, norms, _ = _run_rows(run_dir("gloo2"))
        d_loss = abs(losses[1] - losses1[1]) / abs(losses1[1])
        d_norm = abs(norms[1] - norms1[1]) / abs(norms1[1])
        check(d_loss <= TRAIN_LOSS_RTOL and d_norm <= TRAIN_GRAD_NORM_RTOL,
              f"two gloo ranks: first-step loss rel {d_loss}, norm rel {d_norm}")
        gloo.update(first_loss_rel=d_loss, first_norm_rel=d_norm, seconds=secs,
                    launches=counts)
        print(f"[{card}] phase 7i(c): gloo takes CUDA tensors for all_gather_into_tensor, "
              f"all_reduce, broadcast and all_gather_object; two ranks on the one card, 32 rows "
              f"each of the B={BATCH} step with K1 and K2 live: first-step loss rel {d_loss:.3e} "
              f"(tol {TRAIN_LOSS_RTOL}), norm rel {d_norm:.3e} (tol {TRAIN_GRAD_NORM_RTOL}) "
              f"against the one-process step ({secs:.1f} s with the start); launches by rank "
              f"{counts}", flush=True)
    else:
        print(f"[{card}] phase 7i(c): left out: this machine's gloo does not take CUDA tensors "
              f"for the step's collectives: {probe_err[-300:]}", flush=True)

    # (d) the complexity estimator: mFormerV1_sm at IMG px, on the card
    stored = json.load(open("docs/models/model_complexity_estimates.json"))["mFormerV1_sm"]
    t0 = time.perf_counter()
    cx = estimate_all_archs(["mFormerV1_sm"], img_size=IMG, device=dev)["mFormerV1_sm"]
    cx_s = time.perf_counter() - t0
    check(cx["params"] == stored["params"],
          f"complexity params {cx['params']} == stored {stored['params']}")
    rel = abs(cx["flops_per_sample"] - stored["flops_per_sample"]) / stored["flops_per_sample"]
    check(rel <= 0.05, f"complexity FLOPs {cx['gflops_per_sample']} within 5% of stored "
          f"{stored['gflops_per_sample']}: {rel}")
    print(f"[{card}] phase 7i(d): complexity of mFormerV1_sm at {IMG} px: {cx['params']:,} "
          f"params (stored {stored['params']:,}), {cx['gflops_per_sample']:.4f} GFLOPs a sample "
          f"(stored {stored['gflops_per_sample']:.4f}, {100 * rel:.2f}% under: products and "
          f"convolutions only), activation {cx['activation_memory_mb']:.1f} MB (stored "
          f"{stored['activation_memory_mb']:.1f}, XLA's temporaries) in {cx_s:.1f} s", flush=True)

    # (e) F10: K1's backward twice, bit for bit, and its time at the two
    # stages' shapes
    f10 = {}
    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    for B, N, H, D in K1_SHAPES[:2]:
        q, k, v, do = (torch.randn(B, N, H, D, generator=g, device=dev).to(torch.bfloat16)
                       for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v, D ** -0.5)
        first = [t.clone() for t in fa._launch_bwd(q, k, v, o, lse, do, D ** -0.5)]
        second = fa._launch_bwd(q, k, v, o, lse, do, D ** -0.5)
        check(all(torch.equal(a, b) for a, b in zip(first, second)),
              f"K1 backward at {(B, N, H, D)}: dQ, dK, dV the same bits over two calls")
        ms, spread = cuda_ms_median(lambda: fa._launch_bwd(q, k, v, o, lse, do, D ** -0.5))
        f10[f"{B}x{N}x{H}x{D}"] = {"ms": ms, "ms_spread": spread}
        print(f"[{card}] phase 7i(e) F10: K1 backward bf16 {(B, N, H, D)} the same bits over "
              f"two calls; the backward (delta, dQ kernel, dK/dV kernel, no workspace) "
              f"{ms:.4f} ms (spread {spread:.4f})", flush=True)
        del q, k, v, do, o, lse, first, second
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"phase 7i took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches": launched, "summary": summary, "gloo": gloo, "complexity": cx,
            "f10": f10}


# phase 7e: the mFormerV0 family (mFormerV0_sm) on phase 7c's dataset
V0_ARCH = "configs/model/archs/mFormerV0_sm.yaml"
V0_SEED = SEED + 30
V0_EPOCHS, V0_RESUME_EPOCHS = 1, 2
V0_PROFILE = (26, 30)  # DEBUG.PROFILE START / END: steps 27-30, between GradNorm updates
# bf16 against fp32 logits of the same weights: the bar of
# tests/test_torch_mformer_v0.py and tests/test_torch_mformer_v1.py
V0_BF16_TOL = 0.05


def v0_config(bf16: bool = True):
    """The default config with configs/model/archs/mFormerV0_sm.yaml over it
    at IMG px, the four tasks, three metadata sources (temporal, spatial,
    elevation); bf16 compute unless ``bf16`` is False."""
    import os

    from linnaeus_tpu_torch.configuration import get_default_config, load_config, merge_configs

    cfg = merge_configs(get_default_config(), load_config(os.path.abspath(V0_ARCH)))
    cfg.defrost()
    cfg.MODEL.IMG_SIZE = IMG
    cfg.DATA.TASK_KEYS_H5 = list(TASKS)
    cfg.DATA.META.COMPONENTS.ELEVATION.ENABLED = True
    if not bf16:
        cfg.TRAIN.MIXED_PRECISION.ENABLED = False
        cfg.TRAIN.AMP_OPT_LEVEL = "O0"
    return cfg


def v0_batchnorms(model) -> dict:
    from linnaeus_tpu_torch.models.blocks.common import BatchNorm

    return {name: m for name, m in model.named_modules() if isinstance(m, BatchNorm)}


def v0_forward(dev, card) -> dict:
    """Phase 7e (a): mFormerV0_sm from the config form, bf16 B=BATCH, eval
    mode: ms by CUDA events (median of 3 repeats, spread), device-busy ms of
    the forward under torch.profiler, peak memory; the logits against an
    fp32 forward of the same weights."""
    from linnaeus_tpu_torch.models.build import build_model
    from linnaeus_tpu_torch.utils.device import busy_window, profile_events, profiled_device_rows

    nc = dict(TASKS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(v0_config(), nc, device=dev, seed=V0_SEED)
    meta_dim = sum(d for _, d in model.meta_components)
    check(type(model).__name__ == "MFormerV0" and model.dtype == torch.bfloat16
          and len(model.meta_components) == 3 and model.stage_dims == (64, 96, 192, 384, 768)
          and model.mbconv_depths == (2, 3) and model.attn_depths == (5, 2)
          and model.stage_3[0].attn.num_heads == model.stage_4[0].attn.num_heads == 8,
          f"mFormerV0_sm from the config form: {model.meta_components}")
    n_bn = len(v0_batchnorms(model))
    g = torch.Generator(device=dev).manual_seed(V0_SEED + 1)
    x = torch.randn(BATCH, IMG, IMG, 3, generator=g, device=dev)
    aux = torch.randn(BATCH, meta_dim, generator=g, device=dev)
    with torch.inference_mode():
        out = model(x, aux)
        torch.cuda.synchronize()
        ms, spread = cuda_ms_median(lambda: model(x, aux), iters=5, repeats=3)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                model(x, aux)
            torch.cuda.synchronize()
    rows = profiled_device_rows(prof)
    busy = busy_window(profile_events(prof))[0] / 3
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    ref = build_model(v0_config(bf16=False), nc, device=dev, seed=V0_SEED)
    ref.load_state_dict(model.state_dict())
    with torch.inference_mode():
        out32 = ref(x, aux)
    err = max(max_err(out[t], out32[t]) for t in TASKS)
    agree = {t: (out[t].argmax(-1) == out32[t].argmax(-1)).float().mean().item() for t in TASKS}
    check(all(torch.isfinite(out[t]).all() and out[t].shape == (BATCH, TASKS[t]) for t in TASKS),
          "finite logits of the expected shapes")
    check(err <= V0_BF16_TOL, f"bf16 against fp32 logits: max|diff| {err} (tol {V0_BF16_TOL})")
    print(f"[{card}] mFormerV0_sm {IMG}px bf16 B={BATCH} forward (config form, {n_bn} "
          f"BatchNorms in eval, {meta_dim} metadata columns): {ms:.2f} ms (CUDA events, median "
          f"of 3 repeats of 5, spread {spread:.3f}), device busy {busy:.2f} ms a forward under "
          f"torch.profiler (share {busy / ms:.3f}), peak {peak:.2f} GiB; bf16 against fp32 "
          f"logits max|diff| {err:.3e} (tol {V0_BF16_TOL}), top-1 agreement "
          + ", ".join(f"{t} {a:.3f}" for t, a in agree.items()), flush=True)
    print("the forward's longest device rows, ms a forward (calls): " + "; ".join(
        f"{name[:70]} {ms_ / 3:.3f} ({n // 3})" for name, ms_, n in rows[:10]), flush=True)
    del model, ref, out, out32
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms": ms, "spread": spread, "busy_ms": busy, "peak_gib": peak, "max_err": err,
            "top1_agreement": agree}


def write_metaformer_file(path: str, seed: int, model) -> dict:
    """A MetaFG-layout checkpoint for ``model`` (an mFormerV0 at IMG px)
    from a seeded generator, written with ``torch.save`` as
    ``{"model": ...}``: every tensor of its state_dict (normal draws, running
    variances positive), MetaFG's ``num_batches_tracked`` and
    ``relative_position_index`` beside them and its own 1000-class
    ``head``, none of the per-task heads, and three tensors of another
    geometry (the 224 px relative-position tables of stages 3 and 4, a
    temporal head with the hour columns). Returns the mismatched keys."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for key, value in model.state_dict().items():
        if key.startswith("head."):
            continue
        t = 0.02 * torch.randn(value.shape, generator=g)
        sd[key] = t.abs() + 0.5 if key.endswith("running_var") else t
        if key.endswith("running_var"):
            sd[key.replace("running_var", "num_batches_tracked")] = torch.tensor(1000)
    for name, module in model.named_modules():
        if hasattr(module, "relative_position_index"):
            sd[f"{name}.relative_position_index"] = module.relative_position_index.cpu()
    sd["head.weight"], sd["head.bias"] = torch.randn(1000, 768, generator=g), torch.zeros(1000)
    mismatched = {"stage_3.0.attn.relative_position_bias_table": (27 * 27 + 1, 8),
                  "stage_4.0.attn.relative_position_bias_table": (13 * 13 + 1, 8),
                  "meta_temporal_head_1.0.weight": (384, 4)}
    for key, shape in mismatched.items():
        sd[key] = 0.02 * torch.randn(shape, generator=g)
    torch.save({"model": sd}, path)
    return mismatched


def v0_metaformer(dev, card, d: str) -> dict:
    """Phase 7e (c): mFormerV0_sm built with MODEL.PRETRAINED_SOURCE
    'metaformer' from a seeded MetaFG file; the loaded tensors bit for bit
    the file's, the reports those of the same load on the CPU."""
    import os

    from linnaeus_tpu_torch.models.build import build_model
    from linnaeus_tpu_torch.utils import pretrained as tpre

    nc = dict(TASKS)
    cfg = v0_config()
    cpu_model = build_model(cfg, nc, device="cpu", seed=V0_SEED)
    path = os.path.join(d, "metafg_seeded.pth")
    mismatched = write_metaformer_file(path, V0_SEED + 2, cpu_model)
    cfg.MODEL.PRETRAINED, cfg.MODEL.PRETRAINED_SOURCE = path, "metaformer"
    model = build_model(cfg, nc, device=dev, seed=V0_SEED)
    reports = tpre.load_pretrained(cfg, model)
    cpu_reports = tpre.load_pretrained(cfg, cpu_model)
    source = tpre.load_torch_state_dict(path)
    weights = model.state_dict()
    loaded = [k for r in reports.values() for k in r["loaded"]]
    check(sorted(reports) == ["MetaFormer", "MetaFormer/bn-stats"] and reports == cpu_reports,
          "the MetaFormer reports on the card equal the CPU's")
    check(all(torch.equal(weights[k].cpu(), source[k]) for k in loaded),
          "every loaded tensor equals the file's bit for bit")
    check(sorted(m.split(":")[0] for m in reports["MetaFormer"]["shape_mismatch"])
          == sorted(mismatched), f"shape mismatches {reports['MetaFormer']['shape_mismatch']}")
    stats = reports["MetaFormer/bn-stats"]
    check(len(stats["loaded"]) == 2 * len(v0_batchnorms(model)) and not stats["missing"],
          f"every running statistic loaded: {stats}")
    tally = {name: {k: len(v) for k, v in r.items()} for name, r in reports.items()}
    print(f"[{card}] MetaFormer init of mFormerV0_sm (MODEL.PRETRAINED_SOURCE 'metaformer', a "
          f"seeded MetaFG-layout file): {tally}, the same on the CPU; every loaded tensor "
          f"bit for bit the file's", flush=True)
    del model, cpu_model
    gc.collect()
    torch.cuda.empty_cache()
    return tally


def v0_trainer_yaml(d: str, data: dict) -> str:
    """Phase 7c's experiment with mFormerV0_sm: the default config, B=BATCH,
    the four tasks, hybrid JPEGs, a 0.8 split, GradNorm every
    TRAINER_GRADNORM_INTERVAL steps, a checkpoint every epoch, V0_EPOCHS
    epochs, three metadata sources."""
    import os

    import yaml

    exp = {
        "EXPERIMENT": {"NAME": "trainer_v0", "PROJECT": "chip_smoke", "GROUP": "phase7e"},
        "ENV": {"OUTPUT": {"BASE_DIR": os.path.join(d, "out_v0")}},
        "MODEL": {"BASE": [os.path.abspath(V0_ARCH)], "IMG_SIZE": IMG},
        "DATA": {
            "IMG_SIZE": IMG, "BATCH_SIZE": BATCH, "BATCH_SIZE_VAL": BATCH,
            "TASK_KEYS_H5": list(TASKS), "PARTIAL": {"LEVELS": True},
            "H5": {"LABELS_PATH": data["labels"], "TRAIN_VAL_SPLIT_RATIO": 0.8},
            "HYBRID": {"USE_HYBRID": True, "IMAGES_DIR": data["images"],
                       "FILE_EXTENSION": ".jpg"},
            "META": {"COMPONENTS": {"ELEVATION": {"ENABLED": True, "SOURCE": "elevation"}}},
        },
        "TRAIN": {"EPOCHS": V0_EPOCHS},
        "LOSS": {"GRAD_WEIGHTING": {"TASK": {"UPDATE_INTERVAL": TRAINER_GRADNORM_INTERVAL}}},
        "SCHEDULE": {"CHECKPOINT": {"INTERVAL_EPOCHS": 1, "KEEP_LAST_N": TRAINER_KEEP_LAST},
                     "METRICS": {"CONSOLE_INTERVAL": 1, "WANDB_INTERVAL": 1}},
    }
    path = os.path.join(d, "trainer_v0.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(exp, f)
    return path


def v0_train(dev, card, trainer: dict) -> dict:
    """Phase 7e (b): the CLI trains mFormerV0_sm for V0_EPOCHS epochs with
    validation, GradNorm and a checkpoint; a probe Trainer resumes it bit
    for bit, running statistics included; the CLI runs again to
    V0_RESUME_EPOCHS epochs, auto-resuming, with a profiled window."""
    import os

    from linnaeus_tpu_torch.train.loop import Trainer
    from linnaeus_tpu_torch.train.main import main as train_main
    from linnaeus_tpu_torch.train.main import parse_option
    from linnaeus_tpu_torch.utils import checkpoint as ckpt

    d = trainer["dir"]
    argv = ["--cfg", v0_trainer_yaml(d, trainer["data"]), "--device", str(dev)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    first = train_main(argv)
    run1_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    check(type(first.model).__name__ == "MFormerV0", "the CLI built mFormerV0")
    spe, steps1 = first.steps_per_epoch, first.progress.global_step
    check(steps1 == V0_EPOCHS * spe, f"run 1 took {steps1} steps")
    losses = {}
    with open(os.path.join(first.config.ENV.OUTPUT.DIRS.LOGS, "metrics.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            if "train/loss" in row:
                losses[row["step"]] = row["train/loss"]
    check(sorted(losses) == list(range(1, steps1 + 1))
          and all(np.isfinite(v) for v in losses.values()), f"finite loss at every step {losses}")
    summary = first.metrics.phase_summary("val")
    check(np.isfinite(summary["loss"]), f"validation of mFormerV0: {summary}")
    bns = v0_batchnorms(first.model)
    moved = {n: bool((m.running_mean != 0).any() and (m.running_var != 1).any()
                     and torch.isfinite(m.running_mean).all() and torch.isfinite(m.running_var).all())
             for n, m in bns.items()}
    check(all(moved.values()), f"every BatchNorm's running statistics moved and are finite: "
          f"{[n for n, ok in moved.items() if not ok]}")
    n_gn = sum(t["gradnorm_updates"] for t in first.epoch_timings.values())
    check(n_gn == steps1 // TRAINER_GRADNORM_INTERVAL, f"{n_gn} GradNorm updates")
    saved = ckpt.snapshot_state(first.state)
    last = ckpt.auto_resume_helper(first.ckpt_dir)
    on_disk = torch.load(os.path.join(last, ckpt.STATE_DIR, ckpt.STATE_FILE),
                         map_location="cpu", weights_only=True)["model"]
    check(all(torch.equal(on_disk[f"{n}.{b}"], saved["model"][f"{n}.{b}"])
              for n in bns for b in ("running_mean", "running_var")),
          "the checkpoint holds the running statistics run 1 ended with")
    timing1 = first.epoch_timings[V0_EPOCHS - 1]
    del first
    gc.collect()
    torch.cuda.empty_cache()

    _, config = parse_option(argv + ["--opts", "TRAIN.EPOCHS", str(V0_RESUME_EPOCHS)])
    probe = Trainer(config, device=dev)
    check(probe.try_resume(), "a Trainer on the same output directory resumes")
    check(_same_bits(ckpt.snapshot_state(probe.state), saved),
          "the resumed state (parameters, running statistics, optimizer moments, GradNorm, "
          "generator) equals the checkpoint bit for bit")
    probe.close()
    del probe
    gc.collect()

    start, end = V0_PROFILE
    t0 = time.perf_counter()
    second = train_main(argv + ["--opts", "TRAIN.EPOCHS", str(V0_RESUME_EPOCHS),
                                "DEBUG.PROFILE.START_STEP", str(start),
                                "DEBUG.PROFILE.END_STEP", str(end)])
    run2_s = time.perf_counter() - t0
    check(second.resumed_from is not None and second.resumed_from.endswith(
        ckpt._ckpt_name(steps1)) and second.progress.global_step == V0_RESUME_EPOCHS * spe,
        f"run 2 resumed from {second.resumed_from} and took steps to "
        f"{second.progress.global_step}")
    prof = second.profile_summary
    check(prof is not None and prof["steps"] == end - start, f"profiled window {prof}")
    timing2 = second.epoch_timings[V0_RESUME_EPOCHS - 1]
    fmt = lambda v: "n/a" if v is None else f"{v:.2f}"  # noqa: E731
    print(f"[{card}] mFormerV0_sm {IMG}px B={BATCH} bf16 through the Trainer (the CLI, "
          f"hybrid JPEGs, default config, {len(bns)} BatchNorms): run 1 {steps1} steps, "
          f"median step {fmt(timing1['median_step_ms'])} ms (the first epoch, cold), losses "
          f"{[round(losses[s], 4) for s in sorted(losses)][:4]}..., validation loss "
          f"{summary['loss']:.4f}; every running statistic moved, finite; resumed state bit for "
          f"bit the checkpoint's; run 2 (resumed) median step {fmt(timing2['median_step_ms'])} ms; "
          f"under torch.profiler, steps {start + 1}-{end}: {prof['wall_ms_per_step']:.2f} ms a "
          f"step, device busy {prof['device_busy_ms_per_step']:.2f} ms, device-busy share "
          f"{1.0 - prof['idle_share']:.3f}; peak memory {peak:.2f} GiB (run 1); runs "
          f"{run1_s:.1f} + {run2_s:.1f} s", flush=True)
    out = {"second": second, "last": ckpt.auto_resume_helper(second.ckpt_dir), "dir": d,
           "images": trainer["data"]["images"], "peak_gib": peak,
           "median_step_ms": [timing1["median_step_ms"], timing2["median_step_ms"]],
           "profile": prof, "runs_s": [run1_s, run2_s]}
    return out


def v0_serve(dev, card, run: dict) -> dict:
    """Phase 7e (d): the handler from (b)'s checkpoint directory (F8)
    against the bundle tool's ``weights.pt`` of the same checkpoint: logits
    on BATCH validation JPEGs bit for bit; then HTTP through
    tools/serve.make_server, every answer within PROB_TOL of ``predict``."""
    import base64
    import os
    import threading
    import urllib.request
    from dataclasses import replace

    import yaml

    from linnaeus_tpu_torch.inference.handler import LinnaeusInferenceHandler
    from linnaeus_tpu_torch.inference.preprocessing import preprocess_image_batch
    from linnaeus_tpu_torch.tools.prepare_inference_bundle import prepare_bundle
    from linnaeus_tpu_torch.tools.serve import make_server
    from linnaeus_tpu_torch.tools.serve_latency_bench import percentile

    second, last = run["second"], run["last"]
    cfg = second.config
    bundle_dir = os.path.join(run["dir"], "bundle_v0")
    prepare_bundle(last, cfg.ENV.OUTPUT.DIRS.ASSETS, bundle_dir, "mFormerV0_sm", list(TASKS),
                   [second.num_classes[t] for t in TASKS], image_size=IMG)
    variant = os.path.join(bundle_dir, "variant.yaml")
    with open(variant, "w") as f:
        yaml.safe_dump({"MODEL": json.loads(json.dumps(cfg.MODEL)), "TRAIN": {
            "MIXED_PRECISION": json.loads(json.dumps(cfg.TRAIN.MIXED_PRECISION))}}, f)
    with open(os.path.join(bundle_dir, "config.yaml")) as f:
        bundle_cfg = yaml.safe_load(f)
    bundle_cfg["model"]["architecture_variant_config_path"] = variant
    bundle_cfg["inference_options"]["batch_size"] = BATCH
    paths = {}
    for name, weights in (("pt", "weights.pt"), ("dir", os.path.abspath(last))):
        bundle_cfg["model"]["weights_path"] = weights
        paths[name] = os.path.join(bundle_dir, f"config_{name}.yaml")
        with open(paths[name], "w") as f:
            yaml.safe_dump(bundle_cfg, f, sort_keys=False)
    t0 = time.perf_counter()
    handler = LinnaeusInferenceHandler.load_from_artifacts(paths["dir"])
    load_s = time.perf_counter() - t0
    from_pt = LinnaeusInferenceHandler.load_from_artifacts(paths["pt"])
    check(type(handler.model).__name__ == "MFormerV0" and handler.model.dtype == torch.bfloat16,
          "the handler serves mFormerV0 in bf16")
    ids = second.bundle["val_dataset"].labels.img_identifiers
    jpegs = []
    for i in second.bundle["val_indices"][:BATCH]:
        with open(os.path.join(run["images"], f"{ids[i]}.jpg"), "rb") as f:
            jpegs.append(f.read())
    pixels = torch.from_numpy(preprocess_image_batch(jpegs, handler.config)).to(dev)
    aux = torch.randn(BATCH, handler.config.aux_vector_length(),
                      generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    x = (pixels.float() / 255.0 - handler._mean) / handler._std
    with torch.inference_mode():
        a, b = handler.model(x, aux), from_pt.model(x, aux)
    check(all(torch.equal(a[t], b[t]) for t in TASKS),
          "the checkpoint directory's logits equal the bundle's weights.pt's bit for bit")
    del from_pt
    gc.collect()
    host_ms = predict_breakdown(handler, jpegs, None, card)

    opts = handler.config.inference_options
    raw_handler = LinnaeusInferenceHandler(
        replace(handler.config, inference_options=replace(
            opts, enable_hierarchical_consistency_check=False)),
        handler.model, handler.taxonomy, handler.class_maps)
    handler.warmup()
    server = make_server(handler, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    n_req = PRETRAINED_CLIENTS * PRETRAINED_REQUESTS
    images = [[jpegs[(r * PRETRAINED_IMAGES + i) % BATCH] for i in range(PRETRAINED_IMAGES)]
              for r in range(n_req)]
    answers, latencies, errors = [None] * n_req, [], []
    lock = threading.Lock()

    def client(c):
        for r in range(c * PRETRAINED_REQUESTS, (c + 1) * PRETRAINED_REQUESTS):
            body = {"instances": [{"image": base64.b64encode(j).decode()} for j in images[r]]}
            req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                         data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            t1 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=120) as resp:
                    answers[r] = json.loads(resp.read())
            except Exception as e:  # noqa: BLE001 counted and failed below
                with lock:
                    errors.append(repr(e))
                continue
            with lock:
                latencies.append(1e3 * (time.perf_counter() - t1))

    try:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(PRETRAINED_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.stop()
    check(not errors, f"HTTP errors: {errors[:3]}")
    flips, worst = 0, 0.0
    for r, answer in enumerate(answers):
        got = [as_result(p) for p in answer["predictions"]]
        check_results(got, PRETRAINED_IMAGES, handler.taxonomy, handler.class_maps)
        want, raw = handler.predict(images[r]), raw_handler.predict(images[r])
        for g_, w_, r_ in zip(got, want, raw):
            f, e = agreement(g_, w_, r_, handler.class_maps)
            flips, worst = flips + f, max(worst, e)
    lat = sorted(latencies)
    http = {"images_per_s": n_req * PRETRAINED_IMAGES / wall, "p50_ms": percentile(lat, 50),
            "p99_ms": percentile(lat, 99)}
    print(f"[{card}] mFormerV0_sm served from the training checkpoint directory "
          f"{os.path.basename(last)} (loaded in {load_s:.1f} s): logits bit for bit those of the "
          f"bundle tool's weights.pt on {BATCH} validation JPEGs; HTTP {PRETRAINED_CLIENTS} "
          f"clients x {PRETRAINED_REQUESTS} requests x {PRETRAINED_IMAGES} JPEGs (smoke "
          f"reading): {http['images_per_s']:.1f} img/s, p50 {http['p50_ms']:.1f} ms, p99 "
          f"{http['p99_ms']:.1f} ms; every answer within {PROB_TOL:g} of predict (max |dp| "
          f"{worst:.3e}, {flips} near-tie flips)", flush=True)
    del handler, raw_handler, server
    gc.collect()
    torch.cuda.empty_cache()
    return {"http": http, "host_ms": host_ms, "load_s": load_s}


def v0_phase(dev, card, fa, fm, trainer: dict) -> dict:
    """Phase 7e: (a) the forward, (b) training through the CLI with resume,
    (c) MetaFormer init, (d) serving from the checkpoint directory. None of
    the seven kernels is on mFormerV0's path; their counters must stay at 0."""
    t0 = time.perf_counter()
    fa.LAUNCHES = fa.BWD_LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
    fm.LAUNCHES = fm.BWD_LAUNCHES = 0
    forward = v0_forward(dev, card)
    run = v0_train(dev, card, trainer)
    tally = v0_metaformer(dev, card, trainer["dir"])
    served = v0_serve(dev, card, run)
    launched = {"K1": fa.LAUNCHES + fa.BWD_LAUNCHES + fa.DQ_LAUNCHES + fa.DKV_LAUNCHES,
                "K2": fm.LAUNCHES + fm.BWD_LAUNCHES}
    check(launched == {"K1": 0, "K2": 0}, f"mFormerV0 launched a kernel: {launched}")
    del run["second"]
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    print(f"phase 7e (mFormerV0_sm) took {seconds:.1f} s; none of the seven launched (none "
          f"is on mFormerV0's path)", flush=True)
    return {"forward": forward, "train": {k: v for k, v in run.items() if k != "second"},
            "metaformer": tally, "serve": served, "seconds": seconds}


# phase 7g: mFormerV1_sm_moe (configs/model/archs/mFormerV1_sm_moe.yaml): 8
# experts, top-2, capacity factor 1.25 on every 2nd RoPE block, so stage 3
# blocks 1 and 3 (N 580, C 182) and stage 4 block 1 (N 148, C 47); the MoE
# blocks are RoPE blocks, so K1 and K2 launch as in mFormerV1_sm
MOE_ARCH = "configs/model/archs/mFormerV1_sm_moe.yaml"
MOE_SEED = SEED + 40
MOE_LAYERS = 3
MOE_STEPS = 3
# bf16 against fp32 logits of the same weights (the whole-forward bar above):
# the router runs in float32 on a bf16 activation, so a token whose top-2
# choice is near a tie may route elsewhere in bf16
MOE_BF16_TOL = LOGIT_TOL[torch.bfloat16]


def moe_config(moe: bool = True):
    """The default config with mFormerV1_sm_moe.yaml over it at IMG px, the
    four tasks, the serving config's three metadata sources (TEMPORAL 2,
    SPATIAL 3, ELEVATION 6); ``moe`` False drops MODEL.MOE (the dense twin,
    mFormerV1_sm)."""
    import os

    from linnaeus_tpu_torch.configuration import get_default_config, load_config, merge_configs

    cfg = merge_configs(get_default_config(), load_config(os.path.abspath(MOE_ARCH)))
    cfg.defrost()
    cfg.MODEL.IMG_SIZE = IMG
    cfg.DATA.TASK_KEYS_H5 = list(TASKS)
    for name, dim in (("TEMPORAL", 2), ("SPATIAL", 3), ("ELEVATION", 6)):
        cfg.DATA.META.COMPONENTS[name].ENABLED = True
        cfg.DATA.META.COMPONENTS[name].DIM = dim
    cfg.MODEL.MOE.ENABLED = moe
    return cfg


def moe_blocks(model) -> list:
    return [(s, j) for s in (2, 3) for j, b in enumerate(model.stages[s]) if b.use_moe]


def moe_serve(dev, card, fa, fm) -> dict:
    """Phase 7g (a): the MoE model from the config form in bf16 with seeded
    weights serves BATCH images through the handler with its default
    options (the consistency pass on); launches per forward; forward ms
    against the dense twin's (CUDA events, alternated), device-busy ms and
    peak; bf16 against fp32 logits of the same weights."""
    from linnaeus_tpu_torch.inference.handler import LinnaeusInferenceHandler
    from linnaeus_tpu_torch.models.build import build_model
    from linnaeus_tpu_torch.utils.device import busy_window, profile_events

    cfg = serving_config()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(moe_config(), dict(TASKS), device=dev, seed=MOE_SEED)
    check(model.dtype == torch.bfloat16 and model.moe_num_experts == 8
          and moe_blocks(model) == [(2, 1), (2, 3), (3, 1)]
          and model.stages[2][1].mlp.top_k == 2 and model.stages[2][1].mlp.wi.shape == (8, 384, 1536),
          f"mFormerV1_sm_moe from the config form: MoE blocks {moe_blocks(model)}")
    taxonomy, maps = serving_taxonomy(cfg)
    handler = LinnaeusInferenceHandler(cfg, model, taxonomy, maps)
    images, metas = requests(BATCH, np.random.default_rng(MOE_SEED))
    handler.predict(images[:2], metas[:2])  # warm-up
    fa.LAUNCHES = fm.LAUNCHES = 0
    results = handler.predict(images, metas)
    launched = {"K1": fa.LAUNCHES, "K2": fm.LAUNCHES}
    nulled = check_results(results, BATCH, taxonomy, maps)
    check(launched == {"K1": K1_PER_FORWARD, "K2": K2_PER_FORWARD},
          f"MoE serving launches {launched} for one forward")
    g = torch.Generator(device=dev).manual_seed(MOE_SEED + 1)
    x = torch.randn(BATCH, IMG, IMG, 3, generator=g, device=dev)
    aux = torch.randn(BATCH, 11, generator=g, device=dev)
    dense = build_model(moe_config(moe=False), dict(TASKS), device=dev, seed=MOE_SEED)
    with torch.inference_mode():
        out, stats = model(x, aux, moe_stats=True)
        times = {}
        for name, net in (("moe", model), ("dense", dense), ("dense", dense), ("moe", model)):
            times.setdefault(name, []).append(cuda_ms(lambda: net(x, aux), iters=5))
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                model(x, aux)
            torch.cuda.synchronize()
        model.dtype = torch.float32
        out32 = model(x, aux)
        model.dtype = torch.bfloat16
    fwd = {k: sum(v) / len(v) for k, v in times.items()}
    busy = busy_window(profile_events(prof))[0] / 3
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    err = max(max_err(out[t], out32[t]) for t in TASKS)
    agree = {t: (out[t].argmax(-1) == out32[t].argmax(-1)).float().mean().item() for t in TASKS}
    check(all(torch.isfinite(out[t]).all() and out[t].shape == (BATCH, TASKS[t]) for t in TASKS),
          "finite MoE logits of the expected shapes")
    check(err <= MOE_BF16_TOL, f"MoE bf16 against fp32 logits: max|diff| {err}")
    st = {k: float(v) for k, v in stats.items()}
    check(all(np.isfinite(v) for v in st.values()) and 0.0 <= st["moe_drop_frac"] < 1.0,
          f"MoE statistics of a serving forward {st}")
    print(f"[{card}] mFormerV1_sm_moe {IMG}px bf16 B={BATCH} served through the handler "
          f"(default options; the consistency pass nulled {nulled} of {BATCH * len(TASKS)} task "
          f"results): launches {launched} a forward; forward {fwd['moe']:.2f} ms, the dense twin "
          f"(mFormerV1_sm, same config) {fwd['dense']:.2f} ms (CUDA events, alternated); device "
          f"busy {busy:.2f} ms a forward under torch.profiler (share {busy / fwd['moe']:.3f}); "
          f"peak {peak:.2f} GiB; bf16 against fp32 logits max|diff| {err:.3e} (tol "
          f"{MOE_BF16_TOL:g}), top-1 agreement " + ", ".join(f"{t} {a:.3f}" for t, a in agree.items())
          + f"; statistics {st}", flush=True)
    del model, dense, handler, out, out32
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms": fwd["moe"], "dense_ms": fwd["dense"], "busy_ms": busy, "peak_gib": peak,
            "max_err": err, "launches": launched}


def moe_steps(dev, card, fa, fm) -> dict:
    """Phase 7g (b): ``train_bench --moe`` steps at B=BATCH, kernels on then
    off from the same seed: the first step's loss within TRAIN_LOSS_RTOL, the
    statistics finite, drop_frac in [0, 1), launches K1 7 + 7 and K2 6 + 6 a
    step; step ms, the device-busy ms of two profiled steps against it, peak.
    (The dense step against the MoE one, each in a process of its own:
    ``train_bench`` and ``train_bench --moe``, PERF.md.)"""
    from linnaeus_tpu_torch.tools import train_bench
    from linnaeus_tpu_torch.utils.device import busy_window, profile_events

    def counts():
        return kernel_counts(fa, fm)

    results = {}
    for name, kernels in (("on", True), ("off", False)):
        gc.collect()
        torch.cuda.empty_cache()
        run, state = train_bench.build_step(BATCH, IMG, kernels, "mFormerV1_sm", TASKS,
                                            device=dev, seed=MOE_SEED, moe=True)
        check(len(moe_blocks(state.model)) == MOE_LAYERS, "train_bench --moe builds 3 MoE layers")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fa.LAUNCHES = fa.BWD_LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
        fm.LAUNCHES = fm.BWD_LAUNCHES = 0
        history = [run()]
        launched = counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        history += [run() for _ in range(MOE_STEPS)]
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / MOE_STEPS
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        want = ({"K1": K1_PER_FORWARD, "K1_bwd": K1_PER_FORWARD, "K1_dq": K1_PER_FORWARD,
                 "K1_dkv": K1_PER_FORWARD, "K2": K2_PER_FORWARD, "K2_bwd": K2_PER_FORWARD}
                if kernels else dict.fromkeys(launched, 0))
        check(launched == want, f"MoE train launches {launched} for one step, expected {want}")
        stats = {k: [float(m[k]) for m in history] for k in ("moe_aux", "moe_z", "moe_drop_frac")}
        losses = [float(m["loss"]) for m in history]
        check(all(np.isfinite(v) for vs in stats.values() for v in vs)
              and all(0.0 <= v < 1.0 for v in stats["moe_drop_frac"])
              and all(np.isfinite(losses)), f"MoE statistics {stats}, losses {losses}")
        busy = None
        if kernels:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    run()
                torch.cuda.synchronize()
            busy = busy_window(profile_events(prof))[0] / 2
        print(f"[{card}] mFormerV1_sm_moe {IMG}px B={BATCH} bf16 train step (train_bench --moe), "
              f"kernels {name}: {ms:.2f} ms a step (CUDA events over {MOE_STEPS} steps), peak "
              f"{peak:.2f} GiB; loss " + " ".join(f"{v:.4f}" for v in losses)
              + "; moe_aux " + " ".join(f"{v:.4f}" for v in stats["moe_aux"])
              + ", moe_z " + " ".join(f"{v:.3f}" for v in stats["moe_z"])
              + ", moe_drop_frac " + " ".join(f"{v:.4f}" for v in stats["moe_drop_frac"])
              + f"; launches {launched} a step"
              + (f"; device busy {busy:.2f} ms a step under torch.profiler (share {busy / ms:.3f} "
                 f"of the step above)" if kernels else ""),
              flush=True)
        results[name] = {"loss": losses[0], "ms": ms, "peak_gib": peak, "launches": launched,
                         "busy_ms": busy, "stats": stats}
        del run, state, history
    on, off = results["on"], results["off"]
    d_loss = abs(on["loss"] - off["loss"]) / abs(off["loss"])
    print(f"first MoE train step, kernels on vs off: loss {on['loss']:.5f} vs {off['loss']:.5f} "
          f"(rel {d_loss:.2e}, tol {TRAIN_LOSS_RTOL:g})", flush=True)
    check(d_loss <= TRAIN_LOSS_RTOL, f"first MoE step's loss, kernels on vs off: rel {d_loss}")
    gc.collect()
    torch.cuda.empty_cache()
    return results


def moe_trainer_yaml(d: str, data: dict, cn_path: str, rv_path: str) -> str:
    """Phase 7c's experiment with mFormerV1_sm_moe, upcycled from the seeded
    ConvNeXt-Tiny and DeiT-S files (MODEL.PRETRAINED_CONVNEXT / _ROPEVIT),
    one epoch, a checkpoint at its end."""
    import os

    import yaml

    exp = {
        "EXPERIMENT": {"NAME": "trainer_moe", "PROJECT": "chip_smoke", "GROUP": "phase7g"},
        "ENV": {"OUTPUT": {"BASE_DIR": os.path.join(d, "out_moe")}},
        "MODEL": {"BASE": [os.path.abspath(MOE_ARCH)], "IMG_SIZE": IMG,
                  "PRETRAINED_CONVNEXT": cn_path, "PRETRAINED_ROPEVIT": rv_path},
        "DATA": {
            "IMG_SIZE": IMG, "BATCH_SIZE": BATCH, "BATCH_SIZE_VAL": BATCH,
            "TASK_KEYS_H5": list(TASKS), "PARTIAL": {"LEVELS": True},
            "H5": {"LABELS_PATH": data["labels"], "TRAIN_VAL_SPLIT_RATIO": 0.8},
            "HYBRID": {"USE_HYBRID": True, "IMAGES_DIR": data["images"],
                       "FILE_EXTENSION": ".jpg"},
            "META": {"COMPONENTS": {"ELEVATION": {"ENABLED": True, "SOURCE": "elevation"}}},
        },
        "TRAIN": {"EPOCHS": 1},
        "LOSS": {"GRAD_WEIGHTING": {"TASK": {"UPDATE_INTERVAL": TRAINER_GRADNORM_INTERVAL}}},
        "SCHEDULE": {"CHECKPOINT": {"INTERVAL_EPOCHS": 1, "KEEP_LAST_N": TRAINER_KEEP_LAST},
                     "METRICS": {"CONSOLE_INTERVAL": 1, "WANDB_INTERVAL": 1}},
    }
    path = os.path.join(d, "trainer_moe.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(exp, f)
    return path


def moe_cli(dev, card, fa, fm, trainer: dict) -> dict:
    """Phase 7g (c)-(e): the CLI's Trainer upcycles the seeded files into
    the MoE model (every expert of every bank the dense twin's MLP bit for
    bit, the routers their seeded init), trains one epoch on phase 7c's
    dataset and writes a checkpoint; the handler serves that checkpoint
    directory with the checkpoint's model's logits bit for bit;
    ``tools/export_torch.py`` exports it, and the export loads strict into
    mFormerV1_sm, whose forward runs."""
    import os

    import yaml

    from linnaeus_tpu_torch.inference.handler import LinnaeusInferenceHandler
    from linnaeus_tpu_torch.models.build import build_model
    from linnaeus_tpu_torch.tools.export_torch import main as export_main
    from linnaeus_tpu_torch.tools.prepare_inference_bundle import prepare_bundle
    from linnaeus_tpu_torch.train.main import build_trainer
    from linnaeus_tpu_torch.utils import checkpoint as ckpt
    from linnaeus_tpu_torch.utils import pretrained as tpre

    d = trainer["dir"]
    cn_path, rv_path = (os.path.join(d, n) for n in ("convnext_tiny.pth",
                                                     "rope_mixed_deit_small.pth"))
    if not (os.path.isfile(cn_path) and os.path.isfile(rv_path)):
        cn_path, rv_path = write_pretrained_files(d, SEED + 20)
    cfg_path = moe_trainer_yaml(d, trainer["data"], cn_path, rv_path)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.LAUNCHES = fa.BWD_LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
    fm.LAUNCHES = fm.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    run = build_trainer(["--cfg", cfg_path, "--device", str(dev)])
    build_s = time.perf_counter() - t0
    # the dense twin's MLP of each bank, read from the files through the
    # loaders' tables: the DeiT-S block's where its shape fits (stage 3), else
    # the dense template's zeros (stage 4 is 768 wide, the file 384)
    rv = tpre.load_torch_state_dict(rv_path)
    sources = {dst: src for src, dst in tpre.ropevit_entries(rv, (5, 2))}
    weights = run.model.state_dict()
    exact, n_banks = True, 0
    for s, j in moe_blocks(run.model):
        for leaf, suffix in (("wi", "fc1.weight"), ("bi", "fc1.bias"), ("wo", "fc2.weight"),
                             ("bo", "fc2.bias")):
            bank = weights[f"stages.{s}.{j}.mlp.{leaf}"].cpu()
            src = rv.get(sources.get(f"stages.{s}.{j}.mlp.{suffix}", ""))
            dense = src.t() if src is not None and src.dim() == 2 else src
            if dense is None or tuple(dense.shape) != tuple(bank.shape[1:]):
                dense = torch.zeros(bank.shape[1:])
            exact &= all(torch.equal(bank[e], dense) for e in range(bank.shape[0]))
            n_banks += 1
    routers = [weights[f"stages.{s}.{j}.mlp.router"] for s, j in moe_blocks(run.model)]
    check(exact and n_banks == 4 * MOE_LAYERS,
          f"every expert of every bank ({n_banks} banks) equals the dense twin's MLP bit for bit")
    check(all(float(r.abs().sum()) > 0 for r in routers), "the routers keep their seeded init")
    t0 = time.perf_counter()
    try:
        run.train()
    finally:
        run.close()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    launched = {"K1": fa.LAUNCHES, "K1_bwd": fa.BWD_LAUNCHES, "K2": fm.LAUNCHES,
                "K2_bwd": fm.BWD_LAUNCHES}
    rows = {}
    with open(os.path.join(run.config.ENV.OUTPUT.DIRS.LOGS, "metrics.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            if "train/loss" in row:
                rows[row["step"]] = row
    steps = run.progress.global_step
    check(sorted(rows) == list(range(1, steps + 1)) and all(
        np.isfinite(r[k]) for r in rows.values()
        for k in ("train/loss", "train/moe_aux", "train/moe_z", "train/moe_drop_frac")),
        "finite loss and MoE statistics at every step of the CLI's epoch")
    n_val = len(run.val_loader) if run.val_loader is not None else 0
    n_gn = sum(t["gradnorm_updates"] for t in run.epoch_timings.values())
    val_forwards = n_val * len(run.validation_seconds)
    want = {k: steps * K1_PER_REMAT_STEP[k] + n_gn * PER_GRADNORM[k] for k in launched}
    want["K1"] += val_forwards * K1_PER_FORWARD
    want["K2"] += val_forwards * K2_PER_FORWARD
    check(launched == want, f"MoE trainer launches {launched}, expected {want}")
    last = ckpt.auto_resume_helper(run.ckpt_dir)
    timing = run.epoch_timings[0]
    summary = run.metrics.phase_summary("val")
    print(f"[{card}] mFormerV1_sm_moe upcycled by the CLI's Trainer (built in {build_s:.1f} s; "
          f"{n_banks} banks bit for bit the dense twin's MLP) and trained 1 epoch on phase 7c's "
          f"dataset: {steps} steps, {n_gn} GradNorm updates, median step "
          f"{timing['median_step_ms']:.2f} ms (cold epoch), validation loss "
          f"{summary['loss']:.4f}, moe_aux {rows[steps]['train/moe_aux']:.4f}, moe_z "
          f"{rows[steps]['train/moe_z']:.3f}, moe_drop_frac {rows[steps]['train/moe_drop_frac']:.4f} "
          f"at the last step; launches {launched} (expected {want}); peak {peak:.2f} GiB; "
          f"{train_s:.1f} s", flush=True)

    # (d) the handler from the checkpoint directory
    bundle_dir = os.path.join(d, "bundle_moe")
    prepare_bundle(last, run.config.ENV.OUTPUT.DIRS.ASSETS, bundle_dir, "mFormerV1_sm",
                   list(TASKS), [run.num_classes[t] for t in TASKS], image_size=IMG)
    variant = os.path.join(bundle_dir, "variant.yaml")
    with open(variant, "w") as f:
        yaml.safe_dump({"MODEL": json.loads(json.dumps(run.config.MODEL)), "TRAIN": {
            "MIXED_PRECISION": json.loads(json.dumps(run.config.TRAIN.MIXED_PRECISION))}}, f)
    with open(os.path.join(bundle_dir, "config.yaml")) as f:
        bundle_cfg = yaml.safe_load(f)
    bundle_cfg["model"]["architecture_variant_config_path"] = variant
    bundle_cfg["model"]["weights_path"] = os.path.abspath(last)
    config_path = os.path.join(bundle_dir, "config_dir.yaml")
    with open(config_path, "w") as f:
        yaml.safe_dump(bundle_cfg, f, sort_keys=False)
    handler = LinnaeusInferenceHandler.load_from_artifacts(config_path)
    check(handler.model.moe_num_experts == 8 and handler.model.dtype == torch.bfloat16,
          "the handler serves the MoE checkpoint in bf16")
    g = torch.Generator(device=dev).manual_seed(MOE_SEED + 2)
    x = torch.randn(BATCH, IMG, IMG, 3, generator=g, device=dev)
    aux = torch.randn(BATCH, handler.config.aux_vector_length(), generator=g, device=dev)
    run.model.eval()
    with torch.inference_mode():
        a, b = handler.model(x, aux), run.model(x, aux)
    check(all(torch.equal(a[t], b[t]) for t in TASKS),
          "the handler's logits from the checkpoint directory equal the checkpoint's model's "
          "bit for bit")
    del handler
    gc.collect()

    # (e) the export to the reference layout, loaded strict into mFormerV1_sm
    out = os.path.join(d, "moe_reference.pth")
    export_main(["--cfg", cfg_path, "--checkpoint", last, "--out", out])
    exported = torch.load(out, weights_only=True)
    with open(cfg_path) as f:
        dense_cfg = yaml.safe_load(f)
    dense_cfg["MODEL"]["BASE"] = [os.path.abspath("configs/model/archs/mFormerV1_sm.yaml")]
    del dense_cfg["MODEL"]["PRETRAINED_CONVNEXT"], dense_cfg["MODEL"]["PRETRAINED_ROPEVIT"]
    dense_path = os.path.join(d, "dense_twin.yaml")
    with open(dense_path, "w") as f:
        yaml.safe_dump(dense_cfg, f)
    from linnaeus_tpu_torch.configuration import build_config

    dense = build_model(build_config(dense_path), run.num_classes, device=dev, seed=MOE_SEED)
    check(not dense.moe_num_experts, "the export's target is the dense mFormerV1_sm")
    dense.load_state_dict(exported, strict=True)
    with torch.inference_mode():
        logits = dense(x, aux)
    check(all(torch.isfinite(logits[t]).all() for t in TASKS),
          "the exported weights load strict into mFormerV1_sm and its forward runs")
    # the bank's mean on the card against the export's on the host: two
    # summation orders, so within a few float32 roundings of the largest entry
    mean = run.model.state_dict()["stages.2.1.mlp.wi"].float().mean(0).t().cpu()
    err = max_err(exported["stages.2.1.mlp.fc1.weight"], mean)
    check(err <= 1e-6 * mean.abs().max().item(), f"the export holds each bank's mean: {err}")
    print(f"MoE checkpoint {os.path.basename(last)} served by the handler from its directory, "
          f"logits bit for bit the checkpoint's model's on {BATCH} images; exported by "
          f"tools/export_torch.py ({len(exported)} tensors, the dense twin with each bank "
          f"averaged): loads strict into mFormerV1_sm, forward finite", flush=True)
    del run, dense, exported
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launched, "steps": steps, "median_step_ms": timing["median_step_ms"],
            "peak_gib": peak, "train_s": train_s}


def moe_phase(dev, card, fa, fm, trainer: dict) -> dict:
    """Phase 7g: (a) serving, (b) steps, (c) upcycling through the CLI, (d)
    serving the checkpoint, (e) the export. K1 and K2 launch on the MoE path
    as on mFormerV1_sm's; K3 does not."""
    t0 = time.perf_counter()
    served = moe_serve(dev, card, fa, fm)
    steps = moe_steps(dev, card, fa, fm)
    cli = moe_cli(dev, card, fa, fm, trainer)
    seconds = time.perf_counter() - t0
    print(f"phase 7g (mFormerV1_sm_moe) took {seconds:.1f} s", flush=True)
    return {"serve": served, "steps": steps, "cli": cli, "seconds": seconds,
            "launches": {"K1": served["launches"]["K1"], "K2": served["launches"]["K2"],
                         **{k: steps["on"]["launches"][k]
                            for k in ("K1_bwd", "K1_dq", "K1_dkv", "K2_bwd")}}}


# ---------------------------------------------------------------------------
# phase 7f: phase 1 to phase 2 on the receipt data (tools/e2e_train_bench,
# the CLI with the kernels on and off, tools/train_run_receipt, rl/)
RECEIPT_CFG = "configs/experiments/tpu_trainrun_synth_384.yaml"
RL_CFG = "configs/experiments/rl_abstention_384.yaml"
RECEIPT_OBS, RECEIPT_NULL_FRAC = 1024, 0.1  # cut from 8,192 (phase 1) and 2,048 (phase 2)
# species cut with the samples, so that a species holds about as many samples
# as in the full run (8,192 / 999): the 'mixed-pairs' sampler pairs samples of
# one genus (here one species a genus), and 1,024 samples of 999 species
# hold almost no pair
RECEIPT_SPECIES = 125
RECEIPT_EPOCHS = 2  # cut from 8
RECEIPT_WARMUP_STEPS = 8  # cut from 150 with the steps: 24 of the full run's 896
# val loss kernels on vs off at the last step: the two runs differ only where
# bf16 rounds (the first step's loss within TRAIN_LOSS_RTOL), from the same
# seed, data and draws; over 24 AdamW steps the roundings compound into the
# parameters but stay far below the change the steps make (the loss falls by
# more than 10%), so a tenth of that change is the bar. It holds for this
# cut only: over the full run's 896 steps the trajectories part (two runs
# with the kernels on, one seed, differ by up to 0.8%), and the full-size bar
# in PERF.md is set from that spread.
RECEIPT_VAL_RTOL = 1e-2
RL_ITERATIONS, RL_ROLLOUT, RL_EVAL, RL_PRIOR = 2, 128, 64, 0.2  # iterations cut from 30
# the shapes no earlier phase launched: the rollout's one image (K1 forward
# at B=1, K2 forward at 96x96 and 48x48 rows) and the PPO update's whole
# rollout as one batch (K1 backward and K2 forward and backward at
# B=128)
K1_SHAPES_B1 = [(1, 580, 6, 64), (1, 148, 12, 64)]
K1_SHAPES_B128 = [(RL_ROLLOUT, 580, 6, 64), (RL_ROLLOUT, 148, 12, 64)]
K2_SHAPES_B1 = [(96 * 96, 96), (48 * 48, 192)]
K2_SHAPES_B128 = [(RL_ROLLOUT * 96 * 96, 96), (RL_ROLLOUT * 48 * 48, 192)]


def _k2_operands(g, dev, M, C, dt):
    y, x = (torch.randn(M, C, generator=g, device=dev).to(dt) for _ in range(2))
    vec = lambda n, s, m=0.0: m + s * torch.randn(n, generator=g, device=dev)  # noqa: E731
    ln_w, ln_b, b1, b2, gamma = vec(C, 0.1, 1.0), vec(C, 0.1), vec(4 * C, 0.1), vec(C, 0.1), vec(C, 0.1, 0.5)
    w1 = (0.1 * torch.randn(4 * C, C, generator=g, device=dev)).to(dt)
    w2 = (0.1 * torch.randn(C, 4 * C, generator=g, device=dev)).to(dt)
    return y, x, (ln_w, ln_b, w1, b1, w2, b2, gamma)


def check_receipt_shapes(dev, fa, fm) -> dict:
    """K1 forward and K2 forward at the rollout's B=1, K1's backward
    and K2 forward and backward at the PPO update's B=128, bf16, each
    against its plain version at the kernel bars; times, bounds and the
    library call. Returns per-kernel lists of timed records."""
    dt = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    rec = {"K1": [], "K1_bwd": [], "K2": [], "K2_bwd": []}
    for B, N, H, D in K1_SHAPES_B1 + K1_SHAPES_B128:
        q, k, v = torch.randn(B, N, 3, H, D, generator=g, device=dev).to(dt).unbind(2)
        out, lse = fa.flash_attention_fwd(q, k, v)
        ref, ref_lse = fa.flash_attention_reference(q, k, v)
        err = max(max_err(out, ref), max_err(lse, ref_lse))
        ms, spread = cuda_ms_median(lambda: fa.flash_attention_fwd(q, k, v))
        plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v))
        lib_ms = sdpa_ms(q, k, v)
        b = k1_bound((B, N, H, D), dt, False)
        print(f"K1 flash_attention_fwd bf16 (B,N,H,D)={(B, N, H, D)}: max|err| {err:.3e} "
              f"(tol {K1_TOL[dt]:g}), kernel {ms:.4f} ms (spread {spread:.4f}), plain "
              f"{plain_ms:.3f} ms, F.scaled_dot_product_attention {lib_ms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']})", flush=True)
        check(err <= K1_TOL[dt], f"K1 {(B, N, H, D)} error {err}")
        rec["K1"].append(dict(shape=[B, N, H, D], max_abs_err=err, ms=ms, ms_spread=spread,
                              plain_ms=plain_ms, library_ms=lib_ms, **b))
        if B == 1:
            continue
        do = torch.randn(B, N, H, D, generator=g, device=dev).to(dt)
        got = fa._launch_bwd(q, k, v, out, lse, do, D ** -0.5)
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do)
        torch.cuda.synchronize()
        err = max(rel_err(a, w) for a, w in zip(got, want))
        abs_err = max(max_err(a, w) for a, w in zip(got, want))
        del want
        ms, spread = cuda_ms_median(lambda: fa._launch_bwd(q, k, v, out, lse, do, D ** -0.5))
        plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, do),
                           iters=3)
        lib_ms = sdpa_ms(q, k, v, do)
        b = k1_bound((B, N, H, D), dt, True)
        print(f"K1 flash_attention_bwd bf16 (B,N,H,D)={(B, N, H, D)}: max rel err {err:.3e} "
              f"(tol {BWD_TOL[dt]:g}), kernel {ms:.4f} ms (spread {spread:.4f}), plain "
              f"{plain_ms:.3f} ms, F.scaled_dot_product_attention backward {lib_ms:.4f} ms, "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})", flush=True)
        check(all(torch.isfinite(t).all().item() for t in got) and err <= BWD_TOL[dt],
              f"K1 bwd {(B, N, H, D)} error {err}")
        rec["K1_bwd"].append(dict(shape=[B, N, H, D], max_abs_err=abs_err, ms=ms,
                                  ms_spread=spread, plain_ms=plain_ms, library_ms=lib_ms, **b))
        del q, k, v, out, lse, do, got
    for M, C in K2_SHAPES_B1 + K2_SHAPES_B128:
        y, x, params = _k2_operands(g, dev, M, C, dt)
        args = (y, x, *params)
        out = fm.fused_convnext_mlp(*args)
        ref = fm.fused_convnext_mlp_reference(*args, 1e-6, True)
        err = max_err(out, ref)
        del ref
        iters = 50 if M < 100_000 else 10
        ms, spread = cuda_ms_median(lambda: fm.fused_convnext_mlp(*args), iters=iters)
        plain_ms = cuda_ms(lambda: fm.fused_convnext_mlp_reference(*args, 1e-6, True), iters=3)
        chain_ms = mlp_chain_ms(y, x, *params)
        b = k2_bound((M, C), dt, False)
        print(f"K2 fused_convnext_mlp bf16 (M,C)={(M, C)} residual=True ({fm.forward_kernel(C, dt)}): "
              f"max|err| {err:.3e} (tol {K2_TOL[dt]:g}), kernel {ms:.4f} ms (spread {spread:.4f}), "
              f"plain {plain_ms:.3f} ms, the bf16 library chain {chain_ms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']})", flush=True)
        check(torch.isfinite(out).all().item() and err <= K2_TOL[dt], f"K2 {(M, C)} error {err}")
        rec["K2"].append(dict(shape=[M, C], max_abs_err=err, ms=ms, ms_spread=spread,
                              plain_ms=plain_ms, library_ms=None, library_chain_ms=chain_ms, **b))
        del out
        if M < 100_000:
            continue
        bargs = (y, x, *params, 1e-6, True)  # x as dout
        got = fm._launch_bwd(*bargs)
        again = fm._launch_bwd(*bargs)
        want = fm.fused_convnext_mlp_bwd_reference(*bargs)
        torch.cuda.synchronize()
        same = all(torch.equal(a, w) for a, w in zip(got, again))
        del again
        err = max(rel_err(a, w) for a, w in zip(got, want))
        abs_err = max_err(got[0], want[0])
        del want
        ms, spread = cuda_ms_median(lambda: fm._launch_bwd(*bargs), iters=3)
        plain_ms = cuda_ms(lambda: fm.fused_convnext_mlp_bwd_reference(*bargs), iters=2)
        b = k2_bound((M, C), dt, True)
        print(f"K2 fused_convnext_mlp_bwd bf16 (M,C)={(M, C)} ({fm.backward_kernel(C, dt)}): "
              f"max rel err {err:.3e} (tol {BWD_TOL[dt]:g}), max|err dy| {abs_err:.3e}, "
              f"bit-identical over two launches: {same}, kernel {ms:.3f} ms (spread {spread:.3f}), "
              f"plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})",
              flush=True)
        check(all(torch.isfinite(t).all().item() for t in got) and err <= BWD_TOL[dt] and same,
              f"K2 bwd {(M, C)} error {err}, same bits {same}")
        rec["K2_bwd"].append(dict(shape=[M, C], max_abs_err=abs_err, ms=ms, ms_spread=spread,
                                  plain_ms=plain_ms, library_ms=None, **b))
        del got, y, x, params
        gc.collect()
        torch.cuda.empty_cache()
    return rec


def _launch_counts(fa, fm, fb) -> dict:
    return {"K1": fa.LAUNCHES, "K1_bwd": fa.BWD_LAUNCHES, "K1_dq": fa.DQ_LAUNCHES,
            "K1_dkv": fa.DKV_LAUNCHES, "K2": fm.LAUNCHES, "K2_bwd": fm.BWD_LAUNCHES,
            "K3": fb.LAUNCHES}


def _zero_counts(fa, fm, fb) -> None:
    fa.LAUNCHES = fa.BWD_LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
    fm.LAUNCHES = fm.BWD_LAUNCHES = 0
    fb.LAUNCHES = 0


def _val_loss(receipt: dict) -> tuple[int, float]:
    last = [v for v in receipt["validation"] if v["phase"] == "val"][-1]
    return last["step"], last["loss"]


def receipt_train(dev, card, d: str, data_opts: list, kernels: bool, fa, fm, fb) -> dict:
    """Phase 1 of phase 7f: the CLI on the receipt experiment, kernels on or
    off, then its receipt through tools/train_run_receipt."""
    import os

    from linnaeus_tpu_torch.tools import train_run_receipt
    from linnaeus_tpu_torch.train.main import main as train_main

    name = "tpu_trainrun_synth_384" if kernels else "tpu_trainrun_synth_384_off"
    off = [] if kernels else ["MODEL.USE_FLASH_ATTN", "False", "MODEL.FUSED_CONVNEXT_MLP", "off"]
    before = _launch_counts(fa, fm, fb)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer = train_main(["--cfg", RECEIPT_CFG, "--device", str(dev), "--opts", *data_opts,
                          "EXPERIMENT.NAME", name, "TRAIN.EPOCHS", str(RECEIPT_EPOCHS),
                          "LR_SCHEDULER.WARMUP_STEPS", str(RECEIPT_WARMUP_STEPS),
                          "SCHEDULE.METRICS.WANDB_INTERVAL", "1", *off])
    seconds = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in _launch_counts(fa, fm, fb).items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    run_dir = trainer.config.ENV.OUTPUT.DIRS.EXP_BASE
    ckpt_dir, spe = trainer.ckpt_dir, trainer.steps_per_epoch
    steps = trainer.progress.global_step
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    receipt = train_run_receipt.build_receipt(run_dir)
    path = os.path.join(d, f"{name}.json")
    with open(path, "w") as f:
        json.dump(receipt, f, indent=1)
    curve = [loss for _, loss in receipt.get("loss_curve", [])]
    check(receipt.get("device") == card and receipt.get("backend") == "cuda",
          f"the receipt's device {receipt.get('device')}")
    check(receipt.get("steps") == steps == RECEIPT_EPOCHS * spe and len(curve) == steps
          and all(np.isfinite(curve)), f"{name}: a finite loss at each of {steps} steps")
    check(len(receipt.get("epochs", [])) == RECEIPT_EPOCHS
          and receipt.get("img_per_sec_steady", 0) > 0
          and receipt.get("model_params", 0) > 0
          and receipt.get("checkpoint_saves") == RECEIPT_EPOCHS + 1
          and [v["step"] for v in receipt.get("validation", []) if v["phase"] == "val"]
          == [(e + 1) * spe for e in range(RECEIPT_EPOCHS)],
          f"{name}: the receipt carries every field: "
          f"{ {k: v for k, v in receipt.items() if k != 'loss_curve'} }")
    head, tail = float(np.mean(curve[:4])), float(np.mean(curve[-4:]))
    check(tail < head, f"{name}: the loss falls ({head:.4f} over the first 4 steps, "
          f"{tail:.4f} over the last 4)")
    step, val = _val_loss(receipt)
    print(f"[{card}] phase 1, kernels {'on' if kernels else 'off'}: {steps} steps "
          f"({RECEIPT_EPOCHS} epochs of {spe}) in {seconds:.1f} s, "
          f"{receipt['img_per_sec_steady']} img/s (the receipt's steady epochs), loss "
          f"{head:.4f} -> {tail:.4f} (means of the first and last 4 steps), val loss "
          f"{val:.4f} at step {step}, peak {peak:.2f} GiB, launches {launched}; receipt "
          f"{path}", flush=True)
    return {"receipt": receipt, "launches": launched, "seconds": seconds, "ckpt_dir": ckpt_dir,
            "val_loss": val, "val_step": step, "peak_gib": peak, "path": path}


def receipt_phase(dev, card, fa, fm, fb) -> dict:
    """Phase 7f: the receipt data (hybrid), phase 1 with the kernels on and
    off, phase 2 (PPO abstention fine-tuning) from the kernels-on
    checkpoint; the kernels at the phase's new shapes before it, the
    launches counted over the phase from zero. The checks are listed in
    the module docstring."""
    import os
    import tempfile

    from linnaeus_tpu_torch.rl import PPOConfig, train_abstention_ppo
    from linnaeus_tpu_torch.rl import train_abstention
    from linnaeus_tpu_torch.tools import e2e_train_bench
    from linnaeus_tpu_torch.utils.device import busy_window, profile_events

    start = time.perf_counter()
    shapes = check_receipt_shapes(dev, fa, fm)
    os.environ["CONFIG_DIR"] = os.path.dirname(os.path.abspath(__file__))  # MODEL.BASE paths
    d = tempfile.mkdtemp(prefix="receipt_", dir="build")
    t0 = time.perf_counter()
    labels, images = e2e_train_bench.generate_dataset(
        os.path.join(d, "data"), RECEIPT_OBS, IMG, learnable=True,
        null_frac=RECEIPT_NULL_FRAC, species=RECEIPT_SPECIES, hybrid=True)
    gen_s = time.perf_counter() - t0
    print(f"phase 7f: the receipt data, {RECEIPT_OBS} samples at {IMG} px (learnable, "
          f"{RECEIPT_SPECIES} species (of 999), null_frac {RECEIPT_NULL_FRAC}), JPEGs and .npz "
          f"labels written in {gen_s:.1f} s; "
          f"cut: {RECEIPT_EPOCHS} epochs (of 8), warm-up {RECEIPT_WARMUP_STEPS} steps (of 150), "
          f"{RL_ITERATIONS} PPO iterations (of 30), {RL_EVAL} eval samples (of 384)", flush=True)
    data_opts = ["DATA.H5.LABELS_PATH", labels, "DATA.HYBRID.USE_HYBRID", "True",
                 "DATA.HYBRID.IMAGES_DIR", images, "DATA.HYBRID.FILE_EXTENSION", ".jpg",
                 "ENV.OUTPUT.BASE_DIR", os.path.join(d, "out")]

    _zero_counts(fa, fm, fb)
    on = receipt_train(dev, card, d, data_opts, True, fa, fm, fb)
    off = receipt_train(dev, card, d, data_opts, False, fa, fm, fb)
    check(all(on["launches"][k] > 0 for k in ("K1", "K1_bwd", "K2", "K2_bwd"))
          and sum(off["launches"].values()) == 0,
          f"phase 1 launches: kernels on {on['launches']}, off {off['launches']}")
    gap = abs(on["val_loss"] - off["val_loss"]) / abs(off["val_loss"])
    print(f"[{card}] phase 1 val loss at step {on['val_step']}: kernels on "
          f"{on['val_loss']:.6f}, off {off['val_loss']:.6f}, relative gap {gap:.3e} (bar "
          f"{RECEIPT_VAL_RTOL:g})", flush=True)
    check(on["val_step"] == off["val_step"] and gap <= RECEIPT_VAL_RTOL,
          f"val loss kernels on vs off: gap {gap}")

    before = _launch_counts(fa, fm, fb)
    rl_receipt = os.path.join(d, "rl_abstention.json")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    run = train_abstention.run([
        "--cfg", RL_CFG, "--checkpoint", on["ckpt_dir"], "--iterations", str(RL_ITERATIONS),
        "--rollout-steps", str(RL_ROLLOUT), "--eval-samples", str(RL_EVAL),
        "--abstain-prior", str(RL_PRIOR), "--receipt", rl_receipt, "--device", str(dev),
        "--opts", *data_opts])
    rl_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    rl_launches = {k: v - before[k] for k, v in _launch_counts(fa, fm, fb).items()}
    with open(rl_receipt) as f:
        receipt = json.load(f)
    keys = {"device", "backend", "mode", "iterations", "steps_per_rollout", "abstain_prior",
            "warm_start", "reward_curve", "reward_first", "reward_last", "ppo_metrics_last",
            "eval_before", "eval_after"}
    numbers = [v for _, v in receipt.get("reward_curve", [])] + list(
        receipt.get("ppo_metrics_last", {}).values())
    check(keys <= set(receipt) and receipt["device"] == card
          and receipt["warm_start"] is not None
          and len(receipt["reward_curve"]) == RL_ITERATIONS and all(np.isfinite(numbers))
          and all(receipt[e]["samples"] >= RL_EVAL and set(receipt[e]["per_rank"]) == set(TASKS)
                  for e in ("eval_before", "eval_after")),
          f"the RL receipt is complete and finite: {receipt}")
    state = torch.load(run.policy_path, map_location="cpu", weights_only=True)
    check(all(torch.equal(state[k], v.cpu()) for k, v in run.policy.state_dict().items())
          and set(state) == set(run.policy.state_dict()),
          "the saved policy holds the trained policy's tensors")
    run.policy.load_state_dict(state, strict=True)
    action_ms = [t["rollout_ms_per_action"] for t in run.timings]
    update_ms = [t["update_ms_per_epoch"] for t in run.timings]
    # one more iteration under torch.profiler: the phase's device-busy share
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        train_abstention_ppo(run.policy, run.env, PPOConfig(), num_iterations=1,
                             steps_per_rollout=RL_ROLLOUT)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms = busy_window(profile_events(prof))[0]
    run.close()
    phase2 = {k: v - before[k] for k, v in _launch_counts(fa, fm, fb).items()}
    print(f"[{card}] phase 2 (PPO, mFormerV1_sm {IMG} px bf16 from the kernels-on "
          f"checkpoint): {RL_ITERATIONS} iterations of {RL_ROLLOUT} actions in {rl_s:.1f} s "
          f"(with the checkpoint's load and the two evals); rollout "
          f"{', '.join(f'{v:.2f}' for v in action_ms)} ms an action (B=1, host clock: each "
          f"action is read back); PPO update {', '.join(f'{v:.2f}' for v in update_ms)} ms an "
          f"epoch (B={RL_ROLLOUT}, CUDA events); peak {peak:.2f} GiB; reward "
          f"{receipt['reward_first']} -> {receipt['reward_last']}; eval before "
          f"{ {k: receipt['eval_before'][k] for k in ('abstain_rate', 'abstain_precision', 'abstain_recall', 'mean_p_abstain_on_null', 'mean_p_abstain_on_known')} }, "
          f"after { {k: receipt['eval_after'][k] for k in ('abstain_rate', 'abstain_precision', 'abstain_recall', 'mean_p_abstain_on_null', 'mean_p_abstain_on_known')} }; "
          f"one more iteration under torch.profiler: {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms, device-busy share {busy_ms / wall_ms:.3f}; launches {rl_launches} "
          f"(+ the profiled iteration: {phase2})", flush=True)
    total = _launch_counts(fa, fm, fb)
    check(all(total[k] > 0 for k in ("K1", "K1_bwd", "K2", "K2_bwd"))
          and total["K1_dq"] == total["K1_dkv"] == total["K1_bwd"] and total["K3"] == 0,
          f"phase 7f launches {total}: K1 and K2 forward and backward (one dQ and one dK/dV "
          "launch a K1 backward), not K3")
    check(rl_launches["K1_bwd"] > 0 and rl_launches["K2_bwd"] > 0,
          f"the PPO update ran K1's and K2's backward: {rl_launches}")
    shutil.rmtree(d, ignore_errors=True)
    seconds = time.perf_counter() - start
    print(f"phase 7f (phase 1 to phase 2) took {seconds:.1f} s; launches over the phase "
          f"{total}", flush=True)
    return {"launches": total, "shapes": shapes, "on": on, "off": off, "gap": gap,
            "rl": receipt, "seconds": seconds}


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


def serving_tree():
    """A seeded random taxonomy over the four tasks (fine -> coarse): every
    class but the null class 0 gets a parent among the next coarser rank's
    classes; taxon ids are 100000 * rank + class index. Returns the tree
    and the class map as a bundle's class_map.json holds it."""
    from linnaeus_tpu_torch.utils.taxonomy import TaxonomyTree

    rng = np.random.default_rng(SEED + 7)
    keys = list(TASKS)
    hierarchy = {child: {c: int(rng.integers(1, TASKS[parent])) for c in range(1, TASKS[child])}
                 for child, parent in zip(keys[:-1], keys[1:])}
    tree = TaxonomyTree(hierarchy, keys, dict(TASKS))
    raw = {t: {str(i): 100000 * int(t.split("_L")[1]) + i for i in range(n)}
           for t, n in TASKS.items()}
    return tree, raw


def serving_taxonomy(cfg):
    """The handler's taxonomy data and class maps of :func:`serving_tree`."""
    from linnaeus_tpu_torch.inference.artifacts import class_index_maps, taxonomy_data

    tree, raw = serving_tree()
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


# bf16 agreement of an answer served over HTTP with handler.predict on the
# same bytes: the batcher collates requests into another batch bucket than
# the direct call, and the library's matrix products and convolutions pick
# other algorithms for other shapes, so logits move by a few bf16 steps
PROB_TOL = 2e-2
# 256 requests of 1,024 images a run, some seconds of traffic: enough for a
# rate and a p99 (the 99th percentile of 256 latencies, not their largest)
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_IMAGES = 8, 32, 4


def write_bundle(d, dev) -> dict:
    """A bundle in directory ``d``: config.yaml (mFormerV1_sm at IMG px,
    the four tasks, TEMPORAL + SPATIAL + ELEVATION metadata, every inference
    option at its default but the batch size, the variant named by an
    absolute path), variant.yaml (K1 on, HierarchicalSoftmax heads for every
    task), taxonomy.json, class_map.json and weights.pt, the state_dict of
    the model the config form builds from these files with a fixed seed.
    Returns that model."""
    import yaml

    from linnaeus_tpu_torch.inference.config import InferenceOptionsConfig, load_inference_config
    from linnaeus_tpu_torch.inference.model_utils import build_config_for_inference
    from linnaeus_tpu_torch.models.build import build_model

    tree, raw = serving_tree()
    tree.save(str(d / "taxonomy.json"))
    (d / "class_map.json").write_text(json.dumps(raw))
    (d / "variant.yaml").write_text(yaml.safe_dump({"MODEL": {
        "USE_FLASH_ATTN": True,
        "CLASSIFICATION": {"HEADS": {t: {"TYPE": "HierarchicalSoftmax"} for t in TASKS}}}}))
    (d / "config.yaml").write_text(yaml.safe_dump({
        "model": {"architecture_name": "mFormerV1_sm",
                  "architecture_variant_config_path": str(d / "variant.yaml"),
                  "weights_path": "weights.pt",
                  "model_task_keys_ordered": list(TASKS),
                  "num_classes_per_task": list(TASKS.values()),
                  "null_class_indices": {t: 0 for t in TASKS}},
        "input_preprocessing": {"image_size": [3, IMG, IMG]},
        "metadata_preprocessing": {"use_temporal": True, "use_geolocation": True,
                                   "use_elevation": True},
        "taxonomy_data": {"source_name": "synthetic", "taxonomy_tree_path": "taxonomy.json",
                          "class_index_map_path": "class_map.json"},
        "inference_options": {"batch_size": BATCH},
    }))
    cfg = load_inference_config(d / "config.yaml")
    check(cfg.inference_options == InferenceOptionsConfig(batch_size=BATCH),
          "the bundle keeps every inference option at its default but the batch size")
    model = build_model(build_config_for_inference(cfg), dict(TASKS), tree, device=dev,
                        seed=SEED + 9)
    torch.save(model.state_dict(), d / "weights.pt")
    return model


def encoded_requests(rng, formats=("PNG", "JPEG")) -> list[dict]:
    """SERVE_CLIENTS x SERVE_REQUESTS /predict bodies of SERVE_IMAGES
    base64 images each, with metadata, the ``formats`` taking turns (by
    default JPEG and PNG alternating within every request)."""
    import base64
    import io

    from PIL import Image

    bodies = []
    for r in range(SERVE_CLIENTS * SERVE_REQUESTS):
        images, metas = requests(SERVE_IMAGES, rng)
        instances = []
        for i, (image, meta) in enumerate(zip(images, metas)):
            buf = io.BytesIO()
            fmt = formats[(r + i) % len(formats)]
            Image.fromarray(image).save(buf, fmt, **({"quality": 90} if fmt == "JPEG" else {}))
            instances.append({"image": base64.b64encode(buf.getvalue()).decode(),
                              "metadata": meta})
        bodies.append({"instances": instances})
    return bodies


def as_result(payload: dict):
    """An answer's JSON back into the handler's result dataclasses."""
    from linnaeus_tpu_torch.inference.schemas import HierarchicalClassificationResult, TaskPrediction

    return HierarchicalClassificationResult(
        taxonomy_context=payload["taxonomy_context"],
        tasks=[TaskPrediction(t["rank_level"], t["task_key"],
                              [(int(i), float(p)) for i, p in t["predictions"]])
               for t in payload["tasks"]])


def agreement(got, want, raw, maps) -> tuple[int, float]:
    """An HTTP answer ``got`` against ``handler.predict`` of the same bytes
    (``want``; ``raw`` the same without the consistency pass), coarse to
    fine: every taxon both list within PROB_TOL; a different top-1 must be a
    near tie in ``raw`` (the HTTP top-1 within PROB_TOL of the direct one);
    a task nulled by the consistency pass on one side only must sit at or
    below such a near tie. Returns (flips, largest probability difference)."""
    flips, worst, tie_above = 0, 0.0, False
    for g, w, r in sorted(zip(got.tasks, want.tasks, raw.tasks), key=lambda x: -x[0].rank_level):
        null = [(maps.null_taxon_ids[g.rank_level], 1.0)]
        rp = dict(r.predictions)
        tie_here = r.predictions[0][1] - r.predictions[1][1] <= PROB_TOL
        if g.predictions == null or w.predictions == null:
            check(g.predictions == w.predictions or tie_here or tie_above,
                  f"{g.task_key}: nulled on one side only, with no near tie: {g} / {w} / {r}")
            flips += g.predictions != w.predictions
        else:
            gp, wp = dict(g.predictions), dict(w.predictions)
            for taxon in gp.keys() & wp.keys():
                worst = max(worst, abs(gp[taxon] - wp[taxon]))
            top = g.predictions[0][0]
            if top != w.predictions[0][0]:
                check(top in rp and r.predictions[0][1] - rp[top] <= PROB_TOL,
                      f"{g.task_key}: top-1 {top} over HTTP, {w.predictions[0][0]} direct, "
                      f"not a near tie: {r.predictions}")
                flips += 1
        tie_above = tie_above or tie_here
    check(worst <= PROB_TOL, f"HTTP vs direct probabilities differ by {worst}")
    return flips, worst


def predict_breakdown(handler, images, metas, card) -> dict:
    """The host side of one ``predict`` of these images, step by step as
    ``predict_async`` runs it: preprocessing (decode, resize, metadata), the
    upload, the forward (CUDA events), the fetch, and the results with the
    consistency pass; the pass is timed once more alone on those results."""
    from linnaeus_tpu_torch.inference.postprocessing import enforce_hierarchical_consistency
    from linnaeus_tpu_torch.inference.preprocessing import (
        preprocess_image_batch,
        preprocess_metadata_batch,
    )

    k = handler.config.inference_options.default_top_k
    ms = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pixels = preprocess_image_batch(images, handler.config)
    aux = preprocess_metadata_batch(metas, len(images), handler.config)
    t1 = time.perf_counter()
    x = torch.from_numpy(pixels).to(handler.device, non_blocking=True)
    a = torch.from_numpy(aux).to(handler.device, non_blocking=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = handler._forward(x, a, k)
    end.record()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    packed = out.cpu().numpy()
    t4 = time.perf_counter()
    results = [handler._build_result(row, k) for row in packed]
    t5 = time.perf_counter()
    for r in results:
        enforce_hierarchical_consistency(r, handler.taxonomy, handler.class_maps)
    t6 = time.perf_counter()
    ms = {"preprocess": 1e3 * (t1 - t0), "upload": 1e3 * (t2 - t1),
          "forward_events": start.elapsed_time(end), "forward_wall": 1e3 * (t3 - t2),
          "fetch": 1e3 * (t4 - t3), "results_and_pass": 1e3 * (t5 - t4),
          "pass_alone": 1e3 * (t6 - t5)}
    torch.cuda.synchronize()
    t7 = time.perf_counter()
    handler.predict(images, metas)
    ms["predict"] = 1e3 * (time.perf_counter() - t7)
    print(f"[{card}] host side of one predict of {len(images)} encoded images, ms: "
          + ", ".join(f"{name} {v:.3f}" for name, v in ms.items()), flush=True)
    return ms


# ---------------------------------------------------------------------------
# phase 7h: the host data plane (linnaeus_tpu_torch/native/): the batched
# JPEG decode with DCT prescale and area resize, in threads off the GIL
DP_SIZES = [(640, 480), (1024, 768), (2048, 1536), (4032, 3024)]  # photo sizes, width x height
DP_PIL_BAR, DP_NORM_BAR = 3.0, 0.05  # tests/test_native_dataplane.py:59 and :251, mean |diff|
DP_LOADER_FILES, DP_LOADER_SIZE = 2048, (1024, 768)  # 28 batches in the train split's epoch
DP_LOADER_DISTINCT = 128  # images among the loader's files (numpy's draws hold the GIL)


def photo_jpegs(n: int, seed: int) -> tuple[list[bytes], list[str]]:
    """``n`` seeded JPEGs of photo sizes, DP_SIZES in turn (smooth colour
    waves with noise), among them one grayscale, one progressive and one
    smaller than IMG on one side (1024 x 300); made and encoded in threads.
    Returns the bytes and what each is."""
    import io
    import os
    from concurrent.futures import ThreadPoolExecutor

    def one(i):
        w, h = DP_SIZES[i % len(DP_SIZES)]
        kind = {1: "grayscale", 2: "progressive", 3: "short side"}.get(i, "colour")
        if kind == "short side":
            w, h = 1024, 300
        image = photo(w, h, np.random.default_rng((seed, i)))
        if kind == "grayscale":
            image = image.convert("L")
        buf = io.BytesIO()
        image.save(buf, "JPEG", quality=90, progressive=kind == "progressive")
        return buf.getvalue(), f"{w}x{h} {kind}"

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        made = list(pool.map(one, range(n)))
    return [b for b, _ in made], [k for _, k in made]


def photo(w: int, h: int, rng: np.random.Generator):
    """A w x h RGB PIL image: smooth colour waves with noise."""
    from PIL import Image

    freq, phase = rng.uniform(1, 6, (3, 2)), rng.uniform(0, 2 * np.pi, (3, 2))
    xs, ys = np.linspace(0, 1, w, dtype=np.float32), np.linspace(0, 1, h, dtype=np.float32)
    waves = np.stack([127 + 60 * np.sin(2 * np.pi * freq[c, 0] * xs + phase[c, 0])[None, :]
                      + 50 * np.cos(2 * np.pi * freq[c, 1] * ys + phase[c, 1])[:, None]
                      for c in range(3)], -1)
    pixels = np.clip(waves + 8 * rng.standard_normal((h, w, 3), np.float32), 0, 255)
    return Image.fromarray(pixels.astype(np.uint8))


def dataplane_serving(handler, dev, card, fa, fm) -> dict:
    """Phase 7h (a)-(c) under phase 3b's handler. (a) The data plane is
    the cv2 one; BATCH photo-size JPEGs through ``preprocess_image_batch``
    (the data plane) against the per-image PIL path, ``preprocess_image_u8``,
    within the TPU package's bars for every image, in uint8 and normalised;
    the batch decode in the pool, with cv2's own threads at 1, and in the
    calling thread alone. (b) ``predict_breakdown`` of those images through
    the data plane and again with LINNAEUS_TPU_NATIVE=0 (the singleton
    reset), K1 7 and K2 6 launches a forward. (c) Phase 3b's HTTP run with
    JPEG-only requests (the batch decode takes only batches of JPEG bytes)."""
    import os

    import cv2

    import linnaeus_tpu_torch.native as native
    from linnaeus_tpu_torch.inference.preprocessing import (
        preprocess_image_batch,
        preprocess_image_u8,
    )

    phase_start = time.perf_counter()
    plane = native.get_dataplane()
    check(isinstance(plane, native.DataPlane) and plane.version == 3,
          f"the cv2 data plane is selected: {plane}")
    t0 = time.perf_counter()
    jpegs, kinds = photo_jpegs(BATCH, SEED + 50)
    made_s = time.perf_counter() - t0
    mb = sum(len(b) for b in jpegs) / 2**20
    print(f"phase 7h: the host data plane, cv2 {cv2.__version__} (cv2 threads "
          f"{cv2.getNumThreads()}), a pool of {plane.default_threads - 1} workers and the "
          f"caller, os.cpu_count() {os.cpu_count()}; {BATCH} JPEGs of {sorted(set(kinds))} "
          f"({mb:.1f} MiB) made in {made_s:.1f} s", flush=True)

    # (a) against the per-image PIL path
    cfg = handler.config
    _, status = plane.decode_jpeg_mem_batch(jpegs, IMG)
    check((status == 0).all(), f"every photo decodes: {status.tolist()}")
    t0 = time.perf_counter()
    rows = preprocess_image_batch(jpegs, cfg)
    plane_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    pil = np.stack([preprocess_image_u8(b, cfg) for b in jpegs])
    pil_ms = 1e3 * (time.perf_counter() - t0)
    std = np.asarray(cfg.input_preprocessing.image_std, np.float32)
    u8 = np.abs(rows.astype(np.float32) - pil).mean(axis=(1, 2, 3))
    norm = (np.abs((rows.astype(np.float32) - pil) / 255.0 / std)).mean(axis=(1, 2, 3))
    worst = int(np.argmax(u8))
    print(f"[{card}] phase 7h(a): {BATCH} photo JPEGs at {IMG} px, the data plane "
          f"{plane_ms:.1f} ms for the batch, PIL one at a time {pil_ms:.1f} ms; mean |diff| per "
          f"image {u8.min():.3f}..{u8.max():.3f} u8 (bar {DP_PIL_BAR}; worst {kinds[worst]}), "
          f"normalised {norm.min():.4f}..{norm.max():.4f} (bar {DP_NORM_BAR})", flush=True)
    check(u8.max() < DP_PIL_BAR and norm.max() < DP_NORM_BAR,
          "the data plane against PIL within the TPU package's bars")
    # the pool against the calling thread alone, and whether cv2's own
    # threads inside the pool's resizes oversubscribe the host (one
    # decode with them at 1)
    default = cv2.getNumThreads()
    t0 = time.perf_counter()
    plane.decode_jpeg_mem_batch(jpegs, IMG)
    pool_ms = 1e3 * (time.perf_counter() - t0)
    cv2.setNumThreads(1)
    try:
        t0 = time.perf_counter()
        plane.decode_jpeg_mem_batch(jpegs, IMG)
        cv2_one_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        cv2.setNumThreads(default)
    t0 = time.perf_counter()
    plane.decode_jpeg_mem_batch(jpegs, IMG, threads=1)
    serial_ms = 1e3 * (time.perf_counter() - t0)
    print(f"[{card}] phase 7h(a): the batch decode in the pool {pool_ms:.1f} ms with cv2's "
          f"threads at {default} (the process's setting, kept), {cv2_one_ms:.1f} ms at 1; in "
          f"the calling thread alone (threads=1) {serial_ms:.1f} ms", flush=True)

    # (b) the host side of one predict, with and without the data plane
    metas = requests(BATCH, np.random.default_rng(SEED + 51))[1]
    before = plane.mem_batches
    fa.LAUNCHES = fm.LAUNCHES = 0
    on = predict_breakdown(handler, jpegs, metas, card)
    on_launches = {"K1": fa.LAUNCHES, "K2": fm.LAUNCHES}
    check(plane.mem_batches - before == 2, "both preprocessings of the breakdown took the data "
          f"plane: {plane.mem_batches - before} calls")
    saved, env = native._CACHED, os.environ.get("LINNAEUS_TPU_NATIVE")
    os.environ["LINNAEUS_TPU_NATIVE"] = "0"
    native._CACHED = False
    try:
        fa.LAUNCHES = fm.LAUNCHES = 0
        off = predict_breakdown(handler, jpegs, metas, card)
        off_launches = {"K1": fa.LAUNCHES, "K2": fm.LAUNCHES}
        check(native.get_dataplane() is None, "LINNAEUS_TPU_NATIVE=0 turns the data plane off")
    finally:
        native._CACHED = saved
        if env is None:
            del os.environ["LINNAEUS_TPU_NATIVE"]
        else:
            os.environ["LINNAEUS_TPU_NATIVE"] = env
    check(plane.mem_batches - before == 2, "no data-plane call with LINNAEUS_TPU_NATIVE=0")
    want = {"K1": 2 * K1_PER_FORWARD, "K2": 2 * K2_PER_FORWARD}
    check(on_launches == want and off_launches == want,
          f"K1 {K1_PER_FORWARD} and K2 {K2_PER_FORWARD} a forward: {on_launches}, {off_launches}")
    print(f"[{card}] phase 7h(b): one predict of {BATCH} photo JPEGs, mFormerV1_sm {IMG}px bf16, "
          f"ms with the data plane / with PIL (LINNAEUS_TPU_NATIVE=0): preprocessing "
          f"{on['preprocess']:.1f} / {off['preprocess']:.1f}, upload {on['upload']:.2f} / "
          f"{off['upload']:.2f}, forward (CUDA events) {on['forward_events']:.2f} / "
          f"{off['forward_events']:.2f}, the whole predict {on['predict']:.1f} / "
          f"{off['predict']:.1f}; launches a forward K1 {on_launches['K1'] // 2}, K2 "
          f"{on_launches['K2'] // 2}", flush=True)

    # (c) HTTP with JPEG-only requests: the same images as phase 3b's run
    before = plane.mem_batches
    http = serve_http(handler, encoded_requests(np.random.default_rng(SEED + 11), ("JPEG",)),
                      fa, fm, card, "JPEG only")
    calls = plane.mem_batches - before
    # a call for every batch the batcher dispatched, and for each body's two
    # direct predicts (with and without the consistency pass)
    check(calls == http["stats"]["forwards"] + 2 * len(http["bodies"]),
          f"every dispatched batch and every direct predict took the data plane: {calls} calls")
    seconds = time.perf_counter() - phase_start
    print(f"phase 7h (a)-(c) took {seconds:.1f} s", flush=True)
    return {"parity_u8": float(u8.max()), "parity_norm": float(norm.max()),
            "plane_ms": plane_ms, "pil_ms": pil_ms, "pool_ms": pool_ms,
            "cv2_one_thread_ms": cv2_one_ms, "serial_ms": serial_ms,
            "on": on, "off": off, "http": http["stats"], "launches": on_launches}


def loader_phase(dev, card) -> dict:
    """Phase 7h (d): tools/pipeline_benchmark on DP_LOADER_FILES photo-like
    1024 x 768 JPEGs (DP_LOADER_DISTINCT images from ``photo``, encoded in
    threads, each written under DP_LOADER_FILES / DP_LOADER_DISTINCT names
    into the tool's directory, which keeps them; every file is read and
    decoded on its own; the tool writes the labels) at IMG px and
    B = BATCH, one whole epoch a run, the loader on the card, with
    DATA.NATIVE_DATAPLANE 'on' (the bulk path) and 'off' (per sample),
    alternated on, off, off, on."""
    import io
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from linnaeus_tpu_torch.tools import pipeline_benchmark

    os.makedirs("build", exist_ok=True)
    d = tempfile.mkdtemp(prefix="pipebench_", dir="build")
    prefix = os.path.join(d, "pb")
    images_dir = prefix + "_jpegs"  # the tool's layout
    os.makedirs(images_dir)
    w, h = DP_LOADER_SIZE

    def encode(i):
        buf = io.BytesIO()
        photo(w, h, np.random.default_rng((SEED + 52, i))).save(buf, "JPEG", quality=90)
        return buf.getvalue()

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        distinct = list(pool.map(encode, range(DP_LOADER_DISTINCT)))
    for i in range(DP_LOADER_FILES):
        with open(os.path.join(images_dir, f"img_{i:06d}.jpg"), "wb") as f:
            f.write(distinct[i % DP_LOADER_DISTINCT])
    made_s = time.perf_counter() - t0
    runs: dict[str, list] = {}
    for mode in ("on", "off", "off", "on"):
        out = pipeline_benchmark.main([
            "--gen-jpeg", str(DP_LOADER_FILES), "--stored-size", f"{w}x{h}",
            "--img-size", str(IMG), "--batch-size", str(BATCH), "--native", mode,
            "--max-batches", str(DP_LOADER_FILES), "--gen-prefix", prefix,
            "--device", str(dev)])[0]
        # the whole epoch: the train split's (0.9 of the files) full batches
        check(out["bulk_read"] == (mode == "on")
              and out["samples"] == int(0.9 * DP_LOADER_FILES) // BATCH * BATCH,
              f"pipeline_benchmark --native {mode}: {out}")
        runs.setdefault(mode, []).append(out)
    shutil.rmtree(d, ignore_errors=True)
    print(f"[{card}] phase 7h(d): pipeline_benchmark, {DP_LOADER_FILES} photo-like JPEGs of "
          f"{w}x{h} ({DP_LOADER_DISTINCT} distinct, written in {made_s:.1f} s), {out['samples'] // BATCH} batches a run (the "
          f"train split's epoch) at {IMG} px, B={BATCH}, "
          f"the loader on the card: " + "; ".join(
              f"--native {m}: " + ", ".join(f"{r['samples_per_sec']:.1f} img/s (wait "
                                           f"{r['wait_ms_per_batch']:.2f} ms a batch, {r['seconds']:.2f} s)"
                                           for r in runs[m]) for m in ("on", "off")),
          flush=True)
    return runs


def serve_http(handler, bodies, fa, fm, card, what: str) -> dict:
    """Serve ``handler`` through ``tools.serve.make_server`` to SERVE_CLIENTS
    concurrent clients sending ``bodies``; check every answer against the
    tree and against ``handler.predict`` on the same bytes, and K1's and
    K2's launches against the forwards the batcher ran. Returns the
    launches and the measurements (req/s, img/s, p50/p95/p99, the batcher's
    dispatch and finish seconds)."""
    import base64
    import threading
    import urllib.request
    from dataclasses import replace

    from linnaeus_tpu_torch.inference.handler import LinnaeusInferenceHandler
    from linnaeus_tpu_torch.inference.postprocessing import enforce_hierarchical_consistency
    from linnaeus_tpu_torch.tools.serve import make_server
    from linnaeus_tpu_torch.tools.serve_latency_bench import percentile

    # where the batcher's host time goes: its worker thread dispatches
    # (decode, preprocessing, upload, launches) through predict_async and
    # its completion thread runs the finisher (fetch, results, the pass)
    busy = {"dispatch": 0.0, "finish": 0.0}
    dispatch = handler.predict_async

    def timed_dispatch(*args, **kwargs):
        t0 = time.perf_counter()
        finisher = dispatch(*args, **kwargs)
        busy["dispatch"] += time.perf_counter() - t0

        def timed_finish():
            t1 = time.perf_counter()
            try:
                return finisher()
            finally:
                busy["finish"] += time.perf_counter() - t1
        return timed_finish

    handler.predict_async = timed_dispatch
    server = make_server(handler, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]

    def call(path, body=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}",
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json"},
            method="POST" if body is not None else "GET")
        with urllib.request.urlopen(req, timeout=120) as resp:
            check(resp.status == 200, f"{path}: HTTP {resp.status}")
            return json.loads(resp.read())

    try:
        check(call("/healthz") == {"status": "ok"}, "/healthz")
        info = call("/info")
        check(info["architecture_name"] == "mFormerV1_sm" and info["task_keys"] == list(TASKS)
              and info["input_image_size"] == [3, IMG, IMG], f"/info {info}")
        fa.LAUNCHES = fm.LAUNCHES = 0
        answers, latencies, errors = [None] * len(bodies), [], []
        lock = threading.Lock()

        def client(c):
            for r in range(c * SERVE_REQUESTS, (c + 1) * SERVE_REQUESTS):
                t0 = time.perf_counter()
                try:
                    answers[r] = call("/predict", bodies[r])
                except Exception as e:  # noqa: BLE001 counted and failed below
                    with lock:
                        errors.append(repr(e))
                    continue
                with lock:
                    latencies.append(1e3 * (time.perf_counter() - t0))

        threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
        start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - start
        batches = list(server.batcher.batch_sizes)
        launches = {"K1": fa.LAUNCHES, "K2": fm.LAUNCHES}
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.stop()
        del handler.predict_async
    n_images = SERVE_CLIENTS * SERVE_REQUESTS * SERVE_IMAGES
    check(not errors, f"HTTP errors: {errors[:3]}")
    check(sum(batches) == n_images, f"the batcher ran {sum(batches)} images, not {n_images}")
    forwards = len(batches)  # each collated batch (at most 32 images) is one forward
    print(f"served {len(bodies)} /predict requests of {SERVE_IMAGES} images ({what}) from "
          f"{SERVE_CLIENTS} concurrent clients over HTTP: {forwards} forwards of {batches} "
          f"images; launches K1 {launches['K1']}, K2 {launches['K2']}", flush=True)
    check(launches == {"K1": K1_PER_FORWARD * forwards, "K2": K2_PER_FORWARD * forwards},
          f"bundle launch counts {launches} for {forwards} forwards")

    opts = handler.config.inference_options
    raw_handler = LinnaeusInferenceHandler(
        replace(handler.config, inference_options=replace(
            opts, enable_hierarchical_consistency_check=False)),
        handler.model, handler.taxonomy, handler.class_maps)
    flips, worst, nulled = 0, 0.0, 0
    for body, answer in zip(bodies, answers):
        got = [as_result(p) for p in answer["predictions"]]
        nulled += check_results(got, SERVE_IMAGES, handler.taxonomy, handler.class_maps)
        images = [base64.b64decode(inst["image"]) for inst in body["instances"]]
        metas = [inst["metadata"] for inst in body["instances"]]
        want = handler.predict(images, metas)
        raw = raw_handler.predict(images, metas)
        check(all(enforce_hierarchical_consistency(r, handler.taxonomy, handler.class_maps) == w
                  for r, w in zip(raw, want)), "the consistency pass of the raw answers")
        for g_, w_, r_ in zip(got, want, raw):
            f, e = agreement(g_, w_, r_, handler.class_maps)
            flips, worst = flips + f, max(worst, e)
    print(f"every HTTP answer obeys the taxonomy tree (the pass nulled {nulled} of "
          f"{n_images * len(TASKS)} task results) and agrees with handler.predict on the same "
          f"bytes: max |dp| {worst:.3e} (tol {PROB_TOL:g}), {flips} near-tie flips", flush=True)

    lat = sorted(latencies)
    stats = {"requests_per_s": len(lat) / wall, "images_per_s": n_images / wall,
             "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
             "p99_ms": percentile(lat, 99), "mean_batch": sum(batches) / forwards,
             "forwards": forwards, "wall_s": wall,
             "dispatch_s": busy["dispatch"], "finish_s": busy["finish"]}
    print(f"[{card}] HTTP serving of the bundle ({what}), mFormerV1_sm {IMG}px bf16, make_server "
          f"defaults (max_batch 32, batch timeout 5 ms, pipeline depth 2), {SERVE_CLIENTS} "
          f"clients x {SERVE_REQUESTS} requests x {SERVE_IMAGES} images: "
          f"{stats['requests_per_s']:.2f} req/s ({stats['images_per_s']:.1f} img/s), latency "
          f"p50 {stats['p50_ms']:.1f} / p95 {stats['p95_ms']:.1f} / p99 {stats['p99_ms']:.1f} ms, "
          f"mean collated batch {stats['mean_batch']:.2f} images; over the {wall:.3f} s of "
          f"the run the batcher's worker spent {busy['dispatch']:.3f} s dispatching (decode, "
          f"preprocessing, upload, launches) and its completion thread {busy['finish']:.3f} s "
          f"finishing (waiting on the device, fetch, results)", flush=True)
    del raw_handler
    gc.collect()  # the server's request-handler class forms cycles
    return {"launches": launches, "stats": stats, "bodies": bodies}


def bundle_phase(dev, card, fa, fm) -> dict:
    """Serve a bundle from disk: write it (under build/, removed afterwards),
    load it with ``LinnaeusInferenceHandler.load_from_artifacts``, check the
    handler (card, bf16, hierarchical heads with the tree's matrices, warmup,
    logits bit-identical to the in-memory model's), serve it with
    ``tools.serve.make_server`` to concurrent clients over HTTP, check every
    answer against the tree and against ``handler.predict`` on the same
    bytes, and count K1's and K2's launches against the forwards the
    batcher ran (``serve_http``); then phase 7h (a)-(c), the host data
    plane under the same handler (``dataplane_serving``). Returns the
    launches and the measurements."""
    import base64
    import tempfile
    from pathlib import Path

    from linnaeus_tpu_torch.inference.handler import LinnaeusInferenceHandler

    Path("build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build", prefix="smoke_bundle_") as tmp:
        d = Path(tmp).resolve()
        start = time.perf_counter()
        reference = write_bundle(d, dev)
        written = time.perf_counter() - start
        start = time.perf_counter()
        handler = LinnaeusInferenceHandler.load_from_artifacts(d / "config.yaml")
        loaded = time.perf_counter() - start
    model = handler.model
    print(f"bundle written in {written:.1f} s, loaded by load_from_artifacts in {loaded:.1f} s",
          flush=True)
    check(all(p.device.type == "cuda" for p in model.parameters()), "the parameters are on the card")
    check(model.dtype == torch.bfloat16 and all(p.dtype == torch.float32 for p in model.parameters()),
          "bf16 compute over float32 parameters")
    matrices = handler.taxonomy.taxonomy_tree.build_hierarchy_matrices()
    heads = model.head
    check(all(heads.head_configs[t]["TYPE"] == "HierarchicalSoftmax" for t in TASKS)
          and sorted(heads.pairs) == sorted(matrices)
          and all(torch.equal(heads.matrix(k).cpu(), torch.tensor(m, dtype=torch.float32))
                  for k, m in matrices.items()), "hierarchical heads with the tree's matrices")
    check(all(b.attn.use_flash_attn for s in (2, 3) for b in model.stages[s])
          and all(b.fused_mlp is None for s in (0, 1) for b in model.stages[s]),
          "the variant's USE_FLASH_ATTN and the default FUSED_CONVNEXT_MLP auto")
    buckets = handler.warmup()
    check(buckets == int(np.log2(BATCH)) + 1, f"warmup ran {buckets} buckets")
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    x = torch.randn(8, IMG, IMG, 3, generator=g, device=dev)
    aux = torch.randn(8, 11, generator=g, device=dev)
    with torch.inference_mode():
        a, b = model(x, aux), reference(x, aux)
    check(all(torch.equal(a[t], b[t]) for t in TASKS),
          "the loaded model's logits equal the in-memory model's bit for bit")
    del reference
    torch.cuda.empty_cache()
    print(f"handler from disk: {sum(p.numel() for p in model.parameters())} float32 parameters "
          f"on {next(model.parameters()).device}, bf16 compute, HierarchicalSoftmax over "
          f"{sorted(matrices)}, warmup ran {buckets} buckets, logits bit-identical to the "
          f"in-memory model", flush=True)

    mixed = serve_http(handler, encoded_requests(np.random.default_rng(SEED + 11)), fa, fm, card,
                       "JPEG and PNG alternating within each request")
    launches, stats, bodies = mixed["launches"], mixed["stats"], mixed["bodies"]
    images = [base64.b64decode(inst["image"]) for body in bodies[:BATCH // SERVE_IMAGES]
              for inst in body["instances"]]
    metas = [inst["metadata"] for body in bodies[:BATCH // SERVE_IMAGES]
             for inst in body["instances"]]
    stats["host_ms"] = predict_breakdown(handler, images, metas, card)
    # phase 7h (a)-(c): the host data plane under this handler
    dataplane = dataplane_serving(handler, dev, card, fa, fm)
    del handler, model
    gc.collect()  # the model forms cycles
    torch.cuda.empty_cache()
    return {"launches": launches, "stats": stats, "dataplane": dataplane}


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
    from linnaeus_tpu_torch.utils import tracing

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    script_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # 1. build
    _kernels.library()
    spans = tracing.summary()
    built = spans.get("setup/kernels/build")
    print(f"kernel build: {'%.1f s (nvcc)' % (built['host_ms'] / 1e3) if built else 'reused'}; "
          f"library ready in {spans['setup/kernels']['host_ms'] / 1e3:.1f} s: "
          f"{_kernels.library_path()}", flush=True)

    # 2. each kernel against its plain version at the model's shapes
    rec = check_kernels(dev, fa, fm)
    rec_bwd = check_backward_kernels(dev, fa, fm)
    rec_split = check_split_backward(dev, fa)
    rec_block = check_block_kernel(dev, fb)
    check_width_rule(dev, fm)
    rec_dp = check_drop_path_kernels(dev, fm)

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

    # 3b. serve a bundle from disk: load_from_artifacts with a variant file
    # (K1 on, hierarchical heads), then HTTP through tools/serve.make_server
    bundle = bundle_phase(dev, card, fa, fm)

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

    # 7. train at 512 px: stage 3 holds 1028 tokens, where the TPU package
    # takes its split backward pair
    trained_large = train_phase(dev, card, fa, fm, IMG_LARGE)["on"]["launches"]

    # 7b. train from the default config: AutoAugment, GradNorm's update,
    # remat "dots", the heads' parameter group at 10x, AdamW on cosine;
    # then one Muon and one AdEMAMix step
    default_cfg = default_config_phase(dev, card, fa, fm)
    for key in ("K1", "K1_bwd", "K2", "K2_bwd"):
        check(default_cfg["launches"][key] > 0, f"{key} was not launched from the default config")

    # 7c. train through the Trainer: the CLI on a dataset of JPEGs on disk,
    # two epochs with validation and checkpoints, then a run that resumes
    with process_handlers_restored():
        trainer = trainer_phase(dev, card, fa, fm, default_cfg["step_ms"])
        for key in ("K1", "K1_bwd", "K2", "K2_bwd"):
            check(trainer["launches"][key] > 0, f"{key} was not launched through the Trainer")
        # 7h (d). the loader alone on generated photo-size JPEGs, the host
        # data plane on and off ((a)-(c) ran under phase 3b's handler, (e)
        # in phase 7c)
        loader_phase(dev, card)
        # 7d. from pretrained files to a served bundle: the example
        # experiment with AutoBatch, one epoch, the bundle tool, serving,
        # --throughput and inspect_checkpoints, on phase 7c's dataset
        pretrained = pretrained_phase(dev, card, fa, fm, trainer)
        # 7e. the mFormerV0 family: mFormerV0_sm's forward, training through
        # the CLI with resume, MetaFormer init and serving from the training
        # checkpoint directory, on phase 7c's dataset
        v0_phase(dev, card, fa, fm, trainer)
        # 7g. mFormerV1_sm_moe: serving, train_bench --moe steps, upcycling
        # from 7d's files through the CLI, serving the checkpoint, the export
        moe = moe_phase(dev, card, fa, fm, trainer)
        # 7i. more than one GPU at world size 1 over NCCL (replicated, FSDP2)
        # against one process, serving and resuming the sharded run's
        # checkpoint, two ranks on the card over gloo, the complexity
        # estimator, F10's deterministic dQ
        multi = multi_phase(dev, card, fa, fm, trainer)
        for mode, counts in multi["launches"].items():
            for key, n in counts.items():
                check(n > 0, f"{key} was not launched in phase 7i's {mode} run")
        # 7j. tools/shard_plan: what a rank holds and moves under dp, fsdp,
        # tp and pp on their meshes
        shard_plan_phase(dev, card)
        shutil.rmtree(trainer["dir"], ignore_errors=True)
        # 7f. phase 1 to phase 2: the receipt data, the CLI with the kernels
        # on and off and their receipts, PPO abstention fine-tuning from the
        # kernels-on checkpoint; the kernels at the rollout's and the
        # update's shapes
        receipt = receipt_phase(dev, card, fa, fm, fb)

    # 8. K3's path: the fused-block A/B tool, forward and train
    trained["K3"] = block_ab_phase(dev, fm, fb)

    kernels = []
    for r, key, name, src, replaces in (
        (rec["K1"], "K1", "flash_attention_fwd",
         "linnaeus_tpu_torch/csrc/flash_attention_fwd.cu", "linnaeus_tpu/ops/flash_attention.py:57"),
        (rec_bwd["K1"], "K1_bwd", "flash_attention_bwd",
         "linnaeus_tpu_torch/csrc/flash_attention_bwd_split.cu",
         "linnaeus_tpu/ops/flash_attention.py:156"),
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
        # launches: over its path's run (the 384 px train steps; the A/B tool
        # for K3), counted from zero; the forwards also served the requests.
        # flash_attention_bwd counts calls of K1's backward, each one launch
        # of flash_attention_bwd_dq and one of flash_attention_bwd_dkv
        check(trained[key] > 0, f"kernel {name} was not launched on its path")
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": trained[key], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "ms_spread": r.get("ms_spread"),
                        "library_chain_ms": r.get("library_chain_ms"),
                        "serving_launches": launches.get(key),
                        "bundle_launches": bundle["launches"].get(key),
                        "launches_512px": trained_large.get(key),
                        "default_cfg_launches": default_cfg["launches"].get(key, 0),
                        "trainer_launches": trainer["launches"].get(key, 0),
                        "pretrained_launches": pretrained["launches"].get(key, 0),
                        "receipt_launches": receipt["launches"].get(key, 0),
                        "moe_launches": moe["launches"].get(key, 0),
                        "multi_launches": {mode: counts.get(key, 0) for mode, counts
                                           in multi["launches"].items()},
                        "receipt_shapes": receipt["shapes"].get(key, []),
                        "shape": r["shape"],
                        "dtype": "bfloat16", "other_shapes": r.get("other_shapes", [])})
    # the scale-add kernel replaces no TPU kernel; its launches over the
    # 384 px train steps (none with the kernels off), forward and backward
    check(trained["drop_path_add"] > 0, "kernel drop_path_add was not launched on its path")
    kernels.append({"name": "drop_path_add", "route": "cuda",
                    "source": "linnaeus_tpu_torch/csrc/drop_path_add.cu", "replaces": None,
                    "launches": trained["drop_path_add"],
                    "bwd_launches": trained["drop_path_add_bwd"],
                    "launches_512px": trained_large["drop_path_add"], "dtype": "bfloat16",
                    **{k: v for k, v in rec_dp.items() if k != "k2_scaled"}})
    kernels[[k["name"] for k in kernels].index("fused_convnext_mlp_fwd")]["scaled"] = (
        rec_dp["k2_scaled"])
    print(f"chip_smoke.py took {time.perf_counter() - script_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-child"]:
        sys.exit(train_child(sys.argv[2:]))
    sys.exit(main())
