#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (linnaeus_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
nvcc. It builds the CUDA kernels from linnaeus_tpu_torch/csrc/, holds each
one against its plain PyTorch version at the serving shapes, then serves
mFormerV1_sm at 384 px in bf16 (seeded random weights) through
LinnaeusInferenceHandler: three predict requests of 1, 7 and 64 images,
with launch counters proving every forward went through both kernels. It
compares the whole forward with the kernels on and off, reports serving
throughput, and prints as its last line

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
# K2: stage 1 (B*96*96 rows, C=96) and stage 2 (B*48*48 rows, C=192)
K2_SHAPES = [(BATCH * 96 * 96, 96), (BATCH * 48 * 48, 192), (70, 96)]
# the TPU kernel tests' bars against their own plain versions
K1_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
K2_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
K1_PER_FORWARD = 5 + 2  # RoPE blocks of mFormerV1_sm's stages 3 and 4
K2_PER_FORWARD = 3 + 3  # ConvNeXt blocks of stages 1 and 2
# whole-forward bars for kernels on vs off (random-init logits stay below
# ~1 in magnitude): fp32 runs the same math in another summation order;
# bf16 (8-bit mantissa, 2**-8 relative) rounds at other places (p per
# 64-key tile in K1, the GELU input kept in fp32 by K2) through 22 blocks,
# so the bar is about a dozen bf16 steps at |logit| ~1
LOGIT_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def check_kernels(dev, fa, fm) -> dict:
    """Each kernel against its plain version; returns per-kernel records."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    rec = {"K1": {"max_abs_err": 0.0}, "K2": {"max_abs_err": 0.0}}
    for dt in (torch.float32, torch.bfloat16):
        for B, N, H, D in K1_SHAPES:
            # q, k, v as strided views of one qkv projection output
            q, k, v = torch.randn(B, N, 3, H, D, generator=g, device=dev).to(dt).unbind(2)
            out, lse = fa.flash_attention_fwd(q, k, v)
            ref, ref_lse = fa.flash_attention_reference(q, k, v)
            err = max(max_err(out, ref), max_err(lse, ref_lse))
            ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v))
            plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v))
            print(f"K1 flash_attention_fwd {str(dt)[6:]} (B,N,H,D)={(B, N, H, D)}: "
                  f"max|err| {err:.3e} (tol {K1_TOL[dt]:g}), kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms", flush=True)
            check(err <= K1_TOL[dt], f"K1 {dt} {(B, N, H, D)} error {err}")
            if dt == torch.bfloat16:
                rec["K1"]["max_abs_err"] = max(rec["K1"]["max_abs_err"], err)
                if N == 580:
                    rec["K1"].update(ms=ms, plain_ms=plain_ms, shape=[B, N, H, D])
        for M, C in K2_SHAPES:
            y, x = (torch.randn(M, C, generator=g, device=dev).to(dt) for _ in range(2))
            vec = lambda n, s, m=0.0: m + s * torch.randn(n, generator=g, device=dev)  # noqa: E731
            ln_w, ln_b, b1, b2, gamma = vec(C, 0.1, 1.0), vec(C, 0.1), vec(4 * C, 0.1), vec(C, 0.1), vec(C, 0.1, 0.5)
            w1 = (0.1 * torch.randn(4 * C, C, generator=g, device=dev)).to(dt)
            w2 = (0.1 * torch.randn(C, 4 * C, generator=g, device=dev)).to(dt)
            for residual, approx in ((x, True), (None, True), (x, False)):
                args = (y, residual, ln_w, ln_b, w1, b1, w2, b2, gamma)
                out = fm.fused_convnext_mlp(*args, approximate_gelu=approx)
                ref = fm.fused_convnext_mlp_reference(*args, 1e-6, approx)
                err = max_err(out, ref)
                ms = cuda_ms(lambda: fm.fused_convnext_mlp(*args, approximate_gelu=approx))
                plain_ms = cuda_ms(lambda: fm.fused_convnext_mlp_reference(*args, 1e-6, approx))
                print(f"K2 fused_convnext_mlp {str(dt)[6:]} (M,C)={(M, C)} "
                      f"residual={residual is not None} gelu={'tanh' if approx else 'erf'}: "
                      f"max|err| {err:.3e} (tol {K2_TOL[dt]:g}), kernel {ms:.3f} ms, "
                      f"plain {plain_ms:.3f} ms", flush=True)
                check(err <= K2_TOL[dt], f"K2 {dt} {(M, C)} error {err}")
                if dt == torch.bfloat16:
                    rec["K2"]["max_abs_err"] = max(rec["K2"]["max_abs_err"], err)
                    if C == 96 and M > 70 and residual is not None and approx:
                        rec["K2"].update(ms=ms, plain_ms=plain_ms, shape=[M, C])
    return rec


def serving_config():
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
        "inference_options": {"default_top_k": 5, "batch_size": BATCH,
                              "enable_hierarchical_consistency_check": False},
    })


def requests(n: int, rng: np.random.Generator):
    images = [rng.integers(0, 256, (IMG, IMG, 3), dtype=np.uint8) for _ in range(n)]
    metas = [{"lat": float(rng.uniform(-60, 70)), "lon": float(rng.uniform(-180, 180)),
              "datetime": f"2024-{1 + i % 12:02d}-15T12:00:00",
              "elevation_m": float(rng.uniform(0, 3000))} for i in range(n)]
    return images, metas


def check_results(results, n: int) -> None:
    check(len(results) == n, f"{len(results)} results for {n} images")
    for r in results:
        check([t.task_key for t in r.tasks] == list(TASKS), "task keys")
        for t in r.tasks:
            probs = [p for _, p in t.predictions]
            check(len(probs) == min(5, TASKS[t.task_key]), f"top-k length {len(probs)}")
            check(all(np.isfinite(p) and 0.0 <= p <= 1.0 for p in probs), f"probabilities {probs}")
            check(probs == sorted(probs, reverse=True), "probabilities sorted")


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
    from linnaeus_tpu_torch.inference.artifacts import class_index_maps
    from linnaeus_tpu_torch.inference.handler import LinnaeusInferenceHandler
    from linnaeus_tpu_torch.inference.model_utils import build_model_for_inference
    from linnaeus_tpu_torch.ops import flash_attention as fa
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

    # 2. each kernel against its plain version at the serving shapes
    rec = check_kernels(dev, fa, fm)

    # 3. serve mFormerV1_sm through the handler, kernels on
    cfg = serving_config()
    model = build_model_for_inference(cfg, dtype=torch.bfloat16, device=dev,
                                      use_flash_attn=True, fused_convnext_mlp=None, seed=SEED)
    m = cfg.model
    maps = class_index_maps({}, m.model_task_keys_ordered, m.num_classes_per_task,
                            m.null_class_indices)
    handler = LinnaeusInferenceHandler(cfg, model, maps)
    rng = np.random.default_rng(SEED)
    reqs = [requests(n, rng) for n in (1, 7, 64)]
    fa.LAUNCHES = fm.LAUNCHES = 0
    answers = [handler.predict(images, metas) for images, metas in reqs]
    launches = {"K1": fa.LAUNCHES, "K2": fm.LAUNCHES}
    print(f"served requests of 1, 7, 64 images; launches K1 {launches['K1']}, "
          f"K2 {launches['K2']} over 3 forwards", flush=True)
    for (images, _), results in zip(reqs, answers):
        check_results(results, len(images))
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

    kernels = []
    for key, name, src, replaces in (
        ("K1", "flash_attention_fwd", "linnaeus_tpu_torch/csrc/flash_attention_fwd.cu",
         "linnaeus_tpu/ops/flash_attention.py:57"),
        ("K2", "fused_convnext_mlp_fwd", "linnaeus_tpu_torch/csrc/fused_mlp_fwd.cu",
         "linnaeus_tpu/ops/fused_mlp.py:39"),
    ):
        r = rec[key]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[key], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "shape": r["shape"],
                        "dtype": "bfloat16"})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
