"""Train-step benchmark on one GPU.

Port of linnaeus_tpu/tools/train_bench.py (``build_step``, ``measure``). It
builds mFormerV1 and the full train step of train/step.py (on-device
collate, forward in bfloat16 over float32 parameters, float32 loss,
backward, global-norm clip, AdamW update on a cosine schedule) on a seeded
synthetic batch, takes a few steps and times them with CUDA events. The
optimizer, schedule, clip and drop-path rate come from the training preset
``tpu_trainrun_synth_384`` (configuration/train_presets.py; at ``--img 512``
its 512 px twin, whose stage 3 holds 1028 tokens and so sends K1's backward
through the split dQ and dK/dV kernels); the per-step schedule scalars are
the TPU package's bench values (mix probability 0.5, meta-mask probability
0.3). With the kernels off the plain attention stores its scores in the
compute dtype, the TPU tool's default; ``--fp32-scores`` computes them in
float32.

It runs on the CUDA device unless the caller passes ``device="cpu"``; with
no card and no such request it raises.

    python -m linnaeus_tpu_torch.tools.train_bench --batch 64 --img 384
    python -m linnaeus_tpu_torch.tools.train_bench --img 512
    python -m linnaeus_tpu_torch.tools.train_bench --no-kernels
    python -m linnaeus_tpu_torch.tools.train_bench --profile 3
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Callable, Mapping

import torch

from linnaeus_tpu_torch.configuration.train_presets import train_preset
from linnaeus_tpu_torch.data.collate import MixConfig
from linnaeus_tpu_torch.loss.basic import soft_target_cross_entropy
from linnaeus_tpu_torch.models.build import build_model
from linnaeus_tpu_torch.optim.build import build_optimizer
from linnaeus_tpu_torch.optim.schedules import build_schedule
from linnaeus_tpu_torch.train.state import TrainState, create_train_state
from linnaeus_tpu_torch.train.step import ScheduleScalars, make_train_step
from linnaeus_tpu_torch.utils.device import resolve_device

NUM_CLASSES = {"taxa_L10": 1000, "taxa_L20": 400, "taxa_L30": 100, "taxa_L40": 30}
META_COMPONENTS = (("TEMPORAL", 2), ("SPATIAL", 3), ("ELEVATION", 6))
TOTAL_STEPS = 8 * 115  # the preset's 8 epochs of 7372 training samples at batch 64
# the port's own kernels, by the names the profiler shows them under
PORT_KERNELS = (
    "flash_fwd_wgmma_kernel", "flash_fwd_fp32_kernel", "flash_bwd_wgmma_kernel",
    "flash_bwd_fp32_kernel", "flash_bwd_dq_wgmma_kernel", "flash_bwd_dq_fp32_kernel",
    "flash_bwd_dkv_wgmma_kernel", "flash_bwd_dkv_fp32_kernel", "delta_kernel",
    "dq_finish_kernel", "fused_mlp_wgmma_kernel", "fused_mlp_kernel", "mlp_bwd_prologue_kernel",
    "mlp_bwd_rows_wgmma_kernel", "mlp_bwd_weights_wgmma_kernel", "mlp_bwd_rows_kernel",
    "mlp_bwd_weights_kernel", "mlp_bwd_reduce_kernel",
)


def synthetic_batch(batch: int, img: int, num_classes: Mapping[str, int], meta_dim: int,
                    device: torch.device, seed: int) -> dict[str, Any]:
    """uint8 images, normal metadata, integer labels and the mixed-pairs
    group layout (two neighbours per group), all drawn on ``device`` from
    ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return {
        "images": torch.randint(0, 256, (batch, img, img, 3), generator=g, device=device,
                                dtype=torch.uint8),
        "aux": torch.randn(batch, meta_dim, generator=g, device=device),
        "targets": {t: torch.randint(0, n, (batch,), generator=g, device=device)
                    for t, n in num_classes.items()},
        "group_ids": torch.arange(batch, device=device, dtype=torch.int32) // 2,
    }


def build_step(
    batch: int = 64,
    img: int = 384,
    kernels: bool = True,
    arch: str | Mapping[str, Any] = "mFormerV1_sm",
    num_classes: Mapping[str, int] = NUM_CLASSES,
    meta_components: tuple[tuple[str, int], ...] = META_COMPONENTS,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str | None = None,
    seed: int = 0,
    accumulation_steps: int = 1,
    fp32_scores: bool = False,
) -> tuple[Callable[[], dict], TrainState]:
    """Model, state and step on a synthetic batch. ``kernels`` routes the
    attention of stages 3-4 through K1 and the ConvNeXt MLP tails of stages
    1-2 through K2, forward and backward; off, both take the plain PyTorch
    modules, and the attention's scores are float32 if ``fp32_scores`` or
    the preset's ``MODEL.ATTN_FP32_SOFTMAX`` says so, else ``dtype``.
    Returns ``(run, state)``: ``run()`` takes one optimizer step on the batch
    and returns its metrics."""
    device = resolve_device(device)
    cfg = train_preset("tpu_trainrun_synth_512" if img == 512 else "tpu_trainrun_synth_384")
    model = build_model(
        arch, img, dict(num_classes), tuple(meta_components), dtype=dtype,
        use_flash_attn=kernels, fused_convnext_mlp=kernels,
        attn_fp32_softmax=fp32_scores or bool(cfg.MODEL.ATTN_FP32_SOFTMAX),
        drop_path_rate=float(cfg.MODEL.DROP_PATH_RATE), device=device, seed=seed,
    )
    schedule = build_schedule(cfg, TOTAL_STEPS)
    optimizer = build_optimizer(cfg, schedule, model)
    state = create_train_state(
        model, optimizer, num_tasks=len(num_classes),
        generator=torch.Generator(device=device).manual_seed(seed), lr_schedule=schedule,
    )
    tasks = tuple(num_classes)
    bounds, start = [], 0
    for _, dim in meta_components:
        bounds.append((start, start + dim))
        start += dim
    mix = cfg.SCHEDULE.MIX
    step = make_train_step(
        {t: soft_target_cross_entropy for t in tasks}, tasks,
        MixConfig(mixup_alpha=float(mix.MIXUP.ALPHA), mixup_enabled=bool(mix.MIXUP.ENABLED),
                  cutmix_enabled=bool(mix.CUTMIX.ENABLED), chunk_bounds=tuple(bounds)),
        clip_grad=float(cfg.TRAIN.CLIP_GRAD), accumulation_steps=accumulation_steps,
        has_meta=True, lr_schedule=schedule, num_classes=dict(num_classes),
    )
    data = synthetic_batch(batch, img, num_classes, start, device, seed + 1)
    scalars = ScheduleScalars(
        mix_prob=0.5, use_cutmix=False, meta_mask_prob=0.3, partial_mask_prob=0.0,
        partial_combo_mask=torch.zeros(start, device=device), null_mask_prob=1.0,
    )

    def run() -> dict:
        return step(state, data, scalars)[1]

    return run, state


def measure(batch: int = 64, img: int = 384, kernels: bool = True, warmup: int = 1,
            steps: int = 3, device: torch.device | str | None = None, **build_kw) -> dict:
    """ms per train step (CUDA events around ``steps`` steps after
    ``warmup``) and peak device memory; on the CPU, the host clock."""
    device = resolve_device(device)
    run, state = build_step(batch, img, kernels, device=device, **build_kw)
    history = [run() for _ in range(warmup)]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        history += [run() for _ in range(steps)]
        end.record()
        torch.cuda.synchronize(device)
        ms = start.elapsed_time(end) / steps
        peak = torch.cuda.max_memory_allocated(device)
        kind = torch.cuda.get_device_name(device)
    else:
        t0 = time.perf_counter()
        history += [run() for _ in range(steps)]
        ms = 1000.0 * (time.perf_counter() - t0) / steps
        peak, kind = None, "cpu"
    return {
        "device": kind, "batch": batch, "img": img, "kernels": kernels,
        "fp32_scores": bool(build_kw.get("fp32_scores", False)),
        "warmup": warmup, "steps": steps,
        "train_ms_per_step": ms, "train_images_per_sec": batch / (ms / 1000.0),
        "peak_memory_bytes": peak,
        "loss": [float(m["loss"]) for m in history],
        "grad_norm_pre_clip": [float(m["grad_norm_pre_clip"]) for m in history],
        "grad_norm_post_clip": [float(m["grad_norm_post_clip"]) for m in history],
        "final_step": state.step,
    }


def profile(batch: int = 64, img: int = 384, kernels: bool = True, steps: int = 3,
            top: int = 25, trace_path: str | None = None, forward_only: bool = False,
            **build_kw) -> dict:
    """Device time by kernel name over ``steps`` train steps (with
    ``forward_only``: forwards of the same model in inference mode on a
    random float batch) after two
    warm-up steps (torch.profiler, CPU + CUDA activities): per-step wall
    time under the profiler, device-busy time, the idle share, the ``top``
    kernels, and under ``port_kernels`` every row of the port's own kernels
    (K1 forward, fused backward, the split dQ and dK/dV backward, K2) however
    small. Tracing the host slows it, so the wall time and the
    idle share here are the profiled run's: for the idle share of a plain
    run, hold ``device_busy_ms_per_step`` against ``measure``'s step time."""
    from torch.profiler import ProfilerActivity

    device = resolve_device(build_kw.pop("device", None))
    run, state = build_step(batch, img, kernels, device=device, **build_kw)
    if forward_only:
        model = state.model.eval()
        g = torch.Generator(device=device).manual_seed(2)
        x = torch.randn(batch, img, img, 3, generator=g, device=device)
        aux = torch.randn(batch, sum(d for _, d in META_COMPONENTS), generator=g, device=device)

        def run() -> None:
            with torch.inference_mode():
                model(x, aux)

    for _ in range(2):
        run()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize(device)
    wall_ms = 1000.0 * (time.perf_counter() - t0) / steps
    if trace_path:
        prof.export_chrome_trace(trace_path)
    rows = []
    for e in prof.key_averages():
        # device rows only, and no user-annotation ranges (the optimizer's
        # "Optimizer.step#..." span covers kernels that have rows of their own)
        on_device = "cuda" in str(getattr(e, "device_type", "")).lower()
        if not on_device or getattr(e, "is_user_annotation", False) or "#" in e.key:
            continue
        device_us = getattr(e, "self_device_time_total", None)
        if device_us is None:
            device_us = getattr(e, "self_cuda_time_total", 0.0)
        if device_us > 0:
            rows.append((e.key, device_us / 1000.0 / steps, e.count / steps))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    as_dict = lambda r: {"name": r[0][:100], "ms_per_step": r[1],  # noqa: E731
                         "launches_per_step": r[2]}
    return {
        "kernels": kernels, "forward_only": forward_only, "steps": steps,
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy,
        "idle_share": max(0.0, 1.0 - busy / wall_ms),
        "top": [as_dict(r) for r in rows[:top]],
        "port_kernels": [as_dict(r) for r in rows
                         if any(f"{name}<" in r[0] or f"{name}(" in r[0] for name in PORT_KERNELS)],
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser("train_bench")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--img", type=int, default=384)
    p.add_argument("--no-kernels", action="store_true",
                   help="plain PyTorch attention and MLP instead of K1 and K2")
    p.add_argument("--fp32-scores", action="store_true",
                   help="float32 scores in the plain attention (default: the compute dtype)")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--accum", type=int, default=1, help="gradient accumulation microbatches")
    p.add_argument("--device", default=None, help='"cpu" to run without a card')
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="profile N steps with torch.profiler instead of timing them")
    p.add_argument("--forward", action="store_true",
                   help="with --profile: profile forwards in inference mode, not train steps")
    p.add_argument("--trace", default=None, help="write the profile's chrome trace here")
    args = p.parse_args(argv)
    if args.profile:
        out = profile(args.batch, args.img, not args.no_kernels, steps=args.profile,
                      trace_path=args.trace, forward_only=args.forward, device=args.device,
                      accumulation_steps=args.accum, fp32_scores=args.fp32_scores)
    else:
        out = measure(args.batch, args.img, not args.no_kernels, steps=args.steps,
                      device=args.device, accumulation_steps=args.accum,
                      fp32_scores=args.fp32_scores)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
