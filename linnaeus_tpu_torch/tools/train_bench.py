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
float32. ``--remat`` checkpoints every tower block (``--remat-policy``
full, dots or dots_no_batch).

``--default-config`` builds the step from the default config instead
(``default_train_config``: GradNorm every UPDATE_INTERVAL steps,
AutoAugment, colour jitter, random erasing, remat 'dots', AdamW on a cosine
schedule), and ``--config`` from an experiment yaml: parameter groups,
every optimizer and schedule the config can name.

It runs on the CUDA device unless the caller passes ``device="cpu"``; with
no card and no such request it raises.

    python -m linnaeus_tpu_torch.tools.train_bench --batch 64 --img 384
    python -m linnaeus_tpu_torch.tools.train_bench --img 512
    python -m linnaeus_tpu_torch.tools.train_bench --no-kernels
    python -m linnaeus_tpu_torch.tools.train_bench --profile 3
    python -m linnaeus_tpu_torch.tools.train_bench --remat --remat-policy dots
    python -m linnaeus_tpu_torch.tools.train_bench --default-config --steps 4
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Callable, Mapping

import torch

from linnaeus_tpu_torch.configuration.train_presets import train_preset
from linnaeus_tpu_torch.data.augmentation.autoaugment import AugmentationPipelineFactory
from linnaeus_tpu_torch.data.collate import MixConfig
from linnaeus_tpu_torch.loss.basic import soft_target_cross_entropy
from linnaeus_tpu_torch.loss.gradnorm import make_gradnorm_update_fn, should_update_gradnorm
from linnaeus_tpu_torch.models.build import build_model
from linnaeus_tpu_torch.models.utils import resolve_remat_policy
from linnaeus_tpu_torch.optim.build import build_optimizer
from linnaeus_tpu_torch.optim.schedules import build_group_schedules, build_schedule
from linnaeus_tpu_torch.train.state import TrainState, create_train_state
from linnaeus_tpu_torch.train.step import ScheduleScalars, make_gradnorm_step, make_train_step
from linnaeus_tpu_torch.utils.device import resolve_device
from linnaeus_tpu_torch.utils.param_filters import (
    resolve_gradnorm_exclude,
    trunk_mask_from_exclude,
)

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


class BenchStep:
    """The bench's train step on its synthetic batch: ``bench()`` takes one
    optimizer step and, when GradNorm is on and its cadence names the step
    just taken, the GradNorm update after it (its metrics under
    ``"gradnorm"``); ``train()`` and ``gradnorm()`` take each alone, and
    ``augment`` is the augmentation pipeline or None."""

    def __init__(self, state: TrainState, step: Callable, data: dict, scalars: ScheduleScalars,
                 gradnorm_step: Callable | None = None, gradnorm_cfg=None,
                 augment: Callable | None = None):
        self.state, self.step, self.data, self.scalars = state, step, data, scalars
        self.gradnorm_step, self.gradnorm_cfg, self.augment = gradnorm_step, gradnorm_cfg, augment

    def train(self) -> dict:
        return self.step(self.state, self.data, self.scalars)[1]

    def gradnorm(self) -> dict:
        return self.gradnorm_step(self.state)[1]

    def __call__(self) -> dict:
        metrics = self.train()
        if self.gradnorm_step is not None and should_update_gradnorm(self.gradnorm_cfg,
                                                                     self.state.step):
            metrics["gradnorm"] = self.gradnorm()
        return metrics


def _meta_bounds(meta_components) -> tuple[tuple[tuple[int, int], ...], int]:
    bounds, start = [], 0
    for _, dim in meta_components:
        bounds.append((start, start + dim))
        start += dim
    return tuple(bounds), start


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
    remat: bool | None = None,
    remat_policy: str | None = None,
    config=None,
) -> tuple[BenchStep, TrainState]:
    """Model, state and step on a synthetic batch. ``kernels`` routes the
    attention of stages 3-4 through K1 and the ConvNeXt MLP tails of stages
    1-2 through K2, forward and backward; off, both take the plain PyTorch
    modules, and the attention's scores are float32 if ``fp32_scores`` or
    the preset's ``MODEL.ATTN_FP32_SOFTMAX`` says so, else ``dtype``.
    ``remat`` checkpoints every tower block under ``remat_policy`` ('full',
    'dots', 'dots_no_batch'), the JAX tool's ``--remat`` and
    ``--remat-policy``; with a config, given values override its setting
    for both normal and GradNorm steps.

    With ``config`` (a ``CfgNode`` such as ``get_default_config()`` with an
    mFormerV1 arch applied) the step is built from it instead of the
    training preset: the model and its kernels, remat and policy (unless
    ``remat`` / ``remat_policy`` are given), the on-device augmentation
    (AUG.*), the GradNorm update (LOSS.GRAD_WEIGHTING.TASK), the optimizer
    with its parameter groups and the schedules (OPTIMIZER.*,
    LR_SCHEDULER.*), the clip and the metadata components; ``arch``,
    ``kernels``, ``dtype``, ``meta_components`` and ``fp32_scores`` are then
    the config's. GradNorm's initial task weights are INIT_WEIGHTS, or equal
    weights (the 'inverse_density' strategy needs the class counts of a
    dataset). Returns ``(run, state)``: ``run()`` takes one optimizer step
    on the batch and returns its metrics."""
    device = resolve_device(device)
    if config is not None:
        return _build_from_config(config, batch, num_classes, device, seed,
                                  accumulation_steps, remat, remat_policy)
    cfg = train_preset("tpu_trainrun_synth_512" if img == 512 else "tpu_trainrun_synth_384")
    model = build_model(
        arch, img, dict(num_classes), tuple(meta_components), dtype=dtype,
        use_flash_attn=kernels, fused_convnext_mlp=kernels,
        attn_fp32_softmax=fp32_scores or bool(cfg.MODEL.ATTN_FP32_SOFTMAX),
        drop_path_rate=float(cfg.MODEL.DROP_PATH_RATE), device=device, seed=seed,
    )
    model.gradient_checkpointing = bool(remat)
    model.remat_policy = remat_policy or "dots"
    if model.gradient_checkpointing:
        resolve_remat_policy(model.remat_policy)
    schedule = build_schedule(cfg, TOTAL_STEPS)
    optimizer = build_optimizer(cfg, schedule, model)
    state = create_train_state(
        model, optimizer, num_tasks=len(num_classes),
        generator=torch.Generator(device=device).manual_seed(seed), lr_schedule=schedule,
    )
    tasks = tuple(num_classes)
    bounds, meta_dim = _meta_bounds(meta_components)
    mix = cfg.SCHEDULE.MIX
    step = make_train_step(
        {t: soft_target_cross_entropy for t in tasks}, tasks,
        MixConfig(mixup_alpha=float(mix.MIXUP.ALPHA), mixup_enabled=bool(mix.MIXUP.ENABLED),
                  cutmix_enabled=bool(mix.CUTMIX.ENABLED), chunk_bounds=bounds),
        clip_grad=float(cfg.TRAIN.CLIP_GRAD), accumulation_steps=accumulation_steps,
        has_meta=True, lr_schedule=schedule, num_classes=dict(num_classes),
    )
    data = synthetic_batch(batch, img, num_classes, meta_dim, device, seed + 1)
    return BenchStep(state, step, data, _bench_scalars(meta_dim, device)), state


def _bench_scalars(meta_dim: int, device) -> ScheduleScalars:
    """The TPU tool's per-step schedule values: mix probability 0.5,
    meta-mask probability 0.3."""
    return ScheduleScalars(
        mix_prob=0.5, use_cutmix=False, meta_mask_prob=0.3, partial_mask_prob=0.0,
        partial_combo_mask=torch.zeros(meta_dim, device=device), null_mask_prob=1.0,
    )


def _build_from_config(config, batch, num_classes, device, seed, accumulation_steps,
                       remat, remat_policy) -> tuple[BenchStep, TrainState]:
    tasks = tuple(num_classes)
    if tuple(config.DATA.TASK_KEYS_H5) != tasks:
        raise ValueError(f"DATA.TASK_KEYS_H5 {list(config.DATA.TASK_KEYS_H5)} must name the "
                         f"tasks of num_classes {list(tasks)}")
    gc = config.TRAIN.GRADIENT_CHECKPOINTING
    if remat is not None or remat_policy is not None:
        config = config.clone()
        gc = config.TRAIN.GRADIENT_CHECKPOINTING
        if remat is not None:
            gc.ENABLED_NORMAL_STEPS = gc.ENABLED_GRADNORM_STEPS = bool(remat)
        if remat_policy is not None:
            gc.POLICY = remat_policy
    model = build_model(config, dict(num_classes), device=device, seed=seed)
    img = model.grid3[0] * 16
    schedules = build_group_schedules(config, TOTAL_STEPS)
    optimizer = build_optimizer(config, schedules["default"], model, schedules)
    gw = config.LOSS.GRAD_WEIGHTING.TASK
    init_weights = list(gw.get("INIT_WEIGHTS") or []) or None
    state = create_train_state(
        model, optimizer, num_tasks=len(tasks),
        generator=torch.Generator(device=device).manual_seed(seed),
        init_task_weights=init_weights, lr_schedule=schedules,
    )
    criteria = {t: soft_target_cross_entropy for t in tasks}
    if str(config.AUG.SINGLE_AUG_DEVICE) != "device":
        raise NotImplementedError(
            "AUG.SINGLE_AUG_DEVICE 'cpu' (augmentation on the host, in the loader) is not "
            "ported yet: it comes with the data feed; 'device' is the default")
    augment = AugmentationPipelineFactory.create(config)
    gradnorm_on = str(gw.TYPE) == "gradnorm" and bool(gw.get("GRADNORM_ENABLED", True))
    bounds, meta_dim = _meta_bounds(model.meta_components)
    mix = config.SCHEDULE.MIX
    step = make_train_step(
        criteria, tasks,
        MixConfig(mixup_alpha=float(mix.MIXUP.ALPHA), mixup_enabled=bool(mix.MIXUP.ENABLED),
                  cutmix_enabled=bool(mix.CUTMIX.ENABLED), chunk_bounds=bounds),
        clip_grad=float(config.TRAIN.CLIP_GRAD), accumulation_steps=accumulation_steps,
        has_meta=meta_dim > 0, lr_schedule=schedules["default"], num_classes=dict(num_classes),
        augment_fn=augment, keep_collated=gradnorm_on,
    )
    gradnorm_step = None
    if gradnorm_on:
        trunk = trunk_mask_from_exclude(model, resolve_gradnorm_exclude(gw))
        gradnorm_step = make_gradnorm_step(make_gradnorm_update_fn(
            criteria, tasks, [n for n, keep in trunk.items() if keep], alpha=float(gw.ALPHA),
            zero_aux_info=bool(gw.ZERO_AUX_INFO),
            use_linear_heads=bool(gw.USE_LINEAR_HEADS_FOR_GRADNORM_REFORWARD),
            accum_steps=max(int(gw.get("GRADNORM_ACCUM_STEPS", 1) or 1), 1),
            remat=bool(gc.get("ENABLED_GRADNORM_STEPS", False)),
        ))
    data = synthetic_batch(batch, img, num_classes, meta_dim, device, seed + 1)
    bench = BenchStep(state, step, data, _bench_scalars(meta_dim, device), gradnorm_step, gw,
                      augment)
    return bench, state


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
        gradnorm_ms = None
        if run.gradnorm_step is not None:  # two updates, after one untimed
            run.gradnorm()
            start.record()
            for _ in range(2):
                run.gradnorm()
            end.record()
            torch.cuda.synchronize(device)
            gradnorm_ms = start.elapsed_time(end) / 2
    else:
        t0 = time.perf_counter()
        history += [run() for _ in range(steps)]
        ms = 1000.0 * (time.perf_counter() - t0) / steps
        peak, kind, gradnorm_ms = None, "cpu", None
    return {
        "device": kind, "batch": batch, "img": state.model.grid3[0] * 16, "kernels": kernels,
        "fp32_scores": bool(build_kw.get("fp32_scores", False)),
        "warmup": warmup, "steps": steps,
        "train_ms_per_step": ms, "train_images_per_sec": batch / (ms / 1000.0),
        "peak_memory_bytes": peak,
        "loss": [float(m["loss"]) for m in history],
        "grad_norm_pre_clip": [float(m["grad_norm_pre_clip"]) for m in history],
        "grad_norm_post_clip": [float(m["grad_norm_post_clip"]) for m in history],
        "gradnorm_updates": sum("gradnorm" in m for m in history),
        "gradnorm_ms_per_update": gradnorm_ms,
        "task_weights": [float(w) for w in state.gradnorm.task_weights],
        "remat": state.model.gradient_checkpointing, "remat_policy": state.model.remat_policy,
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


def default_train_config(img: int = 384, kernels: bool = True, arch: str = "mFormerV1_sm",
                         tasks: tuple[str, ...] = tuple(NUM_CLASSES)):
    """The TPU package's default config (copied: configuration/defaults.py)
    with ``arch`` applied at ``img`` px and the bench's tasks: GradNorm,
    AutoAugment 'original', colour jitter 0.4, random erasing 0.25, remat
    'dots' for normal and GradNorm steps, AdamW on a cosine schedule, bf16.
    ``kernels`` sets MODEL.USE_FLASH_ATTN (K1; K2 follows
    MODEL.FUSED_CONVNEXT_MLP 'auto') or turns both off."""
    from linnaeus_tpu_torch.configuration import get_default_config
    from linnaeus_tpu_torch.configuration.archs import apply_arch

    cfg = get_default_config()
    apply_arch(cfg, arch)
    cfg.defrost()
    cfg.MODEL.IMG_SIZE = img
    cfg.DATA.IMG_SIZE = img
    cfg.DATA.TASK_KEYS_H5 = list(tasks)
    cfg.MODEL.USE_FLASH_ATTN = bool(kernels)
    cfg.MODEL.FUSED_CONVNEXT_MLP = "auto" if kernels else "off"
    return cfg


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
    p.add_argument("--remat", action="store_true",
                   help="checkpoint every tower block (with a config: its setting unless given)")
    p.add_argument("--no-remat", action="store_true",
                   help="with a config: no checkpointing on normal or GradNorm steps")
    p.add_argument("--remat-policy", default=None, choices=("full", "dots", "dots_no_batch"),
                   help="what a checkpointed block keeps (default: dots, or the config's)")
    p.add_argument("--default-config", action="store_true",
                   help="build the step from the default config (GradNorm, AutoAugment, remat "
                        "'dots', AdamW on cosine) at --img, kernels as --no-kernels says")
    p.add_argument("--config", default=None,
                   help="build the step from this experiment yaml (loaded over the defaults)")
    args = p.parse_args(argv)
    build_kw = {"device": args.device, "accumulation_steps": args.accum,
                "fp32_scores": args.fp32_scores,
                "remat": True if args.remat else False if args.no_remat else None,
                "remat_policy": args.remat_policy}
    if args.config:
        from linnaeus_tpu_torch.configuration import build_config

        build_kw["config"] = build_config(args.config)
    elif args.default_config:
        build_kw["config"] = default_train_config(args.img, not args.no_kernels)
    elif build_kw["remat"] is None:
        build_kw["remat"] = False
    if args.profile:
        out = profile(args.batch, args.img, not args.no_kernels, steps=args.profile,
                      trace_path=args.trace, forward_only=args.forward, **build_kw)
    else:
        out = measure(args.batch, args.img, not args.no_kernels, steps=args.steps, **build_kw)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
