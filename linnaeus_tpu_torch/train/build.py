"""What a config trains with: model, state, train step and GradNorm step.

The one place where a config becomes a train step, shared by the Trainer
(train/loop.py) and ``tools/train_bench.py --default-config / --config``,
so the two cannot drift. It reads what linnaeus_tpu/train/loop.py reads
when it builds its step: the model (``MISC.SEED`` or the caller's seed),
remat for normal and GradNorm steps (TRAIN.GRADIENT_CHECKPOINTING), the
on-device augmentation (AUG.*, when AUG.SINGLE_AUG_DEVICE is 'device'), the
loss functions (LOSS.*), mixing (SCHEDULE.MIX), the clip, accumulation, the
optimizer with its parameter groups and schedules (OPTIMIZER.*,
LR_SCHEDULER.*), the EMA (TRAIN.EMA) and GradNorm's update
(LOSS.GRAD_WEIGHTING.TASK), whose step collates the train step's batch
again to re-forward it (``train_step.collated``). With ``pretrained`` it loads the
configured pretrained weights (MODEL.PRETRAINED*, utils/pretrained.py) into
the model before the optimizer and the EMA are built from it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping

import torch

from linnaeus_tpu_torch.data.augmentation.autoaugment import AugmentationPipelineFactory
from linnaeus_tpu_torch.data.collate import MixConfig
from linnaeus_tpu_torch.loss.gradnorm import make_gradnorm_update_fn
from linnaeus_tpu_torch.loss.utils import prepare_loss_functions
from linnaeus_tpu_torch.models.build import build_model
from linnaeus_tpu_torch.optim.build import build_optimizer
from linnaeus_tpu_torch.optim.schedules import build_group_schedules
from linnaeus_tpu_torch.parallel.mesh import replicate
from linnaeus_tpu_torch.parallel.model import apply_fsdp, check_parallel, shard_model
from linnaeus_tpu_torch.utils.meta import compute_meta_chunk_bounds, total_meta_dim
from linnaeus_tpu_torch.utils.param_filters import (
    resolve_gradnorm_exclude,
    trunk_mask_from_exclude,
)
from linnaeus_tpu_torch.utils.pretrained import Report, load_pretrained
from linnaeus_tpu_torch.utils.tracing import span

from .state import TrainState, create_train_state
from .step import make_gradnorm_step, make_train_step


@dataclass
class TrainParts:
    model: torch.nn.Module
    state: TrainState
    train_step: Callable
    # the GradNorm update on the batch the last train step consumed, or None
    gradnorm_step: Callable | None
    # the on-device augmentation pipeline the train step runs, or None
    augment: Callable | None
    train_criteria: dict[str, Callable]
    val_criteria: dict[str, Callable]
    schedules: dict[str, Callable]
    mix_cfg: MixConfig
    meta_dim: int
    # schedules by group label -> a new optimizer on the model and the train
    # step reading those schedules (AutoBatch rebuilds both for a new batch)
    optimizer_and_step: Callable
    # the pretrained loaders' reports by name (empty without pretrained init)
    pretrained_reports: dict[str, Report]


def mix_config(config) -> MixConfig:
    """SCHEDULE.MIX as the step's static mixing configuration."""
    mix = config.SCHEDULE.MIX
    if list(mix.LEVEL_SWITCH_STEPS or []) or list(mix.LEVEL_SWITCH_EPOCHS or []):
        # reference parity: scheduled group-level switching is explicitly
        # unsupported there too (main.py:483-491 raises the same way)
        raise NotImplementedError(
            "SCHEDULE.MIX.LEVEL_SWITCH_STEPS/EPOCHS are not supported; "
            "use a fixed GROUP_LEVELS priority list"
        )
    return MixConfig(
        mixup_alpha=float(mix.MIXUP.ALPHA),
        cutmix_alpha=float(mix.CUTMIX.ALPHA),
        cutmix_minmax=(tuple(float(v) for v in mix.CUTMIX.MINMAX)
                       if mix.CUTMIX.MINMAX else None),
        mixup_enabled=bool(mix.MIXUP.ENABLED),
        cutmix_enabled=bool(mix.CUTMIX.ENABLED),
        exclude_null=bool(mix.EXCLUDE_NULL_SAMPLES),
        null_task_keys=tuple(mix.NULL_TASK_KEYS or []),
        chunk_bounds=tuple(compute_meta_chunk_bounds(config)),
    )


def build_training(
    config,
    num_classes: Mapping[str, int],
    taxonomy_tree=None,
    *,
    device: torch.device,
    seed: int,
    total_steps: int,
    steps_per_epoch: int = 0,
    accumulation_steps: int | None = None,
    remat: bool | None = None,
    remat_policy: str | None = None,
    init_task_weights=None,
    pretrained: bool = False,
    mesh=None,
) -> TrainParts:
    """The training parts ``config`` names, on ``device``, the model drawn
    from ``seed`` and the state's generator seeded with it. ``remat`` /
    ``remat_policy`` override the config's for normal and GradNorm steps;
    ``accumulation_steps`` TRAIN.ACCUMULATION_STEPS; GradNorm's initial task
    weights are ``init_task_weights``, else INIT_WEIGHTS, else equal;
    ``pretrained`` loads MODEL.PRETRAINED* into the model first. ``mesh``
    (parallel/mesh.py) puts the model on the ranks by PARALLEL (the checks,
    the ring, the pipeline, the TP / EP shares, FSDP2) before the optimizer
    and the EMA are built on it, and the steps reduce over it. The call is
    the ``setup/build_training`` span, recorded whether tracing is on or
    not (utils/tracing.py)."""
    with span("setup/build_training", always=True):
        tasks = tuple(config.DATA.TASK_KEYS_H5)
        if tuple(num_classes) != tasks:
            raise ValueError(f"DATA.TASK_KEYS_H5 {list(tasks)} must name the tasks of "
                             f"num_classes {list(num_classes)}")
        if remat is not None or remat_policy is not None:
            config = config.clone()
            config.defrost()
            gc = config.TRAIN.GRADIENT_CHECKPOINTING
            if remat is not None:
                gc.ENABLED_NORMAL_STEPS = gc.ENABLED_GRADNORM_STEPS = bool(remat)
            if remat_policy is not None:
                gc.POLICY = remat_policy
        gc = config.TRAIN.GRADIENT_CHECKPOINTING
        model = build_model(config, dict(num_classes), taxonomy_tree, device=device, seed=seed)
        reports = load_pretrained(config, model) if pretrained else {}
        split: list[str] = []
        if mesh is not None:
            par = config.PARALLEL
            mode = str(par.get("PARAM_SHARDING", "replicated"))
            check_parallel(config, mesh, model)
            replicate(model, mesh)
            pipe = par.get("PIPELINE", {})
            split = shard_model(model, mesh, mode, bool(par.get("SEQUENCE_PARALLEL", False)),
                                int(pipe.get("STAGES", 1) or 1),
                                int(pipe.get("MICROBATCHES", 0) or 0))
            if mode == "fsdp":
                apply_fsdp(model, mesh)
        schedules = build_group_schedules(config, total_steps, steps_per_epoch)
        gw = config.LOSS.GRAD_WEIGHTING.TASK
        if init_task_weights is None:
            init_task_weights = list(gw.get("INIT_WEIGHTS") or []) or None
        ema = config.TRAIN.get("EMA", {})
        ema_on = bool(ema.get("ENABLED", False))
        train_criteria, val_criteria = prepare_loss_functions(
            config, dict(num_classes), taxonomy_tree, device=device)
        augment = None
        if str(config.AUG.SINGLE_AUG_DEVICE) == "device":
            # the 'cpu' path augments in the loader (data/build.py)
            augment = AugmentationPipelineFactory.create(config)
        gradnorm_on = str(gw.TYPE) == "gradnorm" and bool(gw.get("GRADNORM_ENABLED", True))
        meta_dim = total_meta_dim(config)
        mix_cfg = mix_config(config)
        if accumulation_steps is None:
            accumulation_steps = int(config.TRAIN.ACCUMULATION_STEPS)
        moe = config.MODEL.get("MOE", {})
        moe_on = bool(moe.get("ENABLED", False))

        def optimizer_and_step(schedules: dict[str, Callable]):
            optimizer = build_optimizer(config, schedules["default"], model, schedules)
            train_step = make_train_step(
                train_criteria, tasks, mix_cfg,
                clip_grad=float(config.TRAIN.CLIP_GRAD or 0.0),
                accumulation_steps=max(int(accumulation_steps), 1),
                phase1_mask_null=bool(config.TRAIN.PHASE1_MASK_NULL_LOSS),
                has_meta=meta_dim > 0, lr_schedule=schedules["default"],
                num_classes=dict(num_classes), augment_fn=augment,
                moe_aux_weight=(float(moe.get("AUX_LOSS_WEIGHT", 0.01)) if moe_on else 0.0),
                moe_z_weight=(float(moe.get("ROUTER_Z_LOSS_WEIGHT", 0.001)) if moe_on else 0.0),
                ema_decay=float(ema.DECAY) if ema_on else 0.0,
                mesh=mesh, model_split=split,
            )
            return optimizer, train_step

        optimizer, train_step = optimizer_and_step(schedules)
        state = create_train_state(
            model, optimizer, num_tasks=len(tasks),
            generator=torch.Generator(device=device).manual_seed(seed),
            init_task_weights=init_task_weights, lr_schedule=schedules, ema=ema_on,
        )
        gradnorm_step = None
        if gradnorm_on:
            trunk = trunk_mask_from_exclude(model, resolve_gradnorm_exclude(gw))
            gradnorm_step = make_gradnorm_step(make_gradnorm_update_fn(
                train_criteria, tasks, [n for n, keep in trunk.items() if keep],
                alpha=float(gw.ALPHA), zero_aux_info=bool(gw.ZERO_AUX_INFO),
                use_linear_heads=bool(gw.USE_LINEAR_HEADS_FOR_GRADNORM_REFORWARD),
                accum_steps=max(int(gw.get("GRADNORM_ACCUM_STEPS", 1) or 1), 1),
                remat=bool(gc.get("ENABLED_GRADNORM_STEPS", False)),
                mesh=mesh, model_split=split,
            ), train_step)
        return TrainParts(model, state, train_step, gradnorm_step, augment, train_criteria,
                          val_criteria, schedules, mix_cfg, meta_dim, optimizer_and_step, reports)
