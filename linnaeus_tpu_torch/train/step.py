"""Train and eval steps.

Port of linnaeus_tpu/train/step.py. One optimizer step: on-device
augmentation, mixing and meta-masking (collate semantics), forward in the
compute dtype, float32 loss, backward, float32 global-norm clip with the
norm measured before and after, optimizer update, optional EMA, metrics.
``make_gradnorm_step`` is the GradNorm update that the TPU package's Trainer
runs every UPDATE_INTERVAL steps on the batch the last step consumed. Where the TPU package
returns a new state from a pure, jitted function, this step updates the
``TrainState`` in place and returns it; metrics are device scalars, so the
step never waits for the device.

Mixed precision. The model keeps float32 parameters and computes in
``model.dtype`` (bfloat16 for training): every layer casts its weight to its
input's dtype with a differentiable ``.to()``, and the K1 and K2 autograd
Functions receive those bfloat16 casts, so each kernel's gradient flows back
through the cast into the float32 ``.grad`` of the master parameter (K2's
weight gradients are summed in float32 inside the kernel and cast once).
``torch.autocast`` is not used: it does not reach the kernels' C interface.
The loss, the clip and the update run in float32.

Randomness. Every draw of a step comes from ``state.generator`` in a fixed
order (augmentation, mix gate, permutation noise, lam, metadata picks,
meta-masking coins, partial-masking coins, drop-path and dropout masks in
layer order, null-masking coins per task). A step also accepts its collate
and loss draws as ``draws`` (the keys of data/collate.py plus ``augment``,
the draws of data/augmentation/autoaugment.py, ``meta_coins``,
``partial_coins`` and ``null_coins``), which is how it is held against the
TPU package's step.

The GradNorm re-forward. The TPU package re-derives the collated tensors of
the last step by regenerating that step's key and preprocessing the same
batch again. The port keeps the collated tensors themselves instead
(``keep_collated``, ``TrainState.last_collated``): the images in the
model's compute dtype, which is all its first op reads, the soft targets
and the metadata. At 384 px and B = 64 in bfloat16 that is 57 MB of images
(113 MB in float32) and 0.4 MB of targets for four tasks of 1530 classes,
held from one step to the next; no augmentation or mixing runs twice.

Gradient accumulation runs the microbatches in a Python loop, summing the
gradients on the parameters. MoE statistics and BatchNorm running stats are
not on mFormerV1's path and are not ported.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple, Sequence

import torch

from linnaeus_tpu_torch.data.collate import (
    MixConfig,
    apply_meta_masking,
    apply_mixing,
    apply_partial_meta_masking,
)
from linnaeus_tpu_torch.loss.basic import one_hot
from linnaeus_tpu_torch.loss.hierarchical import weighted_hierarchical_loss

from .state import Collated, TrainState

Draws = Mapping[str, Any]


class ScheduleScalars(NamedTuple):
    """Per-step schedule operands, computed on the host."""

    mix_prob: float | torch.Tensor
    use_cutmix: bool
    meta_mask_prob: float | torch.Tensor
    partial_mask_prob: float | torch.Tensor
    partial_combo_mask: torch.Tensor  # [meta_dim] 0/1
    null_mask_prob: float | torch.Tensor

    @classmethod
    def zeros(cls, meta_dim: int, device: torch.device | str | None = None):
        return cls(
            mix_prob=0.0,
            use_cutmix=False,
            meta_mask_prob=0.0,
            partial_mask_prob=0.0,
            partial_combo_mask=torch.zeros(meta_dim, device=device),
            null_mask_prob=1.0,
        )


def _valid_mask(targets: torch.Tensor) -> torch.Tensor:
    """[B] bool: the sample has a mapped label for this task. Unmapped
    labels (-1) one-hot to all-zero rows; without this mask their argmax (0)
    would count them as null-class samples in the accuracy denominators."""
    if targets.dim() == 2:
        return targets.sum(dim=-1) > 0
    return targets >= 0


def _topk_correct(logits: torch.Tensor, targets: torch.Tensor, k: int) -> torch.Tensor:
    """Count of valid samples whose true class is in the top-k predictions."""
    true_idx = targets.argmax(dim=-1) if targets.dim() == 2 else targets
    topk = logits.topk(k, dim=-1).indices
    return ((topk == true_idx[:, None]).any(dim=-1) & _valid_mask(targets)).sum()


def _accuracy_metrics(outputs, targets, prefix="") -> dict[str, torch.Tensor]:
    m = {}
    for task, logits in outputs.items():
        tgt = targets[task]
        n = _valid_mask(tgt).sum().float().clamp_min(1.0)
        m[f"{prefix}acc1/{task}"] = _topk_correct(logits, tgt, 1) / n
        m[f"{prefix}acc3/{task}"] = _topk_correct(logits, tgt, min(3, logits.shape[-1])) / n
    return m


def split_microbatches(batch: dict, accum: int, has_meta: bool = True) -> list[dict]:
    """The ``accum`` microbatches of ``batch``, in order: microbatch i holds
    rows [i * B / accum, (i + 1) * B / accum)."""

    def split(x):
        return x.reshape((accum, x.shape[0] // accum) + tuple(x.shape[1:]))

    stacks = {
        "images": split(batch["images"]),
        "targets": {t: split(v) for t, v in batch["targets"].items()},
    }
    if batch.get("aux") is not None and has_meta:
        stacks["aux"] = split(batch["aux"])
    if batch.get("group_ids") is not None:
        stacks["group_ids"] = split(batch["group_ids"])
    return [
        {k: ({t: v[i] for t, v in s.items()} if isinstance(s, dict) else s[i])
         for k, s in stacks.items()}
        for i in range(accum)
    ]


def _ensure_soft(targets, num_classes):
    out = {}
    for t, v in targets.items():
        if v.dim() == 1:
            if num_classes is None:
                raise ValueError("integer targets require num_classes")
            # -1 (unmapped) encodes to an all-zero row -> zero loss mass
            out[t] = one_hot(v, num_classes[t])
        else:
            out[t] = v
    return out


def make_preprocess_fn(
    mix_cfg: MixConfig,
    has_meta: bool = True,
    num_classes: dict[str, int] | None = None,
    augment_fn: Callable | None = None,
):
    """On-device collate: [0, 1] conversion -> augmentation -> mixing ->
    meta-masking, the TPU package's order. ``augment_fn`` is the pipeline of
    data/augmentation/autoaugment.py (``augment(images, generator,
    draws)``) or None. Returns ``preprocess(batch, scalars, generator,
    draws) -> (images, targets, meta, mixed_mask)``."""

    def preprocess(batch, scalars: ScheduleScalars, generator=None, draws: Draws | None = None):
        draws = draws or {}
        images = batch["images"]
        if not images.is_floating_point():
            # uint8 host pipeline -> on-device [0, 1] float
            images = images.float() * (1.0 / 255.0)
        if augment_fn is not None:
            images = augment_fn(images.float(), generator, draws.get("augment")).to(images.dtype)
        targets = _ensure_soft(batch["targets"], num_classes)
        meta = batch.get("aux") if has_meta else None
        group_ids = batch.get("group_ids")
        if group_ids is None:
            group_ids = torch.zeros(images.shape[0], dtype=torch.int32, device=images.device)
        images, targets, meta, mixed_mask = apply_mixing(
            images, targets, meta, group_ids, mix_cfg,
            scalars.mix_prob, scalars.use_cutmix, generator, draws,
        )
        if meta is not None:
            meta, masked_flags = apply_meta_masking(
                meta, scalars.meta_mask_prob, generator, draws.get("meta_coins"))
            meta = apply_partial_meta_masking(
                meta, scalars.partial_mask_prob, scalars.partial_combo_mask,
                masked_flags, generator, draws.get("partial_coins"),
            )
        return images, targets, meta, mixed_mask

    return preprocess


def make_train_step(
    criteria: dict[str, Callable],
    task_keys: tuple[str, ...],
    mix_cfg: MixConfig,
    clip_grad: float = 0.0,
    accumulation_steps: int = 1,
    phase1_mask_null: bool = False,
    apply_class_weights: bool = True,
    class_weights: dict[str, Any] | None = None,
    has_meta: bool = True,
    lr_schedule: Callable | None = None,
    num_classes: dict[str, int] | None = None,
    moe_aux_weight: float = 0.0,
    moe_z_weight: float = 0.0,
    ema_decay: float = 0.0,
    augment_fn: Callable | None = None,
    keep_collated: bool = False,
):
    """Build the train step.

    Returned fn: ``train_step(state, batch, scalars, draws=None) ->
    (state, metrics)`` where batch = {images, targets: {task: one-hot [B, C]
    or int [B]}, aux, group_ids}, all on the model's device. Integer labels
    are one-hot encoded on the device (requires ``num_classes``). ``state``
    is updated in place. ``draws`` is one dict, or one per microbatch.
    ``lr_schedule`` only reports the rate in the metrics; the rate that is
    applied is ``state.lr_schedule``'s. ``augment_fn`` augments the images
    after their [0, 1] conversion. ``keep_collated`` leaves what the forward
    consumed in ``state.last_collated`` for the GradNorm step.
    """
    if moe_aux_weight > 0.0 or moe_z_weight > 0.0:
        raise NotImplementedError(
            "make_train_step: MoE auxiliary losses are not ported yet (MoE is not on "
            "mFormerV1's path)"
        )
    accum = max(int(accumulation_steps), 1)
    task_keys = tuple(task_keys)
    preprocess = make_preprocess_fn(mix_cfg, has_meta=has_meta, num_classes=num_classes,
                                    augment_fn=augment_fn)

    def forward_backward(state, batch, scalars, draws, kept):
        """Collate, forward, loss and backward of one (micro)batch; the
        gradients are added onto the parameters' ``.grad``; with
        ``keep_collated`` the collated tensors are appended to ``kept``."""
        images, targets, meta, mixed_mask = preprocess(batch, scalars, state.generator, draws)
        if keep_collated:
            kept.append(Collated(images.detach().to(state.model.dtype), targets,
                                 None if meta is None else meta.detach()))
        outputs = state.model(images, meta)
        total, components = weighted_hierarchical_loss(
            outputs, targets, criteria, state.gradnorm.task_weights,
            scalars.null_mask_prob, state.generator, (draws or {}).get("null_coins"),
            class_weights=class_weights,
            phase1_mask_null=phase1_mask_null,
            apply_class_weights=apply_class_weights,
            task_keys=task_keys,
        )
        total.backward()
        outputs = {t: v.detach() for t, v in outputs.items()}
        return total.detach(), outputs, components, mixed_mask

    def train_step(state: TrainState, batch: dict, scalars: ScheduleScalars,
                   draws: Draws | Sequence[Draws] | None = None):
        model = state.model
        if any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm) for m in model.modules()):
            raise NotImplementedError(
                "make_train_step: BatchNorm running stats are not ported yet (mFormerV1 "
                "has none)"
            )
        model.train()
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:
            p.grad = None

        metrics: dict[str, torch.Tensor | float] = {}
        kept: list[Collated] = []
        if accum == 1:
            if draws is not None and not isinstance(draws, Mapping):
                (draws,) = draws
            total, outputs, components, mixed_mask = forward_backward(
                state, batch, scalars, draws, kept)
            for t in task_keys:
                metrics[f"loss/{t}"] = components["tasks"][t].detach()
            metrics.update(_accuracy_metrics(outputs, batch["targets"]))
            metrics["mixed_frac"] = mixed_mask.float().mean()
        else:
            micro = split_microbatches(batch, accum, has_meta)
            per_micro = list(draws) if draws is not None else [None] * accum
            total = 0.0
            stats: dict[str, torch.Tensor | float] = {}

            def add(key, value):
                stats[key] = stats.get(key, 0.0) + value

            for mb, mb_draws in zip(micro, per_micro):
                mb_total, mb_out, mb_comp, mb_mixed = forward_backward(
                    state, mb, scalars, mb_draws, kept)
                total = total + mb_total
                add("mixed", mb_mixed.float().sum())
                # accuracy counts against the raw microbatch targets
                # (before mixing), like the accum == 1 path
                for t in task_keys:
                    raw = mb["targets"][t]
                    add(f"loss/{t}", mb_comp["tasks"][t].detach())
                    add(f"correct1/{t}", _topk_correct(mb_out[t], raw, 1).float())
                    add(f"correct3/{t}",
                        _topk_correct(mb_out[t], raw, min(3, mb_out[t].shape[-1])).float())
                    add(f"valid/{t}", _valid_mask(raw).sum().float())
            torch._foreach_div_([p.grad for p in params if p.grad is not None], accum)
            total = total / accum
            metrics["mixed_frac"] = stats["mixed"] / float(batch["images"].shape[0])
            for t in task_keys:
                metrics[f"loss/{t}"] = stats[f"loss/{t}"] / accum
                denom = stats[f"valid/{t}"].clamp_min(1.0)
                metrics[f"acc1/{t}"] = stats[f"correct1/{t}"] / denom
                metrics[f"acc3/{t}"] = stats[f"correct3/{t}"] / denom

        if keep_collated:
            state.last_collated = kept[0] if len(kept) == 1 else Collated(
                torch.cat([k.images for k in kept]),
                {t: torch.cat([k.targets[t] for k in kept]) for t in kept[0].targets},
                None if kept[0].meta is None else torch.cat([k.meta for k in kept]))

        # the parameters are float32, so are their gradients: the clip and
        # the update run in float32
        grads = [p.grad for p in params if p.grad is not None]
        pre_clip_norm = torch.nn.utils.get_total_norm(grads, norm_type=2.0)
        if clip_grad and clip_grad > 0:
            scale = (clip_grad / (pre_clip_norm + 1e-6)).clamp(max=1.0)
            torch._foreach_mul_(grads, scale)
        post_clip_norm = torch.nn.utils.get_total_norm(grads, norm_type=2.0)

        step_before = state.step
        state.apply_gradients()
        if ema_decay and ema_decay > 0:
            if state.ema_params is None:
                raise ValueError("ema_decay > 0 needs create_train_state(..., ema=True)")
            with torch.no_grad():
                for name, p in model.named_parameters():
                    state.ema_params[name].mul_(ema_decay).add_(p.detach(), alpha=1.0 - ema_decay)

        metrics.update({
            "loss": total,
            "grad_norm_pre_clip": pre_clip_norm,
            "grad_norm_post_clip": post_clip_norm,
            "task_weights": state.gradnorm.task_weights,
        })
        if lr_schedule is not None:
            metrics["lr"] = lr_schedule(step_before)
        return state, metrics

    return train_step


def make_gradnorm_step(update: Callable) -> Callable:
    """The GradNorm update on what the last train step consumed:
    ``gradnorm_step(state) -> (state, metrics)`` runs ``update``
    (loss/gradnorm.py::make_gradnorm_update_fn) on
    ``state.last_collated`` (a train step built with ``keep_collated``) and
    writes the new task weights into ``state.gradnorm``. Under accumulation
    the collated microbatches are re-forwarded as one batch, as the TPU
    package's Trainer concatenates them."""

    def gradnorm_step(state: TrainState):
        if state.last_collated is None:
            raise ValueError(
                "gradnorm_step: no collated batch; build the train step with keep_collated=True "
                "and take a step first")
        images, targets, meta = state.last_collated
        state.gradnorm, metrics = update(state.model, images, targets, meta, state.gradnorm)
        return state, metrics

    return gradnorm_step


def make_eval_step(
    criteria: dict[str, Callable],
    task_keys: tuple[str, ...],
    has_meta: bool = True,
    num_classes: dict[str, int] | None = None,
    null_tasks: tuple[str, ...] = (),
    subset_bins: dict | None = None,
    taxa_selectors: dict | None = None,
):
    """Validation step: deterministic forward + unmasked loss + top-k counts.

    ``mask_meta`` zeroes the whole aux vector; ``partial_combo_mask`` is a
    [meta_dim] 0/1 vector of columns to zero. ``null_tasks``: tasks whose
    top-1 counts are split by null (class 0) vs non-null labels.
    ``subset_bins``: task -> integer [num_classes] class -> rarity-bin
    table; counts come back as ``subset_correct1/rarity_<bin>/<task>`` with
    matching ``subset_count/``. ``taxa_selectors``: subset name ->
    (rank_key, class_index); samples whose target at rank_key equals
    class_index contribute per-task counts.
    """
    task_keys = tuple(task_keys)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict, mask_meta, partial_combo_mask):
        images = batch["images"]
        if not images.is_floating_point():
            images = images.float() * (1.0 / 255.0)
        if num_classes is None and any(v.dim() == 1 for v in batch["targets"].values()):
            raise ValueError(
                "eval_step: integer targets require num_classes "
                "(pass make_eval_step(..., num_classes=...))"
            )
        targets = _ensure_soft(batch["targets"], num_classes)
        meta = batch.get("aux") if has_meta else None
        if meta is not None:
            mask_meta = torch.as_tensor(mask_meta, device=meta.device)
            meta = torch.where(mask_meta, torch.zeros_like(meta), meta)
            meta = meta * (1.0 - partial_combo_mask)[None, :].to(meta.dtype)
        state.model.eval()
        outputs = state.model(images, meta)
        total, components = weighted_hierarchical_loss(
            outputs, targets, criteria,
            torch.ones(len(task_keys), device=images.device), 1.0,
            is_validation=True, task_keys=task_keys,
        )
        metrics = {"loss": total, "count": float(images.shape[0])}
        for t in task_keys:
            metrics[f"loss/{t}"] = components["tasks"][t]
            metrics[f"correct1/{t}"] = _topk_correct(outputs[t], targets[t], 1)
            k3 = min(3, outputs[t].shape[-1])
            metrics[f"correct3/{t}"] = _topk_correct(outputs[t], targets[t], k3)
            valid = _valid_mask(targets[t]).float()
            metrics[f"valid_count/{t}"] = valid.sum()
            tgt_idx = targets[t].argmax(dim=-1)
            top1 = (outputs[t].argmax(dim=-1) == tgt_idx).float() * valid
            if t in null_tasks:
                is_null = (tgt_idx == 0).float() * valid
                non_null = (tgt_idx != 0).float() * valid
                metrics[f"subset_correct1/null/{t}"] = (top1 * is_null).sum()
                metrics[f"subset_count/null/{t}"] = is_null.sum()
                metrics[f"subset_correct1/non_null/{t}"] = (top1 * non_null).sum()
                metrics[f"subset_count/non_null/{t}"] = non_null.sum()
            table = (subset_bins or {}).get(t)
            if table is not None:
                table = torch.as_tensor(table, device=tgt_idx.device)
                bins = table[tgt_idx]
                for bi in range(int(table.max()) + 1):
                    sel = (bins == bi).float() * valid
                    metrics[f"subset_correct1/rarity_{bi}/{t}"] = (top1 * sel).sum()
                    metrics[f"subset_count/rarity_{bi}/{t}"] = sel.sum()
            for name, (rank_key, cid) in (taxa_selectors or {}).items():
                sel = ((targets[rank_key].argmax(dim=-1) == cid)
                       & _valid_mask(targets[rank_key])).float() * valid
                metrics[f"subset_correct1/taxa_{name}/{t}"] = (top1 * sel).sum()
                metrics[f"subset_count/taxa_{name}/{t}"] = sel.sum()
        return metrics, outputs

    return eval_step
