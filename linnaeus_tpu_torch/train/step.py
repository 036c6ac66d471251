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
batch again. The port does the same: a train step saves the generator's
state before each microbatch's collate (``TrainState.collate_rng``, 16 bytes
a microbatch on the card), and ``train_step.collated`` collates the same
batch again from those states, so no collated tensor is held from one step
to the next (at 384 px and B = 64 that was 57 MB of bfloat16 images).

Gradient accumulation runs the microbatches in a Python loop, summing the
gradients on the parameters.

Spans (utils/tracing.py; off unless a profiler records): ``train_step``
around the call; inside it ``train_step/collate``, ``/forward``, ``/loss``
(the MoE terms included) and ``/backward`` once a microbatch,
``train_step/grad_sync`` (with a mesh: the counts' all-reduce and the
gradients' sums), ``train_step/clip`` (both global norms and the scale) and
``train_step/update`` (the optimizer and the EMA).

More than one rank (``mesh``, parallel/mesh.py). Every rank computes its
share of what the one-process step computes on the global batch, as the TPU
package's step does under ``jit`` over its mesh: each rank is handed its
rows; the step gathers the small parts of the global (micro)batch (targets,
metadata, group ids) and makes the global batch's draws on every rank alike
(one generator, the same draws everywhere); each rank collates its chunk of
the (micro)batch: it fetches only the raw images it needs from the ranks
that hold them (its chunk under accumulation, its chunk's mixing partners
that sit elsewhere; parallel/ops.py::fetch_rows), augments those with their
rows of the global draws and mixes (``make_preprocess_fn``'s ``rows``). The
forward runs on this rank's rows (the model's draws and BatchNorm
statistics are the global batch's, parallel/model.py); the loss sums its
per-task sums and counts over the data axis (loss/hierarchical.py), so the
loss is the global batch's, the same on every rank, and so are the metrics,
whose counts are summed over the axis too. The backward leaves each rank
its rows' share of the gradients, which are summed over the data axis (one
flat all-reduce in a fixed order; under FSDP2 its reduce-scatter, summing),
and, for the parameters ``model_split`` names (the pipeline's towers), over
the model axis first. The clip's norm is the whole gradient's
(parallel/model.py::grad_norm: the squares of the norms of FSDP2's shards
and the model axis's shares summed over their axes). A data axis of one rank is the one-process step.

MoE. With ``moe_aux_weight`` or ``moe_z_weight`` above zero the step asks
the model for its MoE statistics (``model(..., moe_stats=True)``: the
load-balance loss, the router z-loss and the dropped share, averaged over
the MoE layers; models/mformer_v1.py), adds ``moe_aux_weight * aux +
moe_z_weight * z`` to the loss it differentiates and reports that total as
``loss``, with the three statistics as ``moe_aux``, ``moe_z`` and
``moe_drop_frac`` (averaged over microbatches under accumulation), as the
TPU package's step collects its ``intermediates``. The eval step, the
GradNorm re-forward and serving never ask for them.

BatchNorm running statistics (mFormerV0; models/blocks/common.py::BatchNorm)
are buffers that a training-mode forward updates, so they follow the TPU
package's rules with nothing here to carry them: a train step updates them
once per microbatch, in microbatch order, as the TPU package carries
``batch_stats`` through its accumulation scan; the eval step and the
GradNorm re-forward run the model in eval mode, which normalises with them
and leaves them alone (the TPU package's ``deterministic=True``); the EMA
averages parameters only, so an EMA evaluation uses the live statistics; a
checkpoint and ``restore_snapshot`` carry them in the model's state_dict.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple, Sequence

import torch

import numpy as np

from linnaeus_tpu_torch.data.augmentation.autoaugment import take_rows
from linnaeus_tpu_torch.data.collate import (
    MixConfig,
    _sample_beta,
    _uniform,
    apply_meta_masking,
    apply_mixing,
    apply_partial_meta_masking,
    hard_pick_meta,
    mix_images,
    mix_targets,
    plan_mixing,
    uses_cutmix,
)
from linnaeus_tpu_torch.loss.basic import one_hot
from linnaeus_tpu_torch.loss.hierarchical import weighted_hierarchical_loss
from linnaeus_tpu_torch.parallel.model import grad_norm
from linnaeus_tpu_torch.parallel.ops import (
    all_reduce_,
    fetch_rows,
    gather_rows,
    group_rank,
    group_size,
    split_rows,
)
from linnaeus_tpu_torch.utils.tracing import span

from .state import TrainState

Draws = Mapping[str, Any]
MOE_KEYS = ("moe_aux", "moe_z", "moe_drop_frac")


class ScheduleScalars(NamedTuple):
    """Per-step schedule operands, computed on the host."""

    mix_prob: float | torch.Tensor
    use_cutmix: bool
    meta_mask_prob: float | torch.Tensor
    partial_mask_prob: float | torch.Tensor
    partial_combo_mask: torch.Tensor  # [meta_dim] 0/1
    null_mask_prob: float | torch.Tensor

    @classmethod
    def from_ops_schedule(cls, ops_schedule, step: int, meta_dim: int, combo_mask=None,
                          device: torch.device | str | None = None):
        """The schedule's values at ``step`` (ops_schedule/ops_schedule.py);
        ``combo_mask`` is the [meta_dim] 0/1 partial-masking columns."""
        if combo_mask is None:
            combo_mask = torch.zeros(meta_dim)
        return cls(
            mix_prob=float(ops_schedule.get_mixup_prob(step)),
            use_cutmix=bool(ops_schedule.should_use_cutmix()),
            meta_mask_prob=float(ops_schedule.get_meta_mask_prob(step)),
            partial_mask_prob=float(ops_schedule.get_partial_meta_mask_prob(step)),
            partial_combo_mask=torch.as_tensor(combo_mask, dtype=torch.float32, device=device),
            null_mask_prob=float(ops_schedule.get_null_mask_prob(step)),
        )

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


def _count_metrics(outputs, targets) -> dict[str, torch.Tensor]:
    """Top-1 and top-3 hits and valid rows by task, as float32 counts."""
    out = {}
    for t, logits in outputs.items():
        tgt = targets[t]
        out[f"correct1/{t}"] = _topk_correct(logits, tgt, 1).float()
        out[f"correct3/{t}"] = _topk_correct(logits, tgt, min(3, logits.shape[-1])).float()
        out[f"valid/{t}"] = _valid_mask(tgt).sum().float()
    return out


BATCH_KEYS = ("images", "targets", "aux", "group_ids")


def split_microbatches(batch: dict, accum: int, has_meta: bool = True) -> list[dict]:
    """The ``accum`` microbatches of ``batch``, in order: microbatch i holds
    rows [i * B / accum, (i + 1) * B / accum)."""

    def split(x):
        return x.reshape((accum, x.shape[0] // accum) + tuple(x.shape[1:]))

    stacks = {}
    for k in BATCH_KEYS:
        v = batch.get(k)
        if v is None or (k == "aux" and not has_meta):
            continue
        stacks[k] = {t: split(x) for t, x in v.items()} if isinstance(v, dict) else split(v)
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


def _to_unit(images: torch.Tensor) -> torch.Tensor:
    """uint8 host pipeline -> on-device [0, 1] float"""
    return images if images.is_floating_point() else images.float() * (1.0 / 255.0)


def make_preprocess_fn(
    mix_cfg: MixConfig,
    has_meta: bool = True,
    num_classes: dict[str, int] | None = None,
    augment_fn: Callable | None = None,
):
    """On-device collate: [0, 1] conversion -> augmentation -> mixing ->
    meta-masking, the TPU package's order. ``augment_fn`` is the pipeline of
    data/augmentation/autoaugment.py (``augment(images, generator,
    draws)``, ``augment.draw``) or None. Returns ``preprocess(batch,
    scalars, generator, draws) -> (images, targets, meta, mixed_mask)``.

    Every draw is made first, in a fixed order (``preprocess.draw``), then
    applied. ``preprocess.rows(batch, images, offset, group, ...)`` is the
    same collate over a data group: ``batch`` holds the global (micro)batch's
    targets, metadata and group ids, ``images`` this rank's raw rows of the
    whole global batch, ``offset`` where the (micro)batch starts in it; it
    returns this rank's chunk of what ``preprocess`` returns for the global
    (micro)batch, augmenting only that chunk and the mixing partners it
    fetched from other ranks (parallel/ops.py::fetch_rows)."""
    mixing = mix_cfg.mixup_enabled or mix_cfg.cutmix_enabled

    def draw(n, size, meta_on, scalars, generator, device, draws=None) -> dict:
        """Every draw of collating ``n`` images of ``size`` (H, W); those
        in ``draws`` are taken as given."""
        out = dict(draws or {})

        def take(key, fn):
            if key not in out:
                out[key] = fn()

        if augment_fn is not None:
            take("augment", lambda: augment_fn.draw(n, *size, generator, device))
        if mixing:
            cutmix = uses_cutmix(mix_cfg, scalars.use_cutmix)
            take("gate", lambda: _uniform((), device, generator))
            take("perm_noise", lambda: _uniform((n,), device, generator))
            take("lam", lambda: _sample_beta(
                mix_cfg.cutmix_alpha if cutmix else mix_cfg.mixup_alpha, device, generator))
            if cutmix and ("cy" not in out or "cx" not in out):
                out["cy"] = torch.randint(0, size[0], (), generator=generator, device=device)
                out["cx"] = torch.randint(0, size[1], (), generator=generator, device=device)
            if meta_on and mix_cfg.chunk_bounds:
                take("meta_pick", lambda: torch.stack(
                    [_uniform((n,), device, generator) < 0.5 for _ in mix_cfg.chunk_bounds]))
        if meta_on:
            take("meta_coins", lambda: _uniform((n,), device, generator))
            take("partial_coins", lambda: _uniform((n,), device, generator))
        return out

    def mask_meta(meta, scalars, draws):
        if meta is None:
            return None
        meta, masked_flags = apply_meta_masking(meta, scalars.meta_mask_prob,
                                                coins=draws["meta_coins"])
        return apply_partial_meta_masking(meta, scalars.partial_mask_prob,
                                          scalars.partial_combo_mask, masked_flags,
                                          coins=draws["partial_coins"])

    def parts(batch, n, device):
        targets = _ensure_soft(batch["targets"], num_classes)
        meta = batch.get("aux") if has_meta else None
        group_ids = batch.get("group_ids")
        if group_ids is None:
            group_ids = torch.zeros(n, dtype=torch.int32, device=device)
        return targets, meta, group_ids

    def preprocess(batch, scalars: ScheduleScalars, generator=None, draws: Draws | None = None):
        images = _to_unit(batch["images"])
        targets, meta, group_ids = parts(batch, images.shape[0], images.device)
        draws = draw(images.shape[0], tuple(images.shape[1:3]), meta is not None, scalars,
                     generator, images.device, draws)
        if augment_fn is not None:
            images = augment_fn(images.float(), None, draws["augment"]).to(images.dtype)
        images, targets, meta, mixed_mask = apply_mixing(
            images, targets, meta, group_ids, mix_cfg,
            scalars.mix_prob, scalars.use_cutmix, None, draws,
        )
        return images, targets, mask_meta(meta, scalars, draws), mixed_mask

    def rows(batch, images, offset, group, scalars: ScheduleScalars, generator=None,
             draws: Draws | None = None):
        P, me = group_size(group), group_rank(group)
        device = images.device
        n = next(iter(batch["targets"].values())).shape[0]
        if n % P:
            raise ValueError(f"collate: {n} rows do not split over {P} data ranks")
        chunk = n // P
        targets, meta, group_ids = parts(batch, n, device)
        size = tuple(images.shape[1:3])
        draws = draw(n, size, meta is not None, scalars, generator, device, draws)
        targets = {t: v.float() for t, v in targets.items()}
        own = torch.arange(me * chunk, (me + 1) * chunk, device=device)
        need = [np.arange(q * chunk, (q + 1) * chunk) for q in range(P)]
        plan = None
        if mixing:
            gate = draws["gate"] < scalars.mix_prob
            plan = plan_mixing(group_ids, targets, mix_cfg,
                               uses_cutmix(mix_cfg, scalars.use_cutmix), size, None, draws, gate)
            perm, mask = plan.perm.cpu().numpy(), plan.mask.cpu().numpy()
            for q, mine in enumerate(need):  # each rank's chunk, then its partners elsewhere
                partners = np.unique(perm[mine][mask[mine]])
                need[q] = np.concatenate([mine, partners[(partners // chunk) != q]])
            targets = {t: v[own] for t, v in
                       mix_targets(targets, plan.perm, plan.lam, plan.mask).items()}
            meta = hard_pick_meta(meta, plan.perm, plan.mask, mix_cfg.chunk_bounds,
                                  picks=draws.get("meta_pick"))
        else:
            targets = {t: v[own] for t, v in targets.items()}
        meta = mask_meta(meta, scalars, draws)
        fetched = _to_unit(fetch_rows(images, [q + offset for q in need], group))
        if augment_fn is not None:
            picked = torch.from_numpy(need[me]).to(device)
            fetched = augment_fn(fetched.float(), None,
                                 take_rows(draws["augment"], picked)).to(fetched.dtype)
        out = fetched[:chunk]
        if plan is None:
            mixed = torch.zeros(chunk, dtype=torch.bool, device=device)
        else:
            where = np.zeros(n, dtype=np.int64)
            where[need[me]] = np.arange(len(need[me]))
            mine = need[me][:chunk]
            partner = where[np.where(mask[mine], perm[mine], mine)]
            mixed = plan.mask[own]
            out = mix_images(out, fetched[torch.from_numpy(partner).to(device)], mixed, plan)
        return out, targets, None if meta is None else meta[own], mixed

    preprocess.draw, preprocess.rows = draw, rows
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
    mesh=None,
    model_split: Sequence[str] = (),
):
    """Build the train step.

    Returned fn: ``train_step(state, batch, scalars, draws=None) ->
    (state, metrics)`` where batch = {images, targets: {task: one-hot [B, C]
    or int [B]}, aux, group_ids}, all on the model's device. Integer labels
    are one-hot encoded on the device (requires ``num_classes``). ``state``
    is updated in place. ``draws`` is one dict, or one per microbatch.
    ``lr_schedule`` only reports the rate in the metrics; the rate that is
    applied is ``state.lr_schedule``'s. ``augment_fn`` augments the images
    after their [0, 1] conversion. ``mesh``: the batch is this rank's rows
    (module docstring); ``model_split`` the parameters whose gradients are
    summed over the model axis. ``train_step.collated(state, batch,
    scalars, draws=None)`` regenerates what the last step's forwards
    consumed (the GradNorm re-forward's batch).
    """
    accum = max(int(accumulation_steps), 1)
    data_group = None if mesh is None else mesh.group("data")
    if group_size(data_group) == 1:
        data_group = None
    model_group = None if mesh is None else mesh.group("model")
    model_split = frozenset(model_split)
    collect_moe = moe_aux_weight > 0.0 or moe_z_weight > 0.0
    task_keys = tuple(task_keys)
    preprocess = make_preprocess_fn(mix_cfg, has_meta=has_meta, num_classes=num_classes,
                                    augment_fn=augment_fn)

    def microbatches(batch, scalars, draws):
        """(targets, draws, collate) of each microbatch: ``collate(generator)``
        gives (images, targets, meta, mixed_mask) of this rank's rows, the
        targets are the microbatch's raw ones (the global batch's over a
        data group)."""
        if draws is None:
            per_micro = [None] * accum
        else:
            per_micro = [draws] if isinstance(draws, Mapping) else list(draws)
        if data_group is None:
            micro = [batch] if accum == 1 else split_microbatches(batch, accum, has_meta)
            return [(mb["targets"], d, lambda g, mb=mb, d=d: preprocess(mb, scalars, g, d))
                    for mb, d in zip(micro, per_micro)]
        small = gather_batch({k: batch.get(k) for k in BATCH_KEYS[1:]}, data_group)
        micro = [small] if accum == 1 else split_microbatches(small, accum, has_meta)
        n = len(next(iter(small["targets"].values()))) // accum
        return [(mb["targets"], d, lambda g, mb=mb, d=d, i=i: preprocess.rows(
                    mb, batch["images"], i * n, data_group, scalars, g, d))
                for i, (mb, d) in enumerate(zip(micro, per_micro))]

    def collated(state: TrainState, batch: dict, scalars: ScheduleScalars,
                 draws: Draws | Sequence[Draws] | None = None):
        """(images in the model's compute dtype, soft targets, meta) that
        the last train step's forwards consumed, regenerated from the same
        batch, scalars and draws and the generator states that step saved
        before each microbatch's collate; microbatches joined."""
        if state.collate_rng is None:
            raise ValueError("collated: no train step has run on this state")
        gen = torch.Generator(device=state.generator.device)
        out = []
        for (_, _, collate), rng in zip(microbatches(batch, scalars, draws), state.collate_rng):
            gen.set_state(rng)
            images, targets, meta, _ = collate(gen)
            out.append((images.to(state.model.dtype), targets, meta))
        images = torch.cat([o[0] for o in out])
        targets = {t: torch.cat([o[1][t] for o in out]) for t in out[0][1]}
        meta = None if out[0][2] is None else torch.cat([o[2] for o in out])
        return images, targets, meta

    def forward_backward(state, collate, raw_targets, scalars, draws):
        """Collate, forward, loss and backward of one (micro)batch; the
        gradients are added onto the parameters' ``.grad``."""
        state.collate_rng.append(state.generator.get_state())
        with span("train_step/collate"):
            images, targets, meta, mixed_mask = collate(state.generator)
        moe = None
        with span("train_step/forward"):
            if collect_moe and hasattr(state.model, "moe_num_experts"):
                outputs, moe = state.model(images, meta, moe_stats=True)
            else:
                outputs = state.model(images, meta)
        with span("train_step/loss"):
            total, components = weighted_hierarchical_loss(
                outputs, targets, criteria, state.gradnorm.task_weights,
                scalars.null_mask_prob, state.generator, (draws or {}).get("null_coins"),
                class_weights=class_weights,
                phase1_mask_null=phase1_mask_null,
                apply_class_weights=apply_class_weights,
                task_keys=task_keys,
                group=data_group,
            )
            if moe is not None:
                # the reported total is the optimised one, aux terms included
                total = total + moe_aux_weight * moe["moe_aux"] + moe_z_weight * moe["moe_z"]
                components = dict(components, **{k: v.detach() for k, v in moe.items()})
        with span("train_step/backward"):
            total.backward()
        # accuracy counts against the raw targets (before mixing)
        counts = _count_metrics({t: v.detach() for t, v in outputs.items()}, raw_targets)
        counts["mixed"] = mixed_mask.float().sum()
        return total.detach(), components, counts

    def train_step(state: TrainState, batch: dict, scalars: ScheduleScalars,
                   draws: Draws | Sequence[Draws] | None = None):
        with span("train_step"):
            return one_step(state, batch, scalars, draws)

    def one_step(state, batch, scalars, draws):
        model = state.model
        model.train()
        if hasattr(model, "reshard"):
            # FSDP2 leaves a model unsharded after a forward without a
            # backward (validation): the parameters are the shards again
            model.reshard()
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        state.collate_rng = []

        total = 0.0
        stats: dict[str, torch.Tensor | float] = {}
        rows = 0
        for mb_targets, mb_draws, collate in microbatches(batch, scalars, draws):
            raw = mb_targets if data_group is None else {
                t: split_rows(v, data_group) for t, v in mb_targets.items()}
            mb_total, mb_comp, counts = forward_backward(state, collate, raw, scalars, mb_draws)
            total = total + mb_total
            rows += len(next(iter(mb_targets.values())))
            for k, v in counts.items():
                stats[k] = stats.get(k, 0.0) + v
            for k in MOE_KEYS:
                if k in mb_comp:
                    stats[k] = stats.get(k, 0.0) + mb_comp[k]
            for t in task_keys:
                stats[f"loss/{t}"] = stats.get(f"loss/{t}", 0.0) + mb_comp["tasks"][t].detach()
        if accum > 1:
            torch._foreach_div_([local(p.grad) for p in params if p.grad is not None], accum)
            total = total / accum
        if mesh is not None:
            with span("train_step/grad_sync"):
                if data_group is not None:  # the counts of every rank's rows
                    keys = [k for k in stats if not k.startswith(("loss/", "moe_"))]
                    summed = torch.stack([stats[k] for k in keys])
                    torch.distributed.all_reduce(summed, group=data_group)
                    stats.update(zip(keys, summed))
                reduce_gradients(model, model_split, data_group, model_group)
        metrics: dict[str, torch.Tensor | float] = {"mixed_frac": stats["mixed"] / float(rows)}
        for k in MOE_KEYS:
            if k in stats:
                metrics[k] = stats[k] / accum
        for t in task_keys:
            metrics[f"loss/{t}"] = stats[f"loss/{t}"] / accum
            denom = stats[f"valid/{t}"].clamp_min(1.0)
            metrics[f"acc1/{t}"] = stats[f"correct1/{t}"] / denom
            metrics[f"acc3/{t}"] = stats[f"correct3/{t}"] / denom

        # the parameters are float32, so are their gradients: the clip and
        # the update run in float32
        with span("train_step/clip"):
            grads = [local(p.grad) for p in params if p.grad is not None]
            pre_clip_norm = grad_norm([(p, p.grad) for p in params], data_group)
            if clip_grad and clip_grad > 0:
                scale = (clip_grad / (pre_clip_norm + 1e-6)).clamp(max=1.0)
                torch._foreach_mul_(grads, scale)
            post_clip_norm = grad_norm([(p, p.grad) for p in params], data_group)

        step_before = state.step
        with span("train_step/update"):
            state.apply_gradients()
            if ema_decay and ema_decay > 0:
                if state.ema_params is None:
                    raise ValueError("ema_decay > 0 needs create_train_state(..., ema=True)")
                with torch.no_grad():
                    for name, p in model.named_parameters():
                        state.ema_params[name].mul_(ema_decay).add_(p.detach(),
                                                                    alpha=1.0 - ema_decay)

        metrics.update({
            "loss": total,
            "grad_norm_pre_clip": pre_clip_norm,
            "grad_norm_post_clip": post_clip_norm,
            "task_weights": state.gradnorm.task_weights,
        })
        if lr_schedule is not None:
            metrics["lr"] = lr_schedule(step_before)
        return state, metrics

    train_step.collated = collated
    return train_step


def local(t):
    """The local tensor of a DTensor (a shard under FSDP), else ``t``."""
    return t.to_local() if hasattr(t, "to_local") else t


def gather_batch(batch: dict, group) -> dict:
    """A batch of every rank's rows in rank order: the global batch."""
    if group is None:
        return batch

    def cat(x):
        return None if x is None else gather_rows(x, group)

    return {k: ({t: cat(v) for t, v in val.items()} if isinstance(val, dict) else cat(val))
            for k, val in batch.items()}


def reduce_gradients(model, model_split, data_group, model_group) -> None:
    """Each rank's share of the gradients summed into the whole: over the
    model axis for the ``model_split`` parameters (a rank that did not
    touch one holds zeros), then over the data axis, unless FSDP2 summed
    them there in its reduce-scatter (the gradients are DTensors then)."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    if model_group is not None and model_split:
        split = []
        for n, p in named:
            if n in model_split:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                split.append(local(p.grad))
        all_reduce_(split, model_group)
    plain = [p.grad for _, p in named if p.grad is not None and not hasattr(p.grad, "to_local")]
    all_reduce_(plain, data_group)


def make_gradnorm_step(update: Callable, train_step: Callable) -> Callable:
    """The GradNorm update on what the last train step consumed:
    ``gradnorm_step(state, batch, scalars, draws=None) -> (state,
    metrics)`` regenerates the collated tensors of ``train_step``'s last
    call on ``batch`` (``train_step.collated``: the same draws, from the
    generator states that step saved), runs ``update``
    (loss/gradnorm.py::make_gradnorm_update_fn) on them and writes the new
    task weights into ``state.gradnorm``. Under accumulation the collated
    microbatches are re-forwarded as one batch, as the TPU package's
    Trainer concatenates them."""

    def gradnorm_step(state: TrainState, batch: dict, scalars: ScheduleScalars,
                      draws: Draws | Sequence[Draws] | None = None):
        images, targets, meta = train_step.collated(state, batch, scalars, draws)
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
