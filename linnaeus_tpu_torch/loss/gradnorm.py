"""GradNorm multitask loss balancing: the state and the weight update.

Port of linnaeus_tpu/loss/gradnorm.py. Per update, every
``UPDATE_INTERVAL`` optimizer steps:
    1. per-task unweighted losses L_i and per-task trunk-gradient L2 norms
       g_i = || d(w_i L_i) / d(trunk params) ||
    2. g_avg = mean_i(g_i); ratio_i = L_i / L_i(0), normalised to sum n
    3. target_i = g_avg * ratio_i ** alpha
    4. w_i <- w_i * g_i / target_i, renormalised so sum(w) = n

The TPU package takes each task's gradient with ``jax.grad`` of a
deterministic re-forward; the port runs the same re-forward per task (drop
path and dropout off, gradients on) and takes ``torch.autograd.grad`` over
the trunk parameters alone, in the order of the TPU package: task outer,
GRADNORM_ACCUM_STEPS sub-batches inner, their gradients averaged. The
re-forward flips the model's ``gradient_checkpointing`` flag to
TRAIN.GRADIENT_CHECKPOINTING.ENABLED_GRADNORM_STEPS for the call, on the
same module and weights.

More than one rank (``mesh``, parallel/): the collated rows are this
rank's; the re-forward's logits and the targets are gathered over the data
axis, so each loss is the global batch's, and each rank's share of a
task's trunk gradient is summed over the model axis (for the
``model_split`` parameters) and the data axis, and its norm is the whole
gradient's (parallel/model.py::grad_norm: the squares of a share's norm
summed over its axis). Under FSDP the trunk's parameters are shards: the task's
gradient is taken by ``backward`` (FSDP2 sums the shards' gradients over
the data axis).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch
from torch import nn

from linnaeus_tpu_torch.ops_schedule.ops_schedule import gradnorm_due
from linnaeus_tpu_torch.parallel.model import grad_norm
from linnaeus_tpu_torch.parallel.ops import all_reduce_, gather_rows


@dataclass
class GradNormState:
    task_weights: torch.Tensor  # [T]
    initial_losses: torch.Tensor  # [T]
    has_initted: torch.Tensor  # bool scalar
    last_metrics: dict[str, torch.Tensor] | None = None


def init_gradnorm_state(num_tasks: int, init_weights=None, device=None) -> GradNormState:
    if init_weights is not None:
        w = torch.as_tensor(init_weights, dtype=torch.float32, device=device)
    else:
        w = torch.ones(num_tasks, dtype=torch.float32, device=device)
    # normalise to sum = num_tasks
    w = w * (num_tasks / w.sum().clamp_min(1e-8))
    return GradNormState(
        task_weights=w,
        initial_losses=torch.zeros(num_tasks, dtype=torch.float32, device=device),
        has_initted=torch.zeros((), dtype=torch.bool, device=device),
    )


def gradnorm_weight_update(
    grad_norms: torch.Tensor,
    loss_values: torch.Tensor,
    state: GradNormState,
    alpha: float,
) -> tuple[GradNormState, dict[str, torch.Tensor]]:
    """Steps 2-4 above, given measured per-task norms and losses."""
    n = grad_norms.shape[0]
    initial = torch.where(state.has_initted, state.initial_losses, loss_values)
    g_avg = grad_norms.mean()
    if alpha > 0:
        ratio = loss_values / initial.clamp_min(1e-8)
        ratio = ratio * (n / ratio.sum().clamp_min(1e-8))
        target = g_avg * ratio**alpha
    else:
        target = g_avg * torch.ones_like(grad_norms)
    scale = torch.where(target > 1e-8, grad_norms / target.clamp_min(1e-8),
                        torch.ones_like(grad_norms))
    new_w = state.task_weights * scale
    new_w = new_w * (n / new_w.sum().clamp_min(1e-8))
    metrics = {
        "gradnorm/avg_norm": g_avg,
        "gradnorm/norms": grad_norms,
        "gradnorm/targets": target,
        "gradnorm/weights": new_w,
        "gradnorm/losses": loss_values,
    }
    return GradNormState(
        task_weights=new_w,
        initial_losses=initial,
        has_initted=torch.ones((), dtype=torch.bool, device=grad_norms.device),
    ), metrics


def make_gradnorm_update_fn(
    criteria: dict[str, Callable],
    task_keys: Sequence[str],
    trunk_names: Sequence[str],
    alpha: float,
    zero_aux_info: bool = True,
    use_linear_heads: bool = True,
    accum_steps: int = 1,
    remat: bool | None = None,
    mesh=None,
    model_split: Sequence[str] = (),
) -> Callable:
    """Build the GradNorm update.

    Args:
        trunk_names: the parameters whose gradient norms are measured (the
            shared trunk: ``utils/param_filters.py::trunk_mask_from_exclude``
            of LOSS.GRAD_WEIGHTING.TASK.EXCLUDE_CONFIG).
        zero_aux_info: re-forward with zeroed metadata (ZERO_AUX_INFO).
        use_linear_heads: the heads' base logits in the re-forward
            (USE_LINEAR_HEADS_FOR_GRADNORM_REFORWARD -> ``gradnorm_mode``).
        accum_steps: GRADNORM_ACCUM_STEPS sub-batches, gradients averaged.
        remat: the model's ``gradient_checkpointing`` during the re-forward
            (ENABLED_GRADNORM_STEPS); None leaves it as it is.

    Returns ``update(model, images, targets, meta, state) -> (new_state,
    metrics)``; the model's mode and flag are restored afterwards.
    """
    accum = max(int(accum_steps), 1)
    task_keys = tuple(task_keys)
    data_group = None if mesh is None else mesh.group("data")
    model_group = None if mesh is None else mesh.group("model")
    split_idx = [i for i, n in enumerate(trunk_names) if n in set(model_split)]

    def task_grads(loss, trunk):
        """This task's whole trunk gradient (parallel/: summed over ranks)."""
        if any(hasattr(p, "to_local") for p in trunk):  # FSDP2 shards
            for p in trunk:
                p.grad = None
            loss.backward()
            g = [torch.zeros_like(p.to_local()) if p.grad is None else p.grad.to_local()
                 for p in trunk]
            for p in trunk:
                p.grad = None
            return g
        g = torch.autograd.grad(loss, trunk, allow_unused=True)
        g = [torch.zeros_like(p) if gi is None else gi for gi, p in zip(g, trunk)]
        if mesh is not None:
            all_reduce_([g[i] for i in split_idx], model_group)
            all_reduce_(g, data_group)
        return g

    def update(model: nn.Module, images: torch.Tensor, targets: dict[str, torch.Tensor],
               meta: torch.Tensor | None, state: GradNormState):
        if hasattr(model, "reshard"):  # FSDP2: the shards are the parameters
            model.reshard()
        named = dict(model.named_parameters())
        trunk = [named[n] for n in trunk_names]
        meta_in = torch.zeros_like(meta) if zero_aux_info and meta is not None else meta
        weights = state.task_weights.detach()

        def split(x):
            return None if x is None else x.reshape((accum, x.shape[0] // accum) + x.shape[1:])

        micro_images, micro_meta = split(images), split(meta_in)
        was_training, was_remat = model.training, getattr(model, "gradient_checkpointing", None)
        model.eval()  # deterministic: drop path and dropout off
        if remat is not None:
            model.gradient_checkpointing = bool(remat)
        norms, losses = [], []
        try:
            with torch.enable_grad():
                for ti, task in enumerate(task_keys):
                    micro_targets = split(targets[task])
                    grads = None
                    total = torch.zeros((), dtype=torch.float32, device=images.device)
                    for i in range(accum):
                        outputs = model(micro_images[i],
                                        None if micro_meta is None else micro_meta[i],
                                        gradnorm_mode=use_linear_heads)
                        logits = gather_rows(outputs[task], data_group)
                        unweighted = criteria[task](
                            logits, gather_rows(micro_targets[i], data_group)).mean()
                        g = task_grads(weights[ti] * unweighted, trunk)
                        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
                        total = total + unweighted.detach().float()
                    if accum > 1:
                        grads = [gi / accum for gi in grads]
                    norms.append(grad_norm(list(zip(trunk, grads)), data_group))
                    losses.append(total / accum)
        finally:
            model.train(was_training)
            if remat is not None:
                model.gradient_checkpointing = was_remat
        return gradnorm_weight_update(torch.stack(norms), torch.stack(losses), state, alpha)

    return update


def should_update_gradnorm(gw_cfg, step: int) -> bool:
    """Whether GradNorm updates after optimizer step ``step`` (the count of
    steps taken) under LOSS.GRAD_WEIGHTING.TASK: the rule of the copied
    ``OpsSchedule.should_update_gradnorm`` (ops_schedule/ops_schedule.py)."""
    return gradnorm_due(gw_cfg, step)
