"""GPipe pipeline parallelism over the 'model' mesh axis.

Port of linnaeus_tpu/parallel/pipeline.py. A tower of L uniform blocks has
its per-block parameters stacked on a leading layer axis
(:func:`stack_layer_params`); stage s of the S-rank group runs layers
[s L / S, (s + 1) L / S); the batch is split into M microbatches that flow
through the stages fill-drain, stage s taking microbatch m from stage s - 1
and handing it to stage s + 1 (blocking ``send`` / ``recv``: the chain has
no cycle, so the schedule cannot deadlock). The last stage's outputs are
broadcast to every stage, as the TPU package delivers them replicated over
the axis (its psum of a one-hot contribution).

Autograd: the pipeline is one ``torch.autograd.Function`` that every rank
of the group enters at the same point of its forward and of its backward.
Its backward walks the microbatches the other way: the last stage takes
the microbatch's slice of the (replicated) output gradient, every other
stage receives its output's gradient from the next stage, re-runs its
layers on the input it kept (the blocks are deterministic: the TPU package
raises for dropout and drop path under pipelining, and so does the model
here) and differentiates them, and sends the input's gradient back; stage 0
broadcasts the input's gradient to the group, as the TPU package's
transpose of a replicated input sums it over the axis. So the forward and
the gradients equal the sequential stack per microbatch, and the
recompute is the TPU package's remat.

Each rank holds the whole stacked tower (the model's layout and the
checkpoint's stay as they are); a stage differentiates only its own layers,
so the other layers' gradients are zeros there and the Trainer sums the
tower's gradients over the axis. Without a group (one process) the
microbatches run through every layer in turn.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, MODEL_AXIS
from .ops import group_rank, group_size


def stack_layer_params(layer_params: list[dict[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """Per-layer parameter dicts (the same names) stacked on a leading layer
    axis: the layout :func:`pipeline_forward` takes (differentiable)."""
    return {k: torch.stack([p[k] for p in layer_params]) for k in layer_params[0]}


def unstack_layer_params(stacked: dict[str, torch.Tensor]) -> list[dict[str, torch.Tensor]]:
    """Inverse of :func:`stack_layer_params`."""
    n = next(iter(stacked.values())).shape[0]
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


def _stage_apply(block_fn, names, local, h):
    for i in range(local[0].shape[0]):
        h = block_fn({n: t[i] for n, t in zip(names, local)}, h)
    return h


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, block_fn, group, M, names, *stacked):
        S, s = group_size(group), group_rank(group)
        per = stacked[0].shape[0] // S
        local = [t.detach()[s * per:(s + 1) * per] for t in stacked]
        peer = (lambda i: dist.get_global_rank(group, i)) if group is not None else None
        xs = x.detach().reshape((M, x.shape[0] // M) + tuple(x.shape[1:]))
        inputs, outs = [], []
        for m in range(M):
            if s == 0:
                h = xs[m]
            else:
                h = torch.empty_like(xs[m])
                dist.recv(h, src=peer(s - 1), group=group)
            inputs.append(h)
            with torch.no_grad():
                h = _stage_apply(block_fn, names, local, h)
            if s < S - 1:
                dist.send(h.contiguous(), dst=peer(s + 1), group=group)
            else:
                outs.append(h)
        out = torch.stack(outs) if s == S - 1 else torch.empty_like(xs)
        if S > 1:
            dist.broadcast(out, src=peer(S - 1), group=group)
        ctx.block_fn, ctx.group, ctx.names = block_fn, group, names
        ctx.inputs, ctx.per = inputs, per
        ctx.save_for_backward(*stacked)
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        stacked = ctx.saved_tensors
        group, per = ctx.group, ctx.per
        S, s = group_size(group), group_rank(group)
        M = len(ctx.inputs)
        peer = (lambda i: dist.get_global_rank(group, i)) if group is not None else None
        gs = g.reshape((M, g.shape[0] // M) + tuple(g.shape[1:]))
        local = [t.detach()[s * per:(s + 1) * per].requires_grad_() for t in stacked]
        grads = [torch.zeros_like(t) for t in local]
        dx = torch.empty_like(gs)
        for m in reversed(range(M)):
            if s == S - 1:
                g_out = gs[m]
            else:
                g_out = torch.empty_like(gs[m])
                dist.recv(g_out, src=peer(s + 1), group=group)
            h = ctx.inputs[m].detach().requires_grad_()
            with torch.enable_grad():
                out = _stage_apply(ctx.block_fn, ctx.names, local, h)
            d = torch.autograd.grad(out, [h] + local, g_out, allow_unused=True)
            for acc, gi in zip(grads, d[1:]):
                if gi is not None:
                    acc.add_(gi)
            if s > 0:
                dist.send(d[0].contiguous(), dst=peer(s - 1), group=group)
            else:
                dx[m] = d[0]
        if S > 1:
            dist.broadcast(dx, src=peer(0), group=group)
        full = []
        for t, gl in zip(stacked, grads):
            gt = torch.zeros_like(t)
            gt[s * per:(s + 1) * per] = gl
            full.append(gt)
        return (dx.reshape(g.shape), None, None, None, None, *full)


def pipeline_forward(
    block_fn: Callable,
    stacked_params: dict[str, torch.Tensor],
    x: torch.Tensor,
    mesh=None,
    *,
    num_microbatches: int,
    axis_name: str = MODEL_AXIS,
    batch_axis: str | None = None,
) -> torch.Tensor:
    """Run ``x`` through L stacked uniform layers, pipelined over the
    ``axis_name`` axis of ``mesh`` (None: one process, every layer here).

    block_fn        : ``(params_one_layer: dict, h) -> h``, one block.
    stacked_params  : name -> (L, ...) tensors, L divisible by the stages.
    x               : (B, ...), B divisible by ``num_microbatches``.
    num_microbatches: M >= S keeps the bubble at (S - 1) / (M + S - 1).
    batch_axis      : the mesh axis the batch is split over (this rank's
                      rows are what it is given), checked as the TPU
                      package checks it.
    Returns the tower's output with ``x``'s shape, the same on every stage.
    """
    group = None if mesh is None else mesh.group(axis_name)
    S = 1 if mesh is None else mesh.size(axis_name)
    L = next(iter(stacked_params.values())).shape[0]
    if L % S:
        raise ValueError(f"pipeline: {L} layers not divisible by {S} stages")
    M = int(num_microbatches)
    B = x.shape[0]
    if B % M:
        raise ValueError(f"pipeline: batch {B} not divisible by M={M}")
    if M < S:
        raise ValueError(
            f"pipeline: need microbatches >= stages ({M} < {S}) — smaller M "
            "leaves devices idle every tick")
    if batch_axis is not None and (
            mesh is None or batch_axis not in mesh.shape or batch_axis == axis_name):
        raise ValueError(
            f"pipeline: batch_axis {batch_axis!r} is not a usable mesh axis "
            f"(mesh has {None if mesh is None else tuple(mesh.shape)}, pipe axis is "
            f"{axis_name!r})")
    names = tuple(stacked_params)
    return _Pipeline.apply(x, block_fn, group, M, names,
                           *(stacked_params[n] for n in names))


__all__ = ["DATA_AXIS", "MODEL_AXIS", "pipeline_forward", "stack_layer_params",
           "unstack_layer_params"]
