"""Collective helpers: the rank surface and the collectives the port calls.

Port of linnaeus_tpu/parallel/ops.py. The TPU package runs one process per
host and lets XLA insert the collectives from shardings; the port runs one
process per card (``python -m torch.distributed.run``) and calls them
itself, through ``torch.distributed``. Every helper is the identity (or the
one-element answer) when no process group is initialised, as the TPU
package's are on one host.

Autograd. The train step computes its loss on every rank from the same
global tensors (train/step.py's rule), so the gradient a rank holds for
such a replicated tensor is the whole gradient; the gradient it holds for a
tensor that only its own rows or heads produced is its share. The
differentiable collectives below follow from that:

  ``gather_rows``   rows of every rank, concatenated; backward keeps this
                    rank's rows of the (replicated) gradient
  ``split_rows``    this rank's chunk of a replicated tensor; backward
                    gathers the chunks' gradients
  ``sum_forward``   sum over the group of shares (Megatron's g); backward
                    passes the replicated gradient through
  ``sum_backward``  identity (Megatron's f); backward sums the shares of
                    the gradient
  ``all_reduce_sum`` sum over the group whose consumers are per-rank (a
                    BatchNorm's statistics); backward sums too
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

Group = Any  # a torch.distributed ProcessGroup, or None for "this process alone"


def get_rank_safely() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_distributed() -> bool:
    return get_world_size() > 1


def master_only(fn):
    """Decorator: run only on rank 0; the others return None."""

    def wrapper(*args, **kwargs):
        if get_rank_safely() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapper


def group_size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _group_of(mesh, axis_name: str) -> Group:
    return None if mesh is None else mesh.group(axis_name)


def reduce_tensor_mean(x: torch.Tensor, mesh=None, axis_name: str = "data") -> torch.Tensor:
    """Mean of ``x`` over the ranks of the mesh axis (a new tensor)."""
    group = _group_of(mesh, axis_name)
    if group_size(group) == 1:
        return x.clone()
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out / group_size(group)


def all_gather_tensor(x: torch.Tensor, mesh=None, axis_name: str = "data") -> torch.Tensor:
    """``x`` of every rank of the mesh axis stacked on a new leading axis,
    in rank order (``jax.lax.all_gather``)."""
    group = _group_of(mesh, axis_name)
    n = group_size(group)
    if n == 1:
        return x[None].clone()
    out = x.new_empty((n * x.numel(),))
    dist.all_gather_into_tensor(out, x.contiguous().view(-1), group=group)
    return out.view((n,) + tuple(x.shape))


def broadcast_host_value(value: Any, root: int = 0) -> Any:
    """Agree on a host value (a scalar or a small array) across processes:
    ``root``'s value everywhere."""
    if get_world_size() == 1:
        return value
    box = [value if get_rank_safely() == root else None]
    dist.broadcast_object_list(box, src=root)
    out = box[0]
    if np.isscalar(value):
        return type(value)(out)
    return np.asarray(out)


def all_gather_object(obj: Any) -> list[Any]:
    """Small JSON-serialisable objects of every process, in rank order."""
    if get_world_size() == 1:
        return [obj]
    out: list[Any] = [None] * get_world_size()
    dist.all_gather_object(out, json.loads(json.dumps(obj)))
    return out


def synchronize() -> None:
    """Barrier across processes."""
    if get_world_size() > 1:
        dist.barrier()


class DistributedContext:
    """Convenience bundle: rank, world size and whether this is rank 0."""

    def __init__(self):
        self.rank = get_rank_safely()
        self.world_size = get_world_size()
        self.is_main = self.rank == 0

    def __repr__(self) -> str:
        return f"DistributedContext(rank={self.rank}, world={self.world_size})"


def draw_rows(draw, shape, device, generator, group=None, dim: int = 0) -> torch.Tensor:
    """``draw(shape, generator=..., device=...)`` (``torch.rand`` /
    ``torch.randn``) for this rank's rows along ``dim``. With a data group
    (the global batch split over ranks) every rank draws the global batch's
    tensor from the same generator state and keeps its own rows, so the
    draws are those of the one-process run: the draw is the global batch's,
    the work on what is drawn is this rank's rows'."""
    if group_size(group) == 1:
        return draw(shape, generator=generator, device=device)
    n, r = group_size(group), group_rank(group)
    full = list(shape)
    full[dim] *= n
    return draw(full, generator=generator, device=device).narrow(dim, r * shape[dim],
                                                                 shape[dim])


def fetch_rows(x: torch.Tensor, need: list, group: Group) -> torch.Tensor:
    """Rows of the global batch by index. ``x`` is this rank's rows (rank q
    holds the global rows [q n, (q + 1) n)); ``need[q]`` the global rows
    rank q asks for, the same lists on every rank. Returns the rows
    ``need[this rank]`` in that order. Only rows that live on another rank
    move, in one ``all_to_all_single``; when no rank needs another's rows no
    collective runs at all."""
    P, me, n = group_size(group), group_rank(group), x.shape[0]
    need = [np.asarray(q, dtype=np.int64) for q in need]
    mine, owner = need[me], need[me] // n
    local = np.nonzero(owner == me)[0]
    out = x.new_empty((len(mine),) + tuple(x.shape[1:]))
    out[torch.from_numpy(local).to(x.device)] = x[torch.from_numpy(mine[local] - me * n)
                                                  .to(x.device)]
    if all(bool((q // n == r).all()) for r, q in enumerate(need)):
        return out
    sends = [q[q // n == me] - me * n if r != me else q[:0] for r, q in enumerate(need)]
    froms = [np.nonzero(owner == r)[0] if r != me else local[:0] for r in range(P)]
    send = x[torch.from_numpy(np.concatenate(sends)).to(x.device)].contiguous()
    recv = x.new_empty((sum(len(f) for f in froms),) + tuple(x.shape[1:]))
    dist.all_to_all_single(recv, send, [len(f) for f in froms], [len(q) for q in sends],
                           group=group)
    out[torch.from_numpy(np.concatenate(froms)).to(x.device)] = recv
    return out


# ------------------------------------------------------------------ autograd
def _gather(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    n = group_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _chunk(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    n, r = group_size(group), group_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"split_rows: size {x.shape[dim]} of dim {dim} not divisible by {n}")
    return x.narrow(dim, r * (x.shape[dim] // n), x.shape[dim] // n).contiguous()


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.group, ctx.dim), None, None


class _SplitRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _chunk(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def gather_rows(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order; the
    gradient of this rank's part is its slice of the replicated gradient."""
    return x if group_size(group) == 1 else _GatherRows.apply(x, group, dim)


def split_rows(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous chunk of a replicated ``x`` along ``dim``."""
    return x if group_size(group) == 1 else _SplitRows.apply(x, group, dim)


def sum_forward(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group_size(group) == 1 else _SumForward.apply(x, group)


def sum_backward(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group_size(group) == 1 else _SumBackward.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group_size(group) == 1 else _AllReduceSum.apply(x, group)


def all_reduce_(tensors: list[torch.Tensor], group: Group) -> None:
    """Sum ``tensors`` over the group in place, through one flat buffer per
    dtype (a fixed order: the same bits on every rank)."""
    if group_size(group) == 1 or not tensors:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
