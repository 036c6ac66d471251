"""Per-block rematerialisation (TRAIN.GRADIENT_CHECKPOINTING).

Port of ``resolve_remat_policy`` of linnaeus_tpu/models/utils.py, over
``torch.utils.checkpoint`` (non-reentrant). A policy name becomes the
checkpoint's ``context_fn``:

* 'full' (or None, '', 'nothing'): None, the plain checkpoint; nothing
  inside the block is kept, the whole block is recomputed in the backward.
* 'dots': every matrix product's output is kept (``aten.mm``, ``addmm``,
  ``bmm``, ``baddbmm``: the linear layers and the plain attention's
  einsums), through ``create_selective_checkpoint_contexts``; the
  elementwise work, the norms and the convolutions are recomputed. This is
  JAX's ``checkpoint_dots``, which saves ``dot_general`` outputs and no
  convolution.
* 'dots_no_batch': only the products without a batch dimension (``mm``,
  ``addmm``), JAX's ``dots_with_no_batch_dims_saveable``.

The policies see the aten operators, so the work inside K1's and K2's
kernels, launched through their C interface, is invisible to them: a
checkpointed block keeps neither kernel's output and launches its forward
kernel again in the backward, under every policy. The gradients are the
same with and without checkpointing.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

_aten = torch.ops.aten
DOT_OPS = {
    "dots": frozenset({_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                       _aten.baddbmm.default}),
    "dots_no_batch": frozenset({_aten.mm.default, _aten.addmm.default}),
}


def _save_products(ops: frozenset, ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in ops else CheckpointPolicy.PREFER_RECOMPUTE


def resolve_remat_policy(name: str | None) -> Callable | None:
    """TRAIN.GRADIENT_CHECKPOINTING.POLICY -> the checkpoint's ``context_fn``
    (None for 'full'); an unknown name raises a ValueError."""
    if name in (None, "", "full", "nothing"):
        return None
    if name not in DOT_OPS:
        raise ValueError(
            f"unknown remat policy {name!r}; expected one of 'full', 'dots', 'dots_no_batch'")
    policy = functools.partial(_save_products, DOT_OPS[name])
    return functools.partial(create_selective_checkpoint_contexts, policy)


def checkpoint_block(block: torch.nn.Module, *args, context_fn: Callable | None = None):
    """``block(*args)`` under a non-reentrant checkpoint with ``context_fn``.

    The recompute draws the block's random numbers again: its DropPath and
    Dropout masks and its MoE router noise come from explicit
    ``torch.Generator``s, which the checkpoint does not preserve (it stashes
    the global generators only).
    So the generators' states are taken before the first forward, set back
    for every recompute, and put back after it, and the recompute draws the
    masks of the first forward without moving the generators."""
    gens = list({id(m.generator): m.generator for m in block.modules()
                 if getattr(m, "generator", None) is not None and m.training
                 and max(getattr(m, "rate", 0.0), getattr(m, "noise_std", 0.0)) > 0.0
                 }.values())
    starts = [g.get_state() for g in gens]
    calls = []

    def run(*inputs):
        if not calls:
            calls.append(True)
            return block(*inputs)
        ends = [g.get_state() for g in gens]
        for g, s in zip(gens, starts):
            g.set_state(s)
        try:
            return block(*inputs)
        finally:
            for g, s in zip(gens, ends):
                g.set_state(s)

    kw = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(run, *args, use_reentrant=False, **kw)
