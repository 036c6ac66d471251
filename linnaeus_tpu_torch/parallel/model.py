"""Put a model on the mesh: the data axis and the model axis.

What the TPU package gets from XLA's partitioner out of shardings, the port
sets on the modules themselves. What a rank holds and computes is split:

* data axis: the BatchNorms reduce their statistics over the data group,
  the MoE layers their load-balance statistics, and every random draw of
  the forward (drop path, dropout, router noise, gumbel routing) is the
  global batch's, this rank keeping its rows (models/blocks/common.py);
* 'tp' (tensor parallelism): each RoPE attention holds and computes its
  rank's heads (q, k and v of a head together: the qkv columns are
  [q | k | v], so a contiguous split would cut across heads) with their
  RoPE frequencies, its output projection the matching input columns,
  summed over the axis; each RoPE MLP its rank's hidden columns; the Linear
  heads whose classes divide the axis their rank's classes, gathered back
  (models/blocks/common.py::Linear);
* 'ep' (expert parallelism): each MoE layer holds and runs its rank's
  experts behind an ``all_to_all_single`` (models/blocks/moe.py);
* SEQUENCE_PARALLEL: the RoPE attentions run as a ring over the model axis;
* PIPELINE.STAGES: the RoPE towers run GPipe-pipelined over it.

Under 'tp' and 'ep' a split parameter is replaced by this rank's share, a
plain Parameter tagged ``share`` (:class:`Share`: the axis, every rank's
entries, the whole shape): its gradient, its optimizer moments and its EMA
are this rank's share alone. :func:`whole_state_dict` gathers them into
the one-process layout (checkpoints), :func:`own_share` cuts a whole tensor
down again (resume), :func:`grad_norm` sums the squares of the shares'
norms over the axis (the clip, GradNorm). Under pipelining every rank keeps
the whole tower and a stage differentiates only its own layers: :func:`shard_model`
returns the names of those parameters, whose gradients the train step sums
over the model axis (train/step.py).
"""

from __future__ import annotations

import torch
from torch import nn

from typing import Any, NamedTuple

from .mesh import DATA_AXIS, MODEL_AXIS, PARAM_SHARDING_FNS, Mesh
from .ops import group_rank, group_size


def set_data_group(model: nn.Module, group) -> None:
    """The data group on every module that reduces or draws over the batch."""
    for module in model.modules():
        if hasattr(module, "data_group"):
            module.data_group = group


class Share(NamedTuple):
    """How a parameter is split over the model axis: along ``dim``, rank r
    holding the entries ``indices[r]`` of the whole ``shape``."""

    dim: int
    indices: tuple[torch.Tensor, ...]
    shape: tuple[int, ...]
    group: Any


def _split(module: nn.Module, name: str, dim: int, indices: list[torch.Tensor], group) -> None:
    """Replace ``module.name`` with this rank's share of it (a plain
    Parameter tagged with its :class:`Share`)."""
    whole = getattr(module, name)
    share = Share(dim, tuple(i.to(whole.device) for i in indices), tuple(whole.shape), group)
    local = nn.Parameter(whole.detach().index_select(dim, share.indices[group_rank(group)])
                         .clone())
    local.share = share
    setattr(module, name, local)


def _contiguous(n: int, P: int) -> list[torch.Tensor]:
    return [torch.arange(r * n // P, (r + 1) * n // P) for r in range(P)]


def _tp(model: nn.Module, group, plan) -> None:
    from linnaeus_tpu_torch.models.blocks.common import Linear, Mlp
    from linnaeus_tpu_torch.models.blocks.rope_mhsa import RoPE2DAttention

    P, r = group_size(group), group_rank(group)
    names = {id(m): n for n, m in model.named_modules()}
    for module in model.modules():
        if isinstance(module, RoPE2DAttention):
            H, D = module.num_heads, module.head_dim
            if H % P or plan.get(names[id(module)] + ".qkv.weight") is None:
                continue
            hl, C = H // P, H * D
            cols = _contiguous(C, P)  # rank r's heads' features
            qkv = [torch.cat([j * C + c for j in range(3)]) for c in cols]  # of q, k and v
            _split(module.qkv, "weight", 0, qkv, group)
            _split(module.qkv, "bias", 0, qkv, group)
            _split(module.proj, "weight", 1, cols, group)
            if module.freqs is not None:  # the RoPE frequencies of this rank's heads
                _split(module, "freqs", 1, _contiguous(H, P), group)
            module.qkv.tp, module.proj.tp = ("col", group), ("row", group)
            module.tp_heads = (r * hl, hl)
        elif isinstance(module, Mlp) and names[id(module)].startswith("stages."):
            hidden = module.fc1.out_features
            if plan.get(names[id(module)] + ".fc1.weight") is None or hidden % P:
                continue
            if module.drop1.rate > 0:
                raise ValueError("PARAM_SHARDING='tp' with DROP_RATE > 0: the MLP's hidden "
                                 "dropout masks would not be the one-process run's")
            cols = _contiguous(hidden, P)
            _split(module.fc1, "weight", 0, cols, group)
            _split(module.fc1, "bias", 0, cols, group)
            _split(module.fc2, "weight", 1, cols, group)
            module.fc1.tp, module.fc2.tp = ("col", group), ("row", group)
    head = getattr(model, "head", None)
    for task in (head.task_keys if head is not None else ()):
        fc = getattr(head[task], "fc", None)
        if isinstance(fc, Linear) and plan.get(f"head.{task}.fc.weight") is not None:
            rows = _contiguous(fc.out_features, P)
            _split(fc, "weight", 0, rows, group)
            if fc.bias is not None:
                _split(fc, "bias", 0, rows, group)
            fc.tp = ("col_gather", group)


def _ep(model: nn.Module, group) -> None:
    from linnaeus_tpu_torch.models.blocks.moe import MoEMlp

    for module in model.modules():
        if isinstance(module, MoEMlp):
            experts = _contiguous(module.num_experts, group_size(group))
            for leaf in ("wi", "bi", "wo", "bo"):
                _split(module, leaf, 0, experts, group)
            module.expert_group = group


def whole(t: torch.Tensor, share: Share) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's share (a collective
    over the share's group)."""
    P = group_size(share.group)
    pieces = t.new_empty((P,) + tuple(t.shape))
    torch.distributed.all_gather_into_tensor(pieces.view(-1), t.contiguous().view(-1),
                                             group=share.group)
    out = t.new_empty(share.shape)
    for r in range(P):
        out.index_copy_(share.dim, share.indices[r].to(t.device), pieces[r])
    return out


def own_share(t: torch.Tensor, share: Share) -> torch.Tensor:
    """This rank's share of the whole tensor ``t``."""
    return t.index_select(share.dim, share.indices[group_rank(share.group)].to(t.device))


def whole_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """The model's state_dict in the one-process layout, whatever it is
    split into: FSDP2's shards and the model axis's shares gathered (every
    rank takes part)."""
    out = {}
    for key, value in model.state_dict(keep_vars=True).items():
        if hasattr(value, "full_tensor"):
            value = value.full_tensor()
        elif getattr(value, "share", None) is not None:
            value = whole(value.detach(), value.share)
        out[key] = value.detach()
    return out


def grad_norm(pairs, data_group) -> torch.Tensor:
    """The L2 norm of the whole gradient, given (parameter, gradient) pairs.
    Each gradient's norm is taken where it lives (FSDP2's shard, the model
    axis's share or the whole tensor) in one fused ``_foreach_norm``; the
    squares of the shards' norms are summed over the data axis, those of
    the shares over the model axis, the rest taken once. Where neither axis
    has more than one rank this is torch's ``get_total_norm`` of the local
    tensors, so a model under FSDP2 on one rank gives the one-process bits."""
    pairs = [(p, g) for p, g in pairs if g is not None]
    local = [g.to_local() if hasattr(g, "to_local") else g for _, g in pairs]
    axes = [data_group if hasattr(p, "to_local")
            else getattr(getattr(p, "share", None), "group", None) for p, _ in pairs]
    axes = [a if group_size(a) > 1 else None for a in axes]
    if all(a is None for a in axes):
        return torch.nn.utils.get_total_norm(local, norm_type=2.0)
    norms = torch._foreach_norm(local)
    total = None
    for group in {id(a): a for a in axes}.values():
        part = torch.stack([n.float() for n, a in zip(norms, axes) if a is group]).square().sum()
        if group is not None:
            torch.distributed.all_reduce(part, group=group)
        total = part if total is None else total + part
    return total.sqrt()


def shard_model(model: nn.Module, mesh: Mesh, mode: str = "replicated",
                sequence_parallel: bool = False, pipeline_stages: int = 1,
                microbatches: int = 0) -> list[str]:
    """Set ``model`` up for ``mesh`` under PARAM_SHARDING ``mode``, the ring
    and the pipeline; returns the parameters whose gradients are summed over
    the model axis (the pipelined towers'). The plan is checked as the TPU package checks it (its
    ``ValueError``s); FSDP itself is applied to the whole train state
    (train/build.py::shard_train_state)."""
    set_data_group(model, mesh.group(DATA_AXIS))
    group = mesh.group(MODEL_AXIS)
    split: list[str] = []
    if mode in ("tp", "ep"):
        plan = PARAM_SHARDING_FNS[mode](mesh, model)
        if mode == "tp":
            _tp(model, group, plan)
        if any(n.endswith(".wi") and p is not None for n, p in plan.items()):
            # the expert banks shard by expert under 'ep', and under 'tp' too
            _ep(model, group)
    if sequence_parallel:
        for module in model.modules():
            if hasattr(module, "ring_group"):
                module.ring_attention = True
                module.ring_group = group
    if pipeline_stages > 1:
        model.set_pipeline(pipeline_stages, microbatches)
        model.model_mesh = mesh
        depths = [len(s) for s in model.stages[2:]]
        for s, depth in zip((2, 3), depths):
            if depth % pipeline_stages == 0:
                split += [n for n, _ in model.stages[s].named_parameters(prefix=f"stages.{s}")]
    return split


def check_parallel(config, mesh: Mesh, model: nn.Module) -> None:
    """The TPU package Trainer's checks of PARALLEL against the mesh and the
    model (linnaeus_tpu/train/loop.py), with its ``ValueError``s."""
    par = config.PARALLEL
    mode = str(par.get("PARAM_SHARDING", "replicated"))
    if bool(par.get("SEQUENCE_PARALLEL", False)):
        if mesh.model < 2:
            raise ValueError("PARALLEL.SEQUENCE_PARALLEL requires PARALLEL.MESH.MODEL > 1 "
                             "(the token dim shards over the model axis)")
        if mode == "tp":
            raise ValueError(
                "PARALLEL.SEQUENCE_PARALLEL and PARAM_SHARDING='tp' both shard the model axis "
                "incompatibly (head-sharded qkv activations would be resharded token-wise and "
                "back at every layer — a full all-to-all each direction); pick one, or use "
                "fsdp+sp")
        if not hasattr(model, "set_pipeline"):
            raise ValueError(f"PARALLEL.SEQUENCE_PARALLEL: {config.MODEL.TYPE} has no "
                             "ring-attention path (mFormerV1 only)")
    stages = int(par.get("PIPELINE", {}).get("STAGES", 1) or 1)
    if stages > 1:
        if mesh.model != stages:
            raise ValueError(
                f"PARALLEL.PIPELINE.STAGES={stages} requires PARALLEL.MESH.MODEL={stages} "
                f"(the stage count IS the model-axis size; mesh has {mesh.model})")
        if mode in ("tp", "ep"):
            raise ValueError(
                f"PARALLEL.PIPELINE and PARAM_SHARDING='{mode}' both claim the model axis; "
                "use 'replicated' or 'fsdp' with pipelining")
        if bool(par.get("SEQUENCE_PARALLEL", False)):
            raise ValueError("PARALLEL.PIPELINE and PARALLEL.SEQUENCE_PARALLEL both claim the "
                             "model axis; pick one")
        if not hasattr(model, "set_pipeline"):
            raise ValueError(f"PARALLEL.PIPELINE: {config.MODEL.TYPE} has no pipelined tower "
                             "path (mFormerV1 only)")
    if mode in ("tp", "ep") and mesh.model == 1:
        raise ValueError(
            f"PARAM_SHARDING='{mode}' with PARALLEL.MESH.MODEL=1: the model axis has one "
            "device, so nothing would shard — set PARALLEL.MESH.MODEL > 1")
    if mode not in ("replicated", "fsdp", "tp", "ep"):
        raise ValueError(f"PARALLEL.PARAM_SHARDING {mode!r} is not one of replicated, fsdp, "
                         "tp, ep")


def fsdp_units(model: nn.Module) -> list[nn.Module]:
    """The modules FSDP2 wraps, innermost first: each block of
    ``model.stages`` (mFormerV1's ConvNeXt and RoPE blocks), then the root,
    which holds the rest (stem, downsampling, heads). Under pipelining the
    towers read their blocks' parameters through ``torch.func.functional_call``
    (models/mformer_v1.py::_pipelined), which must see whole tensors: the
    root alone, as for a model without ``stages``."""
    if getattr(model, "pipeline_stages", 0) > 1:
        return [model]
    return [blk for stage in getattr(model, "stages", ()) for blk in stage] + [model]


def apply_fsdp(model: nn.Module, mesh: Mesh) -> None:
    """FSDP2 ``fully_shard`` of ``model`` over the data axis, a unit a block
    (:func:`fsdp_units`): a rank gathers one block's parameters at a time
    for its forward and its backward and reduce-scatters that block's
    gradients, not the whole model's at once. Each parameter is sharded
    along the torch axis of the Flax axis the TPU package's plan picks (its
    largest divisible one); a parameter the plan replicates is sharded along
    axis 0 (FSDP2 pads an uneven shard; the numbers are the same). Gradients
    are summed over the axis, not averaged: the step's loss is the global
    batch's on every rank. No MixedPrecisionPolicy: the layers' own
    bfloat16 casts of the float32 parameters stay as they are. Without a
    process group (one process) nothing is sharded."""
    if mesh.device_mesh is None:
        return
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from .mesh import fsdp_param_sharding

    plan = fsdp_param_sharding(mesh, model)
    dims = {id(p): plan[n].torch_axis for n, p in model.named_parameters()
            if plan[n] is not None}
    for unit in fsdp_units(model):
        fully_shard(unit, mesh=mesh.device_mesh[DATA_AXIS],
                    shard_placement_fn=lambda p: Shard(dims.get(id(p), 0)))
        setter = getattr(unit, "set_gradient_divide_factor", None) or getattr(
            unit, "set_reduce_scatter_divide_factor")
        setter(1.0)
        if hasattr(unit, "set_force_sum_reduction_for_comms"):
            # a plain SUM (gloo has no pre-multiplied sum; NCCL takes either)
            unit.set_force_sum_reduction_for_comms(True)
