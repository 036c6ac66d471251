"""The (data, model) mesh of the ranks, the parameter plans and the feed.

Port of linnaeus_tpu/parallel/mesh.py. Where the TPU package runs one
process per host over a ``jax.sharding.Mesh`` and lets XLA partition the
program, the port runs one process per card (``python -m
torch.distributed.run``) over a ``torch.distributed.device_mesh.DeviceMesh``
named ``("data", "model")``, ranks laid out row-major (rank = d * MODEL + m,
as the TPU package reshapes its devices), and calls the collectives itself.

* :func:`initialize_multi_host` starts the process group from
  ``torch.distributed.run``'s environment (``nccl`` for CUDA, ``gloo`` only
  for a CPU run), once, whenever ``WORLD_SIZE`` > 1 or PARALLEL.MULTI_HOST
  is set; a group that already exists is used as it is.
* :func:`create_mesh` builds the mesh (DATA = -1 takes what MODEL leaves)
  and raises the TPU package's ``ValueError`` for a mesh that does not cover
  the world.
* The feed: DATA.BATCH_SIZE is a host's batch, as in the TPU package
  (``local_batch_slice``); the sampler runs with the number of hosts as its
  process count, and each rank of a host takes the contiguous rows of its
  data coordinate (:func:`rank_rows`, :func:`shard_batch`), so ranks along
  the model axis take the same rows, as ``make_array_from_process_local_data``
  places them.
* The plans (:data:`PARAM_SHARDING_FNS`): which leaf shards along which
  axis, by the TPU package's rules on the parameter's Flax path and Flax
  shape (utils/convert.py's map), with its errors ("matched ZERO
  parameters", MODEL = 1). A plan maps each torch parameter name to a
  :class:`Placement` (the Flax path, the Flax axis and the torch axis it
  shards, the mesh axis), or None for a replicated leaf.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch import nn

from linnaeus_tpu_torch.utils.logging import get_main_logger

from .ops import get_rank_safely, get_world_size

logger = get_main_logger()

DATA_AXIS = "data"
MODEL_AXIS = "model"


def initialize_multi_host(config=None, device: torch.device | str | None = None,
                          backend: str | None = None) -> bool:
    """Start the process group from ``torch.distributed.run``'s environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``) when ``WORLD_SIZE`` > 1 or PARALLEL.MULTI_HOST is set;
    ``nccl`` on CUDA (the rank's card is ``LOCAL_RANK``, modulo the visible
    cards), ``gloo`` on the CPU, or the ``backend`` the caller names (gloo
    with CUDA tensors: several ranks on one card, where NCCL refuses them).
    Idempotent: a process group that exists is kept. Returns whether a
    process group is up."""
    if dist.is_initialized():
        return True
    multi = bool(config is not None and config.PARALLEL.get("MULTI_HOST", False))
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 and not multi:
        return False
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_multi_host: nccl needs a card and none is visible "
                               "(pass --device cpu for gloo)")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend=backend)
    logger.info(f"Initialized {backend}: rank {dist.get_rank()} / {dist.get_world_size()}")
    return True


class Mesh:
    """The (data, model) mesh. ``device_mesh`` is torch's DeviceMesh, None
    for one process without a process group; an axis of size 1 has no group
    (its collectives are the identity)."""

    def __init__(self, data: int, model: int, device_mesh=None):
        self.data, self.model = int(data), int(model)
        self.device_mesh = device_mesh

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def group(self, axis: str):
        if self.device_mesh is None or self.size(axis) == 1:
            return None
        return self.device_mesh.get_group(axis)

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        if self.device_mesh is None:
            return 0
        return int(self.device_mesh.get_local_rank(axis))

    def __repr__(self) -> str:
        return f"Mesh(data={self.data}, model={self.model})"


def create_mesh(config=None, world_size: int | None = None,
                device_type: str | None = None) -> Mesh:
    """The (data, model) mesh over ``world_size`` ranks (the process
    group's, else 1). PARALLEL.MESH.DATA = -1 takes every rank MODEL leaves."""
    n = int(world_size) if world_size is not None else get_world_size()
    model = 1
    if config is not None:
        model = int(config.PARALLEL.MESH.get("MODEL", 1))
        data = int(config.PARALLEL.MESH.get("DATA", -1))
        if data == -1:
            data = n // model
    else:
        data = n
    if data * model != n:
        raise ValueError(
            f"Mesh {data}x{model} does not cover {n} devices; adjust PARALLEL.MESH")
    device_mesh = None
    if dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        if device_type is None:
            device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        device_mesh = init_device_mesh(device_type, (data, model),
                                       mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    mesh = Mesh(data, model, device_mesh)
    logger.info(f"Created mesh {mesh.shape}")
    return mesh


# ------------------------------------------------------------------ the feed
def host_layout() -> tuple[int, int, int]:
    """(host index, host count, ranks per host) from
    ``torch.distributed.run``'s ``LOCAL_WORLD_SIZE`` (one host when unset)."""
    world = get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world)) or world
    if world % per_host:
        raise ValueError(f"LOCAL_WORLD_SIZE {per_host} does not divide WORLD_SIZE {world}")
    return get_rank_safely() // per_host, world // per_host, per_host


def get_process_index() -> int:
    """The host's index: the TPU package's process."""
    return host_layout()[0]


def get_process_count() -> int:
    """The number of hosts: the TPU package's process count."""
    return host_layout()[1]


def is_main_process() -> bool:
    return get_rank_safely() == 0


def local_batch_slice(global_batch_size: int) -> tuple[int, int]:
    """This host's [start, end) slice of the global batch."""
    per_host = global_batch_size // get_process_count()
    start = get_process_index() * per_host
    return start, start + per_host


def rank_rows(host_batch_size: int, mesh: Mesh | None) -> tuple[int, int]:
    """This rank's [start, end) rows of its host's batch: the contiguous
    share of its data coordinate among the host's data coordinates."""
    if mesh is None or mesh.data == 1:
        return 0, host_batch_size
    _, hosts, per_host = host_layout()
    slots = mesh.data // hosts  # data coordinates on one host
    if per_host % mesh.model or slots * hosts != mesh.data:
        raise ValueError(f"mesh {mesh.shape} does not lay out over {hosts} hosts of "
                         f"{per_host} ranks")
    if host_batch_size % slots:
        raise ValueError(f"batch {host_batch_size} does not split over {slots} data ranks "
                         "of a host")
    share = host_batch_size // slots
    d = mesh.coord(DATA_AXIS) % slots
    return d * share, (d + 1) * share


def shard_batch(batch: Any, mesh: Mesh | None) -> Any:
    """This rank's rows of a host batch (a tensor, or dicts / lists of them;
    None stays None)."""
    if mesh is None or mesh.data == 1:
        return batch

    def rows_of(x):
        if isinstance(x, torch.Tensor):
            return x.shape[0]
        items = x.values() if isinstance(x, dict) else x if isinstance(x, (list, tuple)) else ()
        return next((n for n in map(rows_of, items) if n is not None), None)

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(take(v) for v in x)
        return None if x is None else x[lo:hi]

    lo, hi = rank_rows(int(rows_of(batch)), mesh)
    return take(batch)


def replicate(tree: Any, mesh: Mesh | None) -> Any:
    """Data rank 0's values of every tensor in ``tree`` (a module, a dict,
    a list or a tensor), broadcast in place over the whole mesh, so that a
    replicated state is the same bits on every rank."""
    if mesh is None or mesh.device_mesh is None or get_world_size() == 1:
        return tree
    if isinstance(tree, nn.Module):
        tensors = [t.data for t in tree.parameters()] + list(tree.buffers())
    elif isinstance(tree, dict):
        tensors = [t for t in tree.values() if isinstance(t, torch.Tensor)]
    elif isinstance(tree, torch.Tensor):
        tensors = [tree]
    else:
        tensors = [t for t in tree if isinstance(t, torch.Tensor)]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0)
    return tree


def reshard_train_state(state, mesh: Mesh, make_optimizer, mode: str = "replicated"):
    """Re-place a TrainState onto ``mesh``: the parameters replicated (data
    rank 0's values) or, under 'fsdp', sharded by FSDP2; the optimizer made
    anew on the new placement by ``make_optimizer(model)`` (its state
    re-initialised, as the TPU package's); the EMA placed as the
    parameters are; the step, the generator and the GradNorm state kept."""
    from .model import apply_fsdp

    replicate(state.model, mesh)
    if mode == "fsdp":
        apply_fsdp(state.model, mesh)
    if state.ema_params is not None:
        from linnaeus_tpu_torch.utils.checkpoint import _like

        named = dict(state.model.named_parameters())
        state.ema_params = {n: _like(v.detach().clone(), named[n]).detach()
                            for n, v in state.ema_params.items()}
    state.optimizer = make_optimizer(state.model)
    return state


# ----------------------------------------------------------------- the plans
class Placement(NamedTuple):
    """One sharded leaf: its Flax path, the Flax axis and the torch axis it
    shards, and the mesh axis they shard over."""

    path: str
    flax_axis: int
    torch_axis: int
    mesh_axis: str


# MoE expert-bank leaf names (blocks/moe.py): leading axis = expert index
_EP_LEAVES = ("wi", "wo", "bi", "bo")


def _flax_view(model: nn.Module) -> dict[str, tuple[str, tuple[int, ...], list[int]]]:
    """name -> (Flax path, Flax shape, torch axis of each Flax axis)."""
    from linnaeus_tpu_torch.utils.convert import jax_layouts

    layouts = jax_layouts(model)
    out = {}
    for name, p in model.named_parameters():
        lay = layouts[name]
        probe = torch.empty(tuple(p.shape), device="meta")
        view = lay.to_jax(probe)
        axes = []
        for j in range(view.dim()):
            axes.append(next(i for i in range(probe.dim())
                             if probe.stride(i) == view.stride(j)
                             and probe.shape[i] == view.shape[j]))
        out[name] = (lay.path, tuple(view.shape), axes)
    return out


def _placement(path, axes, flax_axis, mesh_axis) -> Placement:
    return Placement(path, flax_axis, axes[flax_axis], mesh_axis)


def fsdp_param_sharding(mesh: Mesh, model: nn.Module) -> dict[str, Placement | None]:
    """Each parameter's largest Flax axis over 'data' when the data axis
    divides it (PARALLEL.PARAM_SHARDING='fsdp'); None (replicated) else."""
    n_data = mesh.data
    plan = {}
    for name, (path, shape, axes) in _flax_view(model).items():
        plan[name] = None
        if shape:
            best = max(range(len(shape)), key=lambda i: (shape[i], -i))
            if shape[best] % n_data == 0 and shape[best] >= n_data:
                plan[name] = _placement(path, axes, best, DATA_AXIS)
    return plan


def tp_param_sharding(mesh: Mesh, model: nn.Module) -> dict[str, Placement | None]:
    """Megatron-style tensor-parallel plan over the 'model' axis
    (PARALLEL.PARAM_SHARDING='tp'): attn/qkv and mlp/Dense_0 kernels
    column-parallel with their biases, attn/proj and mlp/Dense_1 kernels
    row-parallel, MoE expert banks by expert, the heads' classifiers
    column-parallel; the rest replicated. Raises for a model axis of 1 and
    when no parameter matched."""
    n_model = mesh.model
    if n_model <= 1:
        raise ValueError(
            "PARAM_SHARDING='tp' requires PARALLEL.MESH.MODEL > 1 "
            f"(mesh model axis has {n_model} device)")
    plan, n_sharded = {}, 0
    view = _flax_view(model)
    for name, (path, shape, axes) in view.items():
        axis = None
        if path.endswith("attn/qkv/kernel") or path.endswith("mlp/Dense_0/kernel"):
            axis = 1 if shape[1] % n_model == 0 else None
        elif path.endswith("attn/proj/kernel") or path.endswith("mlp/Dense_1/kernel"):
            axis = 0 if shape[0] % n_model == 0 else None
        elif path.endswith("attn/qkv/bias") or path.endswith("mlp/Dense_0/bias"):
            axis = 0 if shape[0] % n_model == 0 else None
        elif (path.rsplit("/", 1)[-1] in _EP_LEAVES and "/mlp/" in f"/{path}"
              and len(shape) >= 1 and shape[0] % n_model == 0):
            axis = 0
        elif (path.startswith("head/") and path.endswith("/kernel") and len(shape) == 2
              and shape[1] % n_model == 0):
            axis = 1
        plan[name] = None if axis is None else _placement(path, axes, axis, MODEL_AXIS)
        n_sharded += axis is not None
    if n_sharded == 0:
        raise ValueError(
            "tensor-parallel sharding matched ZERO parameters — a module "
            "rename has de-sharded the model (expected attn/qkv, attn/proj, "
            "mlp/Dense_0, mlp/Dense_1, head/*/kernel paths)")
    logger.info(f"TP sharding: {n_sharded}/{len(view)} params sharded over "
                f"{n_model} model-parallel devices")
    return plan


def ep_param_sharding(mesh: Mesh, model: nn.Module) -> dict[str, Placement | None]:
    """Expert parallelism (PARALLEL.PARAM_SHARDING='ep'): the MoE banks'
    expert axis over 'model'; everything else, the routers too, replicated.
    Raises for a model axis of 1 and for a model without expert banks."""
    n_model = mesh.model
    if n_model <= 1:
        raise ValueError(
            "PARAM_SHARDING='ep' requires PARALLEL.MESH.MODEL > 1 "
            f"(mesh model axis has {n_model} device)")
    plan, n_sharded = {}, 0
    view = _flax_view(model)
    for name, (path, shape, axes) in view.items():
        ok = (path.rsplit("/", 1)[-1] in _EP_LEAVES and "/mlp/" in f"/{path}"
              and len(shape) >= 1 and shape[0] % n_model == 0)
        plan[name] = _placement(path, axes, 0, MODEL_AXIS) if ok else None
        n_sharded += ok
    if n_sharded == 0:
        raise ValueError(
            "expert-parallel sharding matched ZERO parameters — "
            "PARAM_SHARDING='ep' requires MODEL.MOE.ENABLED (no mlp/wi|wo|"
            "bi|bo expert banks found, or NUM_EXPERTS not divisible by the "
            "model axis)")
    logger.info(f"EP sharding: {n_sharded}/{len(view)} expert-bank params sharded "
                f"over {n_model} model-parallel devices")
    return plan


PARAM_SHARDING_FNS = {
    "fsdp": fsdp_param_sharding,
    "tp": tp_param_sharding,
    "ep": ep_param_sharding,
}
