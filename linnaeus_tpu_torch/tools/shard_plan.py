"""Deployment planner: what one rank holds and moves in a sharded train step.

Port of linnaeus_tpu/tools/shard_plan.py, with its command line and report
keys. The TPU package compiles the sharded step ahead of time and reads the
plan off the executable. torch has no such executable, so this tool builds
the plan from the port's own placements and runs one real step:

  * per-rank parameter and optimizer bytes: what the rank (``--rank``, 0
    by default) holds after
    ``parallel/model.py::shard_model`` (the model axis's shares under 'tp'
    and 'ep') and ``apply_fsdp`` (FSDP2's shards under 'fsdp'), with the
    whole sizes beside them;
  * a collective census: one ``make_train_step`` step of the rank at its
    local batch, at world size N in this one process over torch's fake
    process group (``torch.testing._internal.distributed.fake_pg``: every
    collective completes at once and moves no data). Every c10d call of the
    step is counted by kind (all-reduce, all-gather, reduce-scatter,
    broadcast, all-to-all, and the pipeline's send and recv, XLA's
    collective-permute) with the bytes that land on the rank, summed and
    the largest call's, FSDP2's own included;
  * the largest replicated parameters (the next sharding candidates);
  * ``memory_analysis``: on the card, the peak of that step
    (``torch.cuda.max_memory_allocated``); None on the CPU.

The fake group moves no data, but what a step fetches depends on data: the
mixing partners it takes from other ranks follow the group ids of the
global batch. So the census plays the other ranks for the batch: an
all-gather of the rank's targets, metadata or group ids returns the global
batch's, which the plan builds as the trainer does, never what the fake
gather would. The labels are scale_receipt's synthetic 4-level taxonomy
(``tools/scale_receipt.py::generate_labels``' arrays, 16,384 rows); the
global batch is the first batch of the 'mixed-pairs' sampler
(``data/sampler.py``) at a mixup group level. A step mixes every row
(``mix_prob`` 1), each with a random member of its group in the global
batch (``data/collate.py::ingroup_permutation``), so the coarser the level,
the more partners sit on other ranks. The plan runs one step at each level
of the default config's ``SCHEDULE.MIX.GROUP_LEVELS`` (its first, the
coarsest, is what training starts on): ``collectives_per_step`` is the
first level's step, ``partner_fetch`` the partner rows and bytes of each.
The step augments as the default config does (AutoAugment, colour jitter,
flip, pixel erasing).

Usage:
    python -m linnaeus_tpu_torch.tools.shard_plan --arch mFormerV1_sm \\
        --mesh data=8 --mode dp --batch 512 --img 384
    python -m linnaeus_tpu_torch.tools.shard_plan --mesh data=4,model=2 --mode tp \\
        --batch 16 --img 64 --device cpu --json -
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather", "allgather_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "broadcast_": "broadcast",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "send": "send", "recv_": "recv", "recv_any_source_": "recv",
}
MODES = ("dp", "fsdp", "tp", "ep", "pp")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


def _bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


class CollectiveCensus(TorchDispatchMode):
    """Counts every c10d call made inside it: count, bytes and the largest
    call's bytes by kind, the bytes being those of the call's first operand
    (its result: what lands on this rank). ``fills`` maps a tensor's
    data_ptr to the tensor an all-gather of it is to return (the global
    batch's rows, which the fake group does not move)."""

    def __init__(self, fills: dict[int, torch.Tensor] | None = None):
        super().__init__()
        self.fills = fills or {}
        self.census: dict[str, dict] = defaultdict(lambda: {"count": 0, "bytes": 0,
                                                            "max_bytes": 0})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._schema.name
        kind = KINDS.get(name.split("::", 1)[1]) if name.startswith("c10d::") else None
        if kind is not None:
            nbytes = _bytes(args[0])
            entry = self.census[kind]
            entry["count"] += 1
            entry["bytes"] += nbytes
            entry["max_bytes"] = max(entry["max_bytes"], nbytes)
            if kind == "all-gather" and name.endswith("_allgather_base_"):
                fill = self.fills.get(args[1].data_ptr())
                if fill is not None:
                    args[0].copy_(fill.reshape(args[0].shape))
        return out

    def report(self) -> dict[str, dict]:
        return {k: dict(v) for k, v in sorted(self.census.items())}


def _held(p: torch.Tensor) -> int:
    return (p.to_local() if hasattr(p, "to_local") else p).numel()


def _whole(p: torch.Tensor) -> int:
    share = getattr(p, "share", None)
    return int(np.prod(share.shape)) if share is not None else p.numel()


LABEL_ROWS = 16384
LEVEL_BASE = {"taxa_L10": 0, "taxa_L20": 1000, "taxa_L30": 1400, "taxa_L40": 1500}


def plan_labels(rows: int = LABEL_ROWS) -> dict[str, np.ndarray]:
    """scale_receipt's label set: each level's class index (0 for null)."""
    from linnaeus_tpu_torch.tools.e2e_train_bench import hierarchy_labels

    levels = hierarchy_labels(rows, null_frac=0.02, rng=np.random.default_rng(0))[:4]
    return {lvl: np.where(ids > 0, ids - LEVEL_BASE[lvl], 0).astype(np.int64)
            for lvl, ids in zip(LEVEL_BASE, levels)}


def pairs_batch(batch: int, num_classes: dict[str, int], meta_dim: int, img: int,
                level: str, labels: dict[str, np.ndarray] | None = None,
                seed: int = 0) -> dict[str, np.ndarray]:
    """A global batch as the trainer gets it at mixup group ``level``: the
    first batch of the 'mixed-pairs' sampler over ``labels``
    (:func:`plan_labels` by default; group ids the class index at ``level``,
    -1 for null), each task's targets its level's class (modulo its class
    count: a tiny model's heads), random uint8 images and metadata."""
    from linnaeus_tpu_torch.data.sampler import GroupedBatchSampler

    labels = plan_labels() if labels is None else labels
    groups = {lvl: np.where(c > 0, c, -1).astype(np.int32) for lvl, c in labels.items()}
    n = len(next(iter(labels.values())))
    rows = GroupedBatchSampler(groups, np.arange(n), batch, mode="mixed-pairs", seed=seed,
                               initial_level=level).batches()[0]
    rng = np.random.default_rng(seed)
    return {
        "images": rng.integers(0, 256, (batch, img, img, 3), dtype=np.uint8),
        "targets": {t: labels.get(t, labels["taxa_L10"])[rows] % k
                    for t, k in num_classes.items()},
        "aux": rng.normal(size=(batch, meta_dim)).astype(np.float32),
        "group_ids": groups[level][rows],
    }


def build_plan(arch: str, mesh_axes: dict[str, int], mode: str, batch: int, img: int,
               model=None, num_classes: dict[str, int] | None = None, remat: bool = False,
               microbatches: int = 0, device: str | None = None, seed: int = 0,
               rank: int = 0) -> dict:
    """The plan of ``mode`` on ``mesh_axes`` at a global ``batch`` of
    ``img`` px, as ``rank`` holds and runs it. ``model`` / ``num_classes``
    override the arch preset (a tiny model for the tests), built on
    ``device`` (the card by default). Starts and ends a fake process group;
    one must not be running."""
    from torch.testing._internal.distributed import fake_pg  # noqa: F401  (registers "fake")

    from linnaeus_tpu_torch.configuration import get_default_config
    from linnaeus_tpu_torch.configuration.archs import apply_arch
    from linnaeus_tpu_torch.data.augmentation.autoaugment import AugmentationPipelineFactory
    from linnaeus_tpu_torch.data.collate import MixConfig
    from linnaeus_tpu_torch.loss import soft_target_cross_entropy
    from linnaeus_tpu_torch.models.build import build_model
    from torch.distributed.device_mesh import init_device_mesh

    from linnaeus_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, shard_batch
    from linnaeus_tpu_torch.parallel.model import apply_fsdp, fsdp_units, shard_model
    from linnaeus_tpu_torch.train.state import create_train_state
    from linnaeus_tpu_torch.train.step import ScheduleScalars, make_train_step
    from linnaeus_tpu_torch.utils.device import resolve_device

    if mode not in MODES:
        raise SystemExit(f"unknown mode {mode!r}; choose {'|'.join(MODES)}")
    data, model_axis = int(mesh_axes.get("data", 1)), int(mesh_axes.get("model", 1))
    if set(mesh_axes) - {"data", "model"}:
        raise SystemExit(f"mesh axes are data and model, not {sorted(mesh_axes)}")
    if batch % data:
        raise SystemExit(f"global batch {batch} does not split over data={data}")
    if mode == "pp" and model_axis < 2:
        raise SystemExit("pp planning needs a model axis with >= 2 stages, e.g. "
                         "--mesh data=4,model=2 (the stage count IS the model-axis size)")
    dev = resolve_device(device)
    if num_classes is None:
        num_classes = {"taxa_L10": 1000, "taxa_L20": 400, "taxa_L30": 100, "taxa_L40": 30}
    tasks = tuple(num_classes)
    cfg = get_default_config()
    levels = list(cfg.SCHEDULE.MIX.GROUP_LEVELS)
    augment = AugmentationPipelineFactory.create(cfg)
    if model is None:
        cfg.MODEL.IMG_SIZE = cfg.DATA.IMG_SIZE = img
        cfg.DATA.TASK_KEYS_H5 = list(tasks)
        cfg.TRAIN.MIXED_PRECISION.ENABLED = True  # the production bf16 compute
        apply_arch(cfg, arch)
        if mode == "pp":  # the pipeline takes no stochastic depth
            cfg.MODEL.DROP_PATH_RATE = 0.0
        model = build_model(cfg, num_classes, device=dev, seed=seed)
    model.gradient_checkpointing = bool(remat)
    bounds, meta_dim = [], 0
    for _, dim in model.meta_components:
        bounds.append((meta_dim, meta_dim + dim))
        meta_dim += dim

    world = data * model_axis
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=rank, world_size=world)
    try:
        mesh = Mesh(data, model_axis, init_device_mesh(
            dev.type, (data, model_axis), mesh_dim_names=(DATA_AXIS, MODEL_AXIS)))
        split = shard_model(model, mesh, "replicated" if mode in ("dp", "pp") else mode,
                            pipeline_stages=model_axis if mode == "pp" else 1,
                            microbatches=int(microbatches))
        units = None
        if mode == "fsdp":
            # each unit's parameters as FSDP2 gathers them: every leaf's rows
            # padded to a multiple of the data axis
            blocks = [u for u in fsdp_units(model)[:-1]]
            inner = {id(p) for u in blocks for p in u.parameters()}
            units = [list(u.parameters()) for u in blocks]
            units.append([p for p in model.parameters() if id(p) not in inner])
            units = [sum(-(-p.shape[0] // data) * data * (p.numel() // max(p.shape[0], 1))
                         * p.element_size() for p in u) for u in units]
            apply_fsdp(model, mesh)
        params = [p for p in model.parameters()]
        optimizer = torch.optim.AdamW(params, lr=1e-3)
        state = create_train_state(model, optimizer, num_tasks=len(tasks),
                                   generator=torch.Generator(device=dev).manual_seed(seed))
        step = make_train_step(
            {t: soft_target_cross_entropy for t in tasks}, tasks,
            MixConfig(mixup_enabled=True, cutmix_enabled=True, chunk_bounds=tuple(bounds)),
            clip_grad=5.0, num_classes=num_classes, augment_fn=augment, mesh=mesh,
            model_split=split)
        scalars = ScheduleScalars(mix_prob=1.0, use_cutmix=False, meta_mask_prob=0.0,
                                  partial_mask_prob=0.0,
                                  partial_combo_mask=torch.zeros(meta_dim, device=dev),
                                  null_mask_prob=1.0)
        labels = plan_labels()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
        censuses = {}
        for level in levels:  # the first level's step is the plan's census
            whole = pairs_batch(batch, num_classes, meta_dim, img, level, labels, seed)
            whole = {k: ({t: torch.from_numpy(x).to(dev) for t, x in v.items()}
                         if isinstance(v, dict) else torch.from_numpy(v).to(dev))
                     for k, v in whole.items()}
            mine = shard_batch(whole, mesh)
            mine = {k: ({t: x.clone() for t, x in v.items()} if isinstance(v, dict)
                        else v.clone()) for k, v in mine.items()}
            fills = {mine[k].data_ptr(): whole[k] for k in ("aux", "group_ids")}
            fills.update({mine["targets"][t].data_ptr(): whole["targets"][t] for t in tasks})
            census = CollectiveCensus(fills)
            with census:
                step(state, mine, scalars)
            censuses[level] = census.report()
        mem = None
        if dev.type == "cuda":
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            mem = {"before_step": before, "peak": peak, "per_device_total": peak}
        row = img * img * 3
        fetch = {level: {"rows": c.get("all-to-all", {"bytes": 0})["bytes"] // row,
                         "bytes": c.get("all-to-all", {"bytes": 0})["bytes"]}
                 for level, c in censuses.items()}

        p_total = sum(_whole(p) * p.element_size() for p in params)
        p_dev = sum(_held(p) * p.element_size() for p in params)
        o_total = o_dev = 0
        for p in params:
            for v in optimizer.state.get(p, {}).values():
                if isinstance(v, torch.Tensor):
                    held = _held(v) * v.element_size()
                    o_dev += held
                    o_total += held * _whole(p) // _held(p) if _held(v) == _held(p) else held
        for v in (state.gradnorm.task_weights, state.gradnorm.initial_losses):
            if isinstance(v, torch.Tensor):
                o_total += v.numel() * v.element_size()
                o_dev += v.numel() * v.element_size()
        named = [(n, p) for n, p in model.named_parameters()]
        sharded = [n for n, p in named if _held(p) < _whole(p) or hasattr(p, "to_local")]
        replicated = sorted(((_whole(p) * p.element_size(), n) for n, p in named
                             if n not in set(sharded)), reverse=True)[:8]
        return {
            "arch": arch,
            "mesh": mesh_axes,
            "mode": mode,
            "rank": rank,
            "mix_prob": 1.0,
            "batch_global": batch,
            "batch_per_device": batch // data,
            "img": img,
            "device": str(dev),
            "param_count": int(sum(_whole(p) for p in params)),
            "param_bytes_total": int(p_total),
            "param_bytes_per_device": int(p_dev),
            "opt_ema_bytes_total": int(o_total),
            "opt_ema_bytes_per_device": int(o_dev),
            "params_sharded": len(sharded),
            "params_total_leaves": len(named),
            "largest_replicated": [{"path": n, "mbytes": round(b / 1e6, 2)}
                                   for b, n in replicated],
            "memory_analysis": mem,
            "collectives_per_step": censuses[levels[0]],
            "group_level": levels[0],
            # each level's mixing partners taken from other ranks (uint8 rows)
            "partner_fetch": fetch,
            # fsdp: what one FSDP2 unit gathers (a block; the root's own), at most
            "largest_unit_bytes": None if units is None else max(units),
        }
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("shard_plan")
    ap.add_argument("--arch", default="mFormerV1_sm")
    ap.add_argument("--mesh", default="data=8",
                    help="comma list of axis=size, e.g. data=4,model=2")
    ap.add_argument("--mode", default="fsdp",
                    help="dp | fsdp | tp | ep (parallel/mesh.py) | pp (PARALLEL.PIPELINE: "
                         "GPipe towers over the model axis, replicated state)")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="pp mode: microbatches per step (0 -> stage count)")
    ap.add_argument("--batch", type=int, default=128,
                    help="GLOBAL batch (must divide by the data axis)")
    ap.add_argument("--img", type=int, default=224)
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--rank", type=int, default=0, help="the rank whose share is planned")
    ap.add_argument("--json", default=None,
                    help="write the plan JSON here ('-' = stdout only)")
    ap.add_argument("--remat", action="store_true", help="plan with gradient checkpointing")
    args = ap.parse_args(argv)

    mesh_axes: dict[str, int] = {}
    for part in args.mesh.split(","):
        k, _, v = part.partition("=")
        mesh_axes[k.strip()] = int(v)

    plan = build_plan(args.arch, mesh_axes, args.mode, args.batch, args.img,
                      remat=args.remat, microbatches=args.microbatches, device=args.device,
                      rank=args.rank)
    plan["remat"] = bool(args.remat)

    out = json.dumps(plan, indent=2)
    if args.json and args.json != "-":
        with open(args.json, "w") as f:
            f.write(out)
    print(out)

    gb = 1 / 1e9
    print(f"\n[{args.arch} | {args.mesh} | {args.mode}] params {plan['param_count'] / 1e6:.1f}M: "
          f"{plan['param_bytes_per_device'] * gb:.3f} GB/device "
          f"(+ {plan['opt_ema_bytes_per_device'] * gb:.3f} GB opt state)", file=sys.stderr)
    if plan["memory_analysis"]:
        print(f"step peak/device: {plan['memory_analysis']['per_device_total'] * gb:.3f} GB",
              file=sys.stderr)
    print(f"  partner rows fetched a step by mixup group level: "
          + ", ".join(f"{lvl} {v['rows']} ({v['bytes'] * gb:.4f} GB)"
                      for lvl, v in plan["partner_fetch"].items()), file=sys.stderr)
    for kind, v in plan["collectives_per_step"].items():
        print(f"  {kind}: {v['count']} ops, {v['bytes'] * gb:.4f} GB/step, largest "
              f"{v['max_bytes'] * gb:.4f} GB", file=sys.stderr)


if __name__ == "__main__":
    main()
