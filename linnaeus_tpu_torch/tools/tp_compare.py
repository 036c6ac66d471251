"""dp against dp x tp against dp x sp: one train step's loss and wall time.

Port of linnaeus_tpu/tools/tp_compare.py. The same scaled-up mFormerV1
(64 px, ConvNeXt dims 64/128/256/512, RoPE dims 256/512 with 4/8 heads) and
the same global batch of 32 go through the port's ``make_train_step`` under
pure data parallelism (data = world), tensor parallelism (data x model,
'tp': parallel/model.py) and sequence parallelism (the same mesh, the RoPE
attentions as a ring over the model axis, ops/ring_attention.py). Each mode
runs as data x model gloo processes on this host's CPU (dp on as many; one
intra-op thread each, meeting through a ``file://`` store), started and
joined under a time limit of their own. It asserts that the three step-1 losses agree within
1e-3 and prints one JSON line. The times are the overhead of the
collectives and the split on one host, all ranks sharing its cores: they
say nothing of scaling over cards.

Usage:
    python -m linnaeus_tpu_torch.tools.tp_compare               # 8 ranks: 8x1, 2x4, 2x4
    python -m linnaeus_tpu_torch.tools.tp_compare --data 1 --model 2 --steps 1
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

TASKS = ("taxa_L10", "taxa_L20")
NC = {"taxa_L10": 1000, "taxa_L20": 400}
B, IMG = 32, 64
SPEC = {"CONVNEXT": {"DEPTHS": [1, 1, 2, 1], "DIMS": [64, 128, 256, 512]},
        "ROPE": {"DEPTHS": [2, 1], "DIMS": [256, 512], "NUM_HEADS": [4, 8]},
        "DROP_PATH_RATE": 0.0}
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rank_step(mode: str, data: int, model_axis: int, steps: int) -> dict:
    """One rank of ``mode`` ('dp', 'tp' or 'sp') on a (data, model) mesh:
    the step-1 loss and the mean wall ms of ``steps`` more steps."""
    import numpy as np
    import torch

    from linnaeus_tpu_torch.configuration import get_default_config
    from linnaeus_tpu_torch.data.collate import MixConfig
    from linnaeus_tpu_torch.loss import soft_target_cross_entropy
    from linnaeus_tpu_torch.models.build import build_model
    from linnaeus_tpu_torch.parallel.mesh import create_mesh, shard_batch
    from linnaeus_tpu_torch.parallel.model import shard_model
    from linnaeus_tpu_torch.train.state import create_train_state
    from linnaeus_tpu_torch.train.step import ScheduleScalars, make_train_step

    cfg = get_default_config()
    cfg.PARALLEL.MESH.DATA, cfg.PARALLEL.MESH.MODEL = data, model_axis
    mesh = create_mesh(cfg, device_type="cpu")
    meta = (("TEMPORAL", 2), ("SPATIAL", 3))
    model = build_model(SPEC, IMG, NC, meta, device="cpu", seed=0)
    split = shard_model(model, mesh, "tp" if mode == "tp" else "replicated",
                        sequence_parallel=mode == "sp")
    state = create_train_state(model, torch.optim.AdamW(model.parameters(), lr=1e-4),
                               num_tasks=len(TASKS), generator=torch.Generator().manual_seed(0))
    step = make_train_step({t: soft_target_cross_entropy for t in TASKS}, TASKS,
                           MixConfig(mixup_enabled=True, chunk_bounds=((0, 2), (2, 5))),
                           clip_grad=5.0, num_classes=NC, mesh=mesh, model_split=split)
    rng = np.random.default_rng(0)
    batch = {
        "images": torch.from_numpy(rng.normal(size=(B, IMG, IMG, 3)).astype(np.float32)),
        "aux": torch.from_numpy(rng.normal(size=(B, 5)).astype(np.float32)),
        "targets": {t: torch.from_numpy(rng.integers(0, NC[t], B)) for t in TASKS},
        "group_ids": torch.arange(B, dtype=torch.int32) // 2,
    }
    mine = shard_batch(batch, mesh)
    scalars = ScheduleScalars.zeros(5)
    _, metrics = step(state, mine, scalars)
    loss = float(metrics["loss"])
    t0 = time.perf_counter()
    for _ in range(steps):
        _, metrics = step(state, mine, scalars)
    float(metrics["loss"])
    return {"loss_step1": loss, "ms_per_step": 1000.0 * (time.perf_counter() - t0) / steps}


def run_mode(mode: str, data: int, model_axis: int, steps: int, work: str,
             timeout: float) -> dict:
    """``mode`` in data x model gloo processes, joined under ``timeout``
    seconds and killed past it; rank 0's result."""
    world = data * model_axis
    out = os.path.join(work, mode)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    env = dict(os.environ, OMP_NUM_THREADS="1", WORLD_SIZE=str(world),
               LOCAL_WORLD_SIZE=str(world))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "linnaeus_tpu_torch.tools.tp_compare", "--child", mode,
         "--rank", str(r), "--data", str(data), "--model", str(model_axis), "--steps",
         str(steps), "--work", out], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"tp_compare: {mode} did not finish in {timeout:.0f} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        bad = next(i for i, p in enumerate(procs) if p.returncode)
        raise RuntimeError(f"tp_compare: {mode} rank {bad} failed:\n{logs[bad][-2000:]}")
    with open(os.path.join(out, "rank0.json")) as f:
        return json.load(f)


def child(args) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    world = args.data * args.model
    dist.init_process_group("gloo", init_method="file://" + os.path.abspath(
        os.path.join(args.work, "store")), rank=args.rank, world_size=world)
    try:
        result = rank_step(args.child, args.data, args.model, args.steps)
    finally:
        dist.destroy_process_group()
    if args.rank == 0:
        with open(os.path.join(args.work, "rank0.json"), "w") as f:
            json.dump(result, f)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("tp_compare")
    ap.add_argument("--data", type=int, default=2, help="data axis of the tp and sp meshes")
    ap.add_argument("--model", type=int, default=4, help="model axis of the tp and sp meshes")
    ap.add_argument("--steps", type=int, default=6, help="timed steps after step 1")
    ap.add_argument("--work", default="build/tp_compare")
    ap.add_argument("--timeout", type=float, default=900.0, help="seconds a mode")
    # internal: one rank of one mode
    ap.add_argument("--child", default="")
    ap.add_argument("--rank", type=int, default=0)
    args = ap.parse_args(argv)
    if args.child:
        child(args)
        return {}

    world = args.data * args.model
    runs = {}
    for mode, (d, m) in (("dp", (world, 1)), ("tp", (args.data, args.model)),
                         ("sp", (args.data, args.model))):
        r = run_mode(mode, d, m, args.steps, args.work, args.timeout)
        runs[mode] = {"label": f"{'dp' if mode == 'dp' else 'dp x ' + mode} ({d}x{m})"
                               + (" ring" if mode == "sp" else ""),
                      "loss_step1": round(r["loss_step1"], 6),
                      "ms_per_step": round(r["ms_per_step"], 1)}
    for mode in ("tp", "sp"):
        gap = abs(runs[mode]["loss_step1"] - runs["dp"]["loss_step1"])
        if gap >= 1e-3:
            raise AssertionError(f"{mode} loss diverges: {runs[mode]['loss_step1']} vs "
                                 f"{runs['dp']['loss_step1']}")
    record = dict(runs, world=world, host_cores=os.cpu_count(),
                  note="gloo ranks on one host's CPU: one-host overhead, not scaling",
                  tp_overhead=round(runs["tp"]["ms_per_step"] / runs["dp"]["ms_per_step"], 3),
                  sp_overhead=round(runs["sp"]["ms_per_step"] / runs["dp"]["ms_per_step"], 3))
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
