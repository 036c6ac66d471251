"""Ranks on the CPU, and the port's parallel/ helpers against the TPU package.

``run_ranks`` starts R processes of ``gloo`` with one intra-op thread each,
which meet through a ``file://`` store under the test's ``tmp_path`` (no
port to clash under xdist); each imports a test module by path, calls one
function of it with (rank, world, out_dir) and saves what it returns. The
processes are joined under one time limit and killed past it, so a hang
fails the one test. Several checks share one start: the processes' imports
take most of its time.

Here: the collectives of parallel/ops.py (each the identity on one
process), the mesh (DATA=-1, the error for a mesh that does not cover the
world), the feed (a host's rows by data coordinate, the same rows along the
model axis), and the three plans against the TPU package's plans for the
same tiny model's tree, through utils/convert.py's Flax-path map.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from linnaeus_tpu.parallel import mesh as jmesh
from linnaeus_tpu_torch.configuration import get_default_config
from linnaeus_tpu_torch.models.mformer_v1 import MFormerV1
from linnaeus_tpu_torch.parallel import mesh as tmesh
from linnaeus_tpu_torch.parallel import ops as tops
from linnaeus_tpu_torch.utils.convert import jax_layouts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUNNER = r"""
import importlib.util, os, sys
import torch, torch.distributed as dist
path, func, rank, world, store, out = sys.argv[1:7]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
sys.path.insert(0, os.getcwd())
spec = importlib.util.spec_from_file_location("rank_body", path)
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
try:
    result = getattr(mod, func)(rank, world, out)
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
finally:
    dist.destroy_process_group()
"""


def run_ranks(path: str, func: str, world: int, tmp_path, timeout: float = 150.0,
              env: dict | None = None) -> list:
    """``func(rank, world, out_dir)`` of the module at ``path`` in ``world``
    gloo processes; returns what each rank returned, in rank order."""
    out = tmp_path / f"ranks_{func}"
    out.mkdir(exist_ok=True)
    store = tmp_path / f"store_{func}"
    penv = dict(os.environ, OMP_NUM_THREADS="1", LOCAL_WORLD_SIZE=str(world),
                WORLD_SIZE=str(world), JAX_PLATFORMS="cpu", **(env or {}))
    procs = [subprocess.Popen([sys.executable, "-c", RUNNER, path, func, str(r), str(world),
                               str(store), str(out)], cwd=REPO, env=penv,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.fail(f"{func}: ranks did not finish within {timeout} s")
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
    failed = [f"{func} rank {r} exited {p.returncode}:\n{log[-6000:]}"
              for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode != 0]
    assert not failed, "\n".join(failed)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ------------------------------------------------------------- rank bodies
def ops_body(rank, world, out):
    """parallel/ops.py and the mesh on ``world`` ranks."""
    import torch.distributed as dist

    from linnaeus_tpu_torch.parallel import mesh as m
    from linnaeus_tpu_torch.parallel import ops as o

    res = {"rank": o.get_rank_safely(), "world": o.get_world_size(),
           "dist": o.is_distributed()}
    mesh = m.create_mesh(_mesh_cfg(-1, 2), device_type="cpu")
    res["shape"] = mesh.shape
    res["coords"] = (mesh.coord("data"), mesh.coord("model"))
    x = torch.arange(3, dtype=torch.float32) + 10 * rank
    res["mean_data"] = o.reduce_tensor_mean(x, mesh, "data")
    res["gather_model"] = o.all_gather_tensor(x, mesh, "model")
    res["bcast"] = o.broadcast_host_value(7 + rank)
    res["objects"] = o.all_gather_object({"r": rank})
    res["master"] = o.master_only(lambda: "ran")()
    o.synchronize()
    res["context"] = repr(o.DistributedContext())
    # the feed: a host's batch of 8 over 2 data coordinates x 2 model
    batch = {"x": torch.arange(8), "t": {"a": torch.arange(8) * 2}, "none": None}
    res["rows"] = m.rank_rows(8, mesh)
    res["shard"] = m.shard_batch(batch, mesh)
    res["host"] = m.host_layout()
    # autograd: gather_rows / split_rows / sum_forward / sum_backward /
    # all_reduce_sum over the data group, differentiated
    g = mesh.group("data")
    a = (torch.arange(4, dtype=torch.float64) + 4 * mesh.coord("data")).requires_grad_()
    full = o.gather_rows(a, g)
    (full * torch.arange(8, dtype=torch.float64)).sum().backward()
    res["gather_grad"] = a.grad.clone()
    b = torch.arange(8, dtype=torch.float64).requires_grad_()
    (o.split_rows(b, g) ** 2).sum().backward()
    res["split_grad"] = b.grad.clone()
    c = torch.tensor([1.0 + rank], dtype=torch.float64, requires_grad=True)
    (3 * o.all_reduce_sum(c, g)).sum().backward()
    res["allreduce"] = (o.all_reduce_sum(c.detach(), g), c.grad.clone())
    d = torch.tensor([2.0], dtype=torch.float64, requires_grad=True)
    (o.sum_forward(d * (1 + mesh.coord("data")), g) * 5).sum().backward()
    res["sum_forward_grad"] = d.grad.clone()
    e = torch.tensor([2.0], dtype=torch.float64, requires_grad=True)
    (o.sum_backward(e, g) * (1 + mesh.coord("data"))).sum().backward()
    res["sum_backward_grad"] = e.grad.clone()
    ts = [torch.ones(3) * (rank + 1), torch.ones(2, dtype=torch.float64) * rank]
    o.all_reduce_(ts, None)
    o.all_reduce_(ts, dist.group.WORLD)
    res["flat"] = ts
    try:
        m.create_mesh(_mesh_cfg(3, 1), device_type="cpu")
    except ValueError as err:
        res["cover"] = str(err)
    return res


def _mesh_cfg(data, model):
    cfg = get_default_config()
    cfg.defrost()
    cfg.PARALLEL.MESH.DATA, cfg.PARALLEL.MESH.MODEL = data, model
    return cfg


def test_ops_and_mesh_on_four_ranks(tmp_path):
    res = run_ranks(__file__, "ops_body", 4, tmp_path)
    for r, got in enumerate(res):
        d, m = divmod(r, 2)  # row-major: rank = d * MODEL + m
        assert got["rank"] == r and got["world"] == 4 and got["dist"]
        assert got["shape"] == {"data": 2, "model": 2} and got["coords"] == (d, m)
        base = torch.arange(3, dtype=torch.float32)
        want = base + 10 * (m + (m + 2)) / 2
        torch.testing.assert_close(got["mean_data"], want)
        torch.testing.assert_close(got["gather_model"],
                                   torch.stack([base + 10 * (2 * d), base + 10 * (2 * d + 1)]))
        assert got["bcast"] == 7 and got["objects"] == [{"r": i} for i in range(4)]
        assert got["master"] == ("ran" if r == 0 else None)
        assert got["context"] == f"DistributedContext(rank={r}, world=4)"
        assert got["rows"] == (4 * d, 4 * d + 4) and got["host"] == (0, 1, 4)
        assert torch.equal(got["shard"]["x"], torch.arange(4 * d, 4 * d + 4))
        assert torch.equal(got["shard"]["t"]["a"], 2 * torch.arange(4 * d, 4 * d + 4))
        assert got["shard"]["none"] is None
        # the replicated loss's gradient: this rank's slice of it
        assert torch.equal(got["gather_grad"], torch.arange(4 * d, 4 * d + 4,
                                                            dtype=torch.float64))
        want_split = torch.zeros(8, dtype=torch.float64)
        want_split[:] = 2 * torch.arange(8, dtype=torch.float64)  # both ranks' chunks gathered
        assert torch.equal(got["split_grad"], want_split)
        total, grad = got["allreduce"]
        assert float(total) == (1 + m) + (3 + m) and float(grad) == 3 * 2
        assert float(got["sum_forward_grad"]) == 5 * (1 + d)
        assert float(got["sum_backward_grad"]) == 1 + 2
        assert torch.equal(got["flat"][0], torch.full((3,), 10.0))
        assert torch.equal(got["flat"][1], torch.full((2,), 6.0, dtype=torch.float64))
        assert got["cover"] == "Mesh 3x1 does not cover 4 devices; adjust PARALLEL.MESH"


def test_one_process_helpers_are_the_identity():
    x = torch.arange(4.0)
    assert tops.get_rank_safely() == 0 and tops.get_world_size() == 1
    assert not tops.is_distributed()
    assert torch.equal(tops.reduce_tensor_mean(x), x)
    assert torch.equal(tops.all_gather_tensor(x), x[None])
    assert tops.broadcast_host_value(3) == 3 and tops.all_gather_object([1]) == [[1]]
    for fn in (tops.gather_rows, tops.split_rows, tops.sum_forward, tops.sum_backward,
               tops.all_reduce_sum):
        assert fn(x, None) is x
    mesh = tmesh.create_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group("data") is None
    assert tmesh.rank_rows(8, mesh) == (0, 8) and tmesh.local_batch_slice(8) == (0, 8)
    assert tmesh.shard_batch({"x": x}, mesh)["x"] is x
    assert tmesh.initialize_multi_host(_mesh_cfg(-1, 1), device="cpu") is False
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        tmesh.create_mesh(_mesh_cfg(2, 1))
    assert tmesh.create_mesh(_mesh_cfg(-1, 1)).shape == {"data": 1, "model": 1}


# ------------------------------------------------------------------- plans
TASKS = ("taxa_L10", "taxa_L20")
NC = {"taxa_L10": 8, "taxa_L20": 6}
META = (("TEMPORAL", 2), ("SPATIAL", 3))


def _models(moe=0):
    kw = dict(img_size=(64, 64), convnext_depths=(1, 1, 2, 1), convnext_dims=(8, 16, 32, 64),
              rope_depths=(2, 1), rope_dims=(32, 64), rope_num_heads=(2, 4),
              meta_components=META, task_keys=TASKS, num_classes=NC,
              moe_num_experts=moe, moe_every_n=1)
    from linnaeus_tpu.models import MFormerV1 as JMFormerV1

    jm = JMFormerV1(head_configs={t: {"TYPE": "Linear"} for t in TASKS}, **kw)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jax.numpy.zeros((1, 64, 64, 3)),
                            jax.numpy.zeros((1, 5)))["params"]
    return MFormerV1(**kw), params


def _jax_plan(fn, params, data, model):
    from flax.traverse_util import flatten_dict

    devices = np.asarray(jax.devices()[:data * model]).reshape(data, model)
    jm = JMesh(devices, (jmesh.DATA_AXIS, jmesh.MODEL_AXIS))
    specs = flatten_dict(fn(jm, params), sep="/")
    return {path: tuple(s.spec) for path, s in specs.items()}


@pytest.mark.parametrize("mode,data,model,moe", [
    ("fsdp", 2, 1, 0), ("fsdp", 4, 2, 0), ("tp", 1, 2, 0), ("tp", 2, 4, 4), ("ep", 2, 2, 4),
])
def test_plans_match_the_tpu_package(mode, data, model, moe):
    port, params = _models(moe)
    plan = tmesh.PARAM_SHARDING_FNS[mode](tmesh.Mesh(data, model), port)
    want = _jax_plan(jmesh.PARAM_SHARDING_FNS[mode], params, data, model)
    layouts = jax_layouts(port)
    assert {layouts[n].path for n in plan} == set(want)
    n_sharded = 0
    for name, p in port.named_parameters():
        path = layouts[name].path
        spec = want[path]
        axes = [i for i, a in enumerate(spec) if a is not None]
        got = plan[name]
        if not axes:
            assert got is None, (name, got)
            continue
        n_sharded += 1
        (axis,) = axes
        assert got is not None and got.path == path and got.flax_axis == axis, name
        assert got.mesh_axis == spec[axis]
        # the torch axis holds the Flax axis's extent
        flax_shape = tuple(layouts[name].to_jax(torch.empty(p.shape, device="meta")).shape)
        assert p.shape[got.torch_axis] == flax_shape[axis], name
    assert n_sharded > 0


def test_plans_raise_as_the_tpu_package():
    port, params = _models(0)
    for mode in ("tp", "ep"):
        with pytest.raises(ValueError, match="requires PARALLEL.MESH.MODEL > 1"):
            tmesh.PARAM_SHARDING_FNS[mode](tmesh.Mesh(2, 1), port)
    with pytest.raises(ValueError, match="matched ZERO parameters"):
        tmesh.ep_param_sharding(tmesh.Mesh(1, 2), port)
    with pytest.raises(ValueError, match="matched ZERO parameters"):
        _jax_plan(jmesh.ep_param_sharding, params, 1, 2)
