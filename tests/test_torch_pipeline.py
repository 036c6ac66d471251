"""GPipe pipelining on four ranks against the TPU package.

The op: ``parallel/pipeline.py::pipeline_forward`` of four stacked uniform
layers (h <- tanh(h W + b) + h) over S = 2 stages with M = 2 and 4
microbatches and over S = 4 stages with M = 4, in gloo ranks
(tests/test_torch_ranks.py::run_ranks), against the TPU package's
``pipeline_forward`` under ``shard_map`` on a (1, S) mesh of its CPU devices
on the same seeded arrays: the output and the gradients of a weighted sum
with respect to the input and the stacked parameters (each stage's summed
over the axis), in float64 on the
port's side against float32 on JAX's (1e-5), and the output equal to the
port's sequential stack per microbatch bit for bit on every stage. Its
``ValueError``s (layers, microbatches, M < S) are the TPU package's.

The model: tests/test_torch_dp_step.py's two train steps of the tiny
mFormerV1 with PARALLEL.PIPELINE.STAGES 2 on a (data 2, model 2) mesh (stage
3's two blocks one a stage, stage 4's one block sequential, as in the TPU
package) and with remat on (the pipeline's backward re-runs each stage
anyway), against JAX's step on its 8-device mesh at tests/test_torch_train_step.py's bars.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.sharding import Mesh as JMesh

import linnaeus_tpu.ops.flash_attention as jfa
import linnaeus_tpu.ops.fused_mlp as jfm
from linnaeus_tpu.parallel.pipeline import pipeline_forward as j_pipe
from linnaeus_tpu.parallel.pipeline import stack_layer_params as j_stack
from linnaeus_tpu_torch.parallel import pipeline as tpipe
from linnaeus_tpu_torch.parallel.mesh import Mesh
from linnaeus_tpu_torch.utils.convert import state_dict_from_jax
from tests import test_torch_dp_step as dp
from tests import test_torch_train_step as ts
from tests.test_torch_ranks import run_ranks

L, BATCH, WIDTH = 4, 8, 6
CASES = [(2, 2), (2, 4), (4, 4)]


@pytest.fixture(autouse=True, scope="module")
def pallas_on_cpu():
    interpret = functools.partial(pl.pallas_call, interpret=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfm.pl, "pallas_call", interpret)
        mp.setattr(jfa.pl, "pallas_call", interpret)
        mp.setattr(jfm, "_FORCE_KERNEL_BWD", True)
        yield


def _arrays():
    rng = np.random.default_rng(3)
    layers = [{"w": 0.5 * rng.normal(size=(WIDTH, WIDTH)), "b": rng.normal(size=(WIDTH,))}
              for _ in range(L)]
    return layers, rng.normal(size=(BATCH, WIDTH)), rng.normal(size=(BATCH, WIDTH))


def _t_block(p, h):
    return torch.tanh(h @ p["w"] + p["b"]) + h


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    _, j_state, _, _ = ts._setup()
    torch.save({
        "v1": state_dict_from_jax(jax.tree.map(np.asarray, j_state.params), *ts.BRIDGE),
        "batch": ts._tree(dp._batch(), torch.tensor),
        "draws": dp._draws(dp.STEPS, 1),
        "scalars": ts._scalars("mixed_masked")[1],
        "arrays": _arrays(),
    }, d / "inputs.pt")
    return d


def pipe_body(rank, world, out):
    from linnaeus_tpu_torch.configuration import get_default_config
    from linnaeus_tpu_torch.parallel.mesh import create_mesh
    from linnaeus_tpu_torch.parallel.ops import all_reduce_

    payload = torch.load(f"{out}/../inputs.pt", weights_only=False)
    layers, x, w = payload["arrays"]
    meshes = {}
    for s in (2, 4):
        cfg = get_default_config()
        cfg.PARALLEL.MESH.MODEL = s
        meshes[s] = create_mesh(cfg, device_type="cpu")
    res = {"op": {}}
    for s, m in CASES:
        stacked = {k: torch.tensor(np.stack([ly[k] for ly in layers])).requires_grad_()
                   for k in ("w", "b")}
        xt = torch.tensor(x).requires_grad_()
        o = tpipe.pipeline_forward(_t_block, stacked, xt, meshes[s], num_microbatches=m)
        (o * torch.tensor(w)).sum().backward()
        seq = xt.detach()
        for i in range(L):
            seq = _t_block({k: v.detach()[i] for k, v in stacked.items()}, seq)
        # a stage holds its own layers' gradients (zeros elsewhere): summed
        # over the axis, as the train step sums the tower's
        grads = [stacked["w"].grad, stacked["b"].grad]
        all_reduce_(grads, meshes[s].group("model"))
        res["op"][(s, m)] = {"out": o.detach(), "dx": xt.grad, "dw": grads[0], "db": grads[1],
                             "sequential": seq}
    errors = []
    for kw in ({"num_microbatches": 3}, {"num_microbatches": 2}):
        try:
            tpipe.pipeline_forward(_t_block, {"w": torch.zeros(L, 2, 2)}, torch.zeros(8, 2),
                                   meshes[4], **kw)
        except ValueError as err:
            errors.append(str(err))
    res["errors"] = errors
    res["model"] = dp._run(payload, meshes[2], "replicated", pipeline_stages=2)
    res["model_remat"] = dp._run(payload, meshes[2], "replicated", pipeline_stages=2,
                                 remat=True)
    return res


@pytest.fixture(scope="module")
def ranks(inputs):
    return run_ranks(__file__, "pipe_body", 4, inputs, timeout=240)


def _jax_pipe(s, m):
    layers, x, w = _arrays()
    mesh = JMesh(np.asarray(jax.devices()[:s]).reshape(1, s), ("data", "model"))

    def block(p, h):
        return jnp.tanh(h @ p["w"] + p["b"]) + h

    def loss(stacked, x):
        o = j_pipe(block, stacked, x, mesh, num_microbatches=m)
        return (o * w).sum(), o

    stacked = j_stack([{k: jnp.asarray(v, jnp.float32) for k, v in ly.items()} for ly in layers])
    (_, o), (g_p, g_x) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        stacked, jnp.asarray(x, jnp.float32))
    return {"out": o, "dx": g_x, "dw": g_p["w"], "db": g_p["b"]}


@pytest.mark.parametrize("case", CASES, ids=[f"S{s}-M{m}" for s, m in CASES])
def test_pipeline_matches_the_tpu_package(ranks, case):
    want = _jax_pipe(*case)
    for res in ranks:
        got = res["op"][case]
        assert torch.equal(got["out"], got["sequential"])
        for key, value in want.items():
            np.testing.assert_allclose(got[key].numpy(), np.asarray(value), rtol=0, atol=1e-5,
                                       err_msg=key)


def test_pipeline_errors_are_the_tpu_package_s(ranks):
    assert ranks[0]["errors"] == ["pipeline: batch 8 not divisible by M=3",
                                  "pipeline: need microbatches >= stages (2 < 4) — smaller M "
                                  "leaves devices idle every tick"]
    with pytest.raises(ValueError, match="3 layers not divisible by 2 stages"):
        tpipe.pipeline_forward(lambda p, h: h, {"w": torch.zeros(3, 1)}, torch.zeros(2, 1),
                               Mesh(1, 2), num_microbatches=2)
    with pytest.raises(ValueError, match="batch_axis 'nope'"):
        tpipe.pipeline_forward(lambda p, h: h, {"w": torch.zeros(2, 1)}, torch.zeros(2, 1),
                               Mesh(1, 2), num_microbatches=2, batch_axis="nope")
    layers = [{"w": torch.ones(2)}, {"w": torch.zeros(2)}]
    assert torch.equal(tpipe.unstack_layer_params(tpipe.stack_layer_params(layers))[1]["w"],
                       layers[1]["w"])


@pytest.mark.parametrize("key", ["model", "model_remat"])
def test_pipelined_towers_match_the_jax_mesh(ranks, key):
    j_metrics, j_state = dp._jax_run(1, dp.STEPS)
    for res in ranks:
        got = res[key]
        mu, _ = dp._compare(got, j_metrics, j_state)
        dp._params(got, j_state, mu)
