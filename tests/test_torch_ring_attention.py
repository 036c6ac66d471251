"""Ring attention (sequence parallelism) on four ranks against the TPU package.

The op: ``ops/ring_attention.py::ring_attention`` over rings of P = 2 and
P = 4 gloo ranks (tests/test_torch_ranks.py::run_ranks) against the TPU
package's ``ring_attention`` under ``shard_map`` on a (1, P) mesh of its CPU
devices, on the same (B, H, N, D) arrays from a seeded numpy draw: the
output and the gradients of a weighted sum with respect to q, k and v, with
the whole sequence and with ``n_valid`` masking four padded keys, in
float32 (output 2e-5, gradients 1e-4 of their largest entry: the port's
backward recomputes the blocks' probabilities from the saved log-sum-exp
where JAX differentiates its scan) and in bfloat16 at P = 4 (3e-2, the
kernel bar). N not divisible by the
ring raises the TPU package's ``ValueError``.

The model: tests/test_torch_dp_step.py's two train steps of the tiny
mFormerV1 with PARALLEL.SEQUENCE_PARALLEL on a (data 2, model 2) mesh:
every RoPE attention a ring of two (stage 3's 19 tokens padded to 20 and
stage 4's 7 to 8, the padding masked), the batch split over the data axis;
against JAX's step on its 8-device mesh at tests/test_torch_train_step.py's bars; the
same run on that mesh under 'tp' as well.
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
from linnaeus_tpu.ops.ring_attention import ring_attention as j_ring
from linnaeus_tpu_torch.ops.ring_attention import ring_attention as t_ring
from linnaeus_tpu_torch.utils.convert import state_dict_from_jax
from tests import test_torch_dp_step as dp
from tests import test_torch_train_step as ts
from tests.test_torch_ranks import run_ranks

B, H, N, D = 2, 3, 24, 16
CASES = [(2, None, "float32"), (2, 20, "float32"), (4, 20, "float32"), (4, None, "bfloat16")]
TOL = {"float32": (2e-5, 1e-4), "bfloat16": (3e-2, 3e-2)}


@pytest.fixture(autouse=True, scope="module")
def pallas_on_cpu():
    interpret = functools.partial(pl.pallas_call, interpret=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfm.pl, "pallas_call", interpret)
        mp.setattr(jfa.pl, "pallas_call", interpret)
        mp.setattr(jfm, "_FORCE_KERNEL_BWD", True)
        yield


def _arrays():
    rng = np.random.default_rng(5)
    return [rng.normal(size=(B, H, N, D)).astype(np.float32) for _ in range(4)]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring")
    _, j_state, _, _ = ts._setup()
    torch.save({
        "v1": state_dict_from_jax(jax.tree.map(np.asarray, j_state.params), *ts.BRIDGE),
        "batch": ts._tree(dp._batch(), torch.tensor),
        "draws": dp._draws(dp.STEPS, 1),
        "scalars": ts._scalars("mixed_masked")[1],
        "arrays": _arrays(),
    }, d / "inputs.pt")
    return d


def ring_body(rank, world, out):
    from linnaeus_tpu_torch.configuration import get_default_config
    from linnaeus_tpu_torch.parallel.mesh import create_mesh

    payload = torch.load(f"{out}/../inputs.pt", weights_only=False)
    res = {"op": {}}
    meshes = {}
    for p in (2, 4):
        cfg = get_default_config()
        cfg.PARALLEL.MESH.MODEL = p
        meshes[p] = create_mesh(cfg, device_type="cpu")
    for p, nv, dt in CASES:
        group = meshes[p].group("model")
        q, k, v, w = (torch.tensor(a).to(getattr(torch, dt)) for a in payload["arrays"])
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        o = t_ring(q, k, v, group, n_valid=nv)
        (o.float() * w.float()).sum().backward()
        res["op"][(p, nv, dt)] = [t.detach().float() for t in (o, q.grad, k.grad, v.grad)]
    try:
        t_ring(*(torch.zeros(B, H, 6, D) for _ in range(3)), meshes[4].group("model"))
    except ValueError as err:
        res["indivisible"] = str(err)
    res["model"] = dp._run(payload, meshes[2], "replicated", sequence_parallel=True)
    res["tp"] = dp._run(payload, meshes[2], "tp")
    return res


@pytest.fixture(scope="module")
def ranks(inputs):
    return run_ranks(__file__, "ring_body", 4, inputs, timeout=240)


def _jax_ring(p, nv, dt):
    q, k, v, w = (jnp.asarray(a, getattr(jnp, dt)) for a in _arrays())
    mesh = JMesh(np.asarray(jax.devices()[:p]).reshape(1, p), ("data", "model"))

    def loss(q, k, v):
        o = j_ring(q, k, v, mesh, n_valid=nv)
        return (o.astype(jnp.float32) * w.astype(jnp.float32)).sum(), o

    (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return [np.asarray(t.astype(jnp.float32)) for t in (o, *grads)]


@pytest.mark.parametrize("case", CASES, ids=[f"P{p}-nv{nv}-{dt}" for p, nv, dt in CASES])
def test_ring_matches_the_tpu_package(ranks, case):
    p, nv, dt = case
    want = _jax_ring(p, nv, dt)
    fwd, bwd = TOL[dt]
    for res in ranks:
        got = res["op"][case]
        for name, g, w, tol in zip(("out", "dq", "dk", "dv"), got, want, (fwd, bwd, bwd, bwd)):
            scale = 1.0 if name == "out" else max(float(np.abs(w).max()), 1.0)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol * scale, err_msg=name)
    if nv is not None:  # the padded keys take no softmax mass: no gradient reaches them
        assert float(ranks[0]["op"][case][2][:, :, nv:].abs().max()) == 0.0


def test_ring_of_one_is_exact_attention_and_indivisible_n_raises(ranks):
    q, k, v, _ = (torch.tensor(a) for a in _arrays())
    o = t_ring(q, k, v)  # float32 math, as the TPU package's
    q, k, v = (t.double() for t in (q, k, v))
    ref = torch.softmax(q @ k.transpose(-1, -2) * D ** -0.5, -1) @ v
    torch.testing.assert_close(o.double(), ref, rtol=0, atol=2e-6)
    assert ranks[0]["indivisible"] == ("ring_attention: N=6 not divisible by mesh axis 'model' "
                                       "of size 4")
    with pytest.raises(ValueError, match="N=6 not divisible"):
        _jax_ring_indivisible()


def _jax_ring_indivisible():
    mesh = JMesh(np.asarray(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
    z = jnp.zeros((B, H, 6, D))
    j_ring(z, z, z, mesh)


@pytest.mark.parametrize("key", ["model", "tp"])
def test_sequence_and_tensor_parallel_steps_match_the_jax_mesh(ranks, key):
    """SEQUENCE_PARALLEL, and 'tp' (tests/test_torch_tp_ep.py's mode) with
    the batch split over a data axis of 2 as well."""
    j_metrics, j_state = dp._jax_run(1, dp.STEPS)
    for res in ranks:
        got = res[key]
        mu, _ = dp._compare(got, j_metrics, j_state)
        dp._params(got, j_state, mu)
