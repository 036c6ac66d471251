"""Tensor and expert parallelism on two ranks against the TPU package.

Two gloo processes on a (data 1, model 2) mesh (tests/test_torch_ranks.py::
run_ranks) take tests/test_torch_dp_step.py's two steps: the same weights,
the same global batch on both ranks (ranks along the model axis take the
same rows), JAX's draws handed in.

* 'tp': each rank holds and computes one of the two heads of every RoPE
  attention (q, k and v of a head together, the output projection's
  matching input columns summed over the axis), half of every RoPE MLP's
  hidden columns and half of each Linear head's classes (gathered back);
  against JAX's
  step under ``jit`` on its 8-device mesh, at tests/test_torch_train_step.py's bars (loss 1e-4,
  gradient norms 1e-3, parameters 2e-5 where the gradient is no float
  noise). Both ranks end with the same parameters, bit for bit.
* 'ep': tests/test_torch_moe_step.py's MoE model (4 experts, top-2, every
  RoPE block), each rank holding and running two experts behind
  ``all_to_all_single``;
  the total with its auxiliary terms, the three MoE statistics, the norms
  and the parameters against JAX's MoE step on the mesh, at the same bars.
* under 'tp' the GradNorm update against JAX's, and a Muon step against
  the replicated one.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import linnaeus_tpu.ops.flash_attention as jfa
import linnaeus_tpu.ops.fused_mlp as jfm
from linnaeus_tpu.parallel import mesh as jmesh
from linnaeus_tpu_torch.utils.convert import adamw_moments_from_optax, state_dict_from_jax
from tests import test_torch_dp_step as dp
from tests import test_torch_moe_step as ms
from tests import test_torch_train_step as ts
from tests.test_torch_ranks import run_ranks

MOE_BRIDGE = ms.BRIDGE


@pytest.fixture(autouse=True, scope="module")
def pallas_on_cpu():
    interpret = functools.partial(pl.pallas_call, interpret=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfm.pl, "pallas_call", interpret)
        mp.setattr(jfa.pl, "pallas_call", interpret)
        mp.setattr(jfm, "_FORCE_KERNEL_BWD", True)
        yield


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_ep")
    _, j_state, _, _ = ts._setup()
    params = jax.tree.map(np.asarray, j_state.params)
    payload = {
        "v1": state_dict_from_jax(jax.tree.map(np.asarray, j_state.params), *ts.BRIDGE),
        "moe": state_dict_from_jax(ms.shared_params(), *MOE_BRIDGE),
        "batch": ts._tree(dp._batch(), torch.tensor),
        "draws": dp._draws(dp.STEPS, 1),
        "scalars": ts._scalars("mixed_masked")[1],
    }
    torch.save(payload, d / "inputs.pt")
    return d, params


def tp_ep_body(rank, world, out):
    from linnaeus_tpu_torch.configuration import get_default_config
    from linnaeus_tpu_torch.parallel.mesh import create_mesh

    payload = torch.load(f"{out}/../inputs.pt", weights_only=False)
    cfg = get_default_config()
    cfg.PARALLEL.MESH.MODEL = 2
    mesh = create_mesh(cfg, device_type="cpu")
    assert mesh.shape == {"data": 1, "model": 2}
    from linnaeus_tpu_torch.optim import muon

    out = {"tp": dp._run(payload, mesh, "tp"),
           "ep": dp._run(payload, mesh, "ep", steps=1, moe=ms.MOE),
           "gradnorm": dp._gradnorm(payload, mesh, "tp")}
    muon.NS_DTYPE = torch.float32  # as tests/test_torch_moe_step.py compares Muon
    for mode in ("replicated", "tp"):
        out[f"muon_{mode}"] = dp._run(payload, mesh, mode, steps=1, optimizer="muon")
    return out


@pytest.fixture(scope="module")
def ranks(inputs):
    return run_ranks(__file__, "tp_ep_body", 2, inputs[0], timeout=240)


def test_tensor_parallel_step_matches_the_jax_mesh(ranks):
    j_metrics, j_state = dp._jax_run(1, dp.STEPS)
    for res in ranks:
        got = res["tp"]
        mu, _ = dp._compare(got, j_metrics, j_state)
        dp._params(got, j_state, mu)
    for key, value in ranks[0]["tp"]["model"].items():
        assert torch.equal(value, ranks[1]["tp"]["model"][key]), key
    # each rank holds its share: the split leaves' halves, the rest whole
    total = sum(v.numel() for k, v in ranks[0]["tp"]["model"].items()
                if "running" not in k and "ema" not in k)
    assert ranks[0]["tp"]["held"] == ranks[1]["tp"]["held"] < 0.8 * total


def test_expert_parallel_moe_step_matches_the_jax_mesh(ranks):
    j_step, j_state, _, _ = ms._setup(1)
    mesh = dp._jax_mesh()
    j_batch = jmesh.shard_batch(ts._tree(dp._batch(), jnp.asarray), mesh)
    j_state, j_m = j_step(j_state, j_batch, ts._scalars("mixed_masked")[0])
    j_m = jax.tree.map(np.asarray, j_m)
    mu, _, _ = adamw_moments_from_optax(jax.tree.map(np.asarray, j_state.opt_state), *MOE_BRIDGE)
    want = state_dict_from_jax(jax.tree.map(np.asarray, j_state.params), *MOE_BRIDGE)
    for res in ranks:
        got = res["ep"]
        m = got["metrics"][0]
        for k in ("loss", *ms.MOE_KEYS, *(f"loss/{t}" for t in ts.TASKS)):
            np.testing.assert_allclose(float(m[k]), float(j_m[k]), rtol=0, atol=1e-4, err_msg=k)
        assert 0.0 < float(m["moe_drop_frac"]) < 1.0
        for k in ("grad_norm_pre_clip", "grad_norm_post_clip"):
            np.testing.assert_allclose(float(m[k]), float(j_m[k]), rtol=1e-3, err_msg=k)
        for name, value in want.items():
            real = mu[name].abs() >= (1e-7 if name != "aggregate.bias" else np.inf)
            np.testing.assert_allclose(got["model"][name][real].numpy(), value[real].numpy(),
                                       rtol=0, atol=2e-5, err_msg=name)
        for leaf in ("wi", "bi", "wo", "bo"):  # both ranks' experts trained
            assert float(mu[f"stages.2.0.mlp.{leaf}"].abs().max()) > 0, leaf
        banks = sum(v.numel() for k, v in got["model"].items()
                    if k.rsplit(".", 1)[-1] in ("wi", "bi", "wo", "bo"))
        assert got["held"] == sum(v.numel() for v in got["model"].values()) - banks // 2


def test_gradnorm_and_muon_under_tensor_parallelism(ranks, inputs):
    """The GradNorm update with the trunk split into shares against JAX's
    (the shares' squares summed over the axis); a Muon step (Newton-Schulz
    in float32) orthogonalising each share's whole update, against the
    replicated Muon step on the same mesh."""
    dp.check_gradnorm([("tp", res["gradnorm"]) for res in ranks], inputs[1])
    for res in ranks:
        rep, tp = res["muon_replicated"]["model"], res["muon_tp"]["model"]
        for key, value in rep.items():
            np.testing.assert_allclose(tp[key].numpy(), value.numpy(), rtol=0, atol=2e-6,
                                       err_msg=key)
