"""The port's MoE MLP and an mFormerV1 with MoE blocks against the TPU package's.

Same weights on both sides (seeded numpy, loaded into the Flax tree and,
through ``utils/convert.py::state_dict_from_jax``, into the port), same
inputs (seeded numpy), float32:

* ``MoEMlp``: output within 1e-5 (the TPU package's own bar,
  tests/test_moe.py) and its three statistics, over top-1 and top-2, a
  capacity that drops tokens (0.25) and one that does not (2.0), and a zero
  router, where every probability ties and the lower expert index must come
  first;
* gradients to the input and the five parameters against ``jax.grad``
  within 2e-5 of each gradient's largest value;
* a tiny ``MFormerV1`` with MoE blocks (tests/test_moe.py::tiny_moe_model's
  geometry): logits within 4e-5 (the model bar), with remat 'dots' on and
  off equal bit for bit, statistics and gradients too; the recompute adds no
  second copy of the statistics; router noise draws from the step's
  generator and a checkpointed block draws it again;
* the config form of mFormerV1_sm_moe.yaml at tiny widths against the JAX
  build, and the weight bridge's MoE entries.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linnaeus_tpu.configuration import get_default_config as j_default
from linnaeus_tpu.models import MFormerV1 as JMFormerV1
from linnaeus_tpu.models.blocks.common import Mlp as JMlp
from linnaeus_tpu.models.blocks.moe import MoEMlp as JMoEMlp
from linnaeus_tpu.models.build import build_model as j_build_model
from linnaeus_tpu_torch.configuration import get_default_config as t_default
from linnaeus_tpu_torch.models.blocks.common import Mlp
from linnaeus_tpu_torch.models.blocks.moe import MoEMlp, capacity
from linnaeus_tpu_torch.models.build import build_model
from linnaeus_tpu_torch.models.mformer_v1 import MFormerV1
from linnaeus_tpu_torch.utils.convert import jax_layouts, state_dict_from_jax

TASKS = ("taxa_L10", "taxa_L20")
NUM_CLASSES = {"taxa_L10": 6, "taxa_L20": 3}
META = (("TEMPORAL", 2), ("SPATIAL", 3))
MLP_ATOL = 1e-5
GRAD_RTOL = 2e-5
MODEL_ATOL = 4e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def moe_pair(B, N, D, F, E, top_k, capacity_factor, router="seeded", seed=0, **kw):
    """(x, the JAX module, its params, the port module holding them)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    jm = JMoEMlp(dim=D, hidden_features=F, num_experts=E, top_k=top_k,
                 capacity_factor=capacity_factor, **kw)
    params = _np_tree(jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    params = {k: (0.5 * rng.normal(size=v.shape)).astype(np.float32) for k, v in params.items()}
    if router == "zero":
        params["router"] = np.zeros_like(params["router"])
    tm = MoEMlp(D, F, num_experts=E, top_k=top_k, capacity_factor=capacity_factor, **kw)
    tm.load_state_dict({k: torch.tensor(v) for k, v in params.items()}, strict=True)
    return x, jm, params, tm


def jax_apply(jm, params, x):
    y, inter = jm.apply({"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(x),
                        mutable=["intermediates"])
    inter = inter["intermediates"]
    return y, {k: inter[k][0] for k in ("moe_aux_loss", "moe_z_loss", "moe_drop_frac")}


CASES = [(k, cf, router) for k in (1, 2) for cf in (0.25, 2.0) for router in ("seeded", "zero")]


@pytest.mark.parametrize("top_k, capacity_factor, router", CASES)
def test_moe_mlp_matches_jax(top_k, capacity_factor, router):
    x, jm, params, tm = moe_pair(2, 16, 8, 16, 4, top_k, capacity_factor, router)
    jy, js = jax_apply(jm, params, x)
    with torch.no_grad():
        ty, ts = tm(torch.tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=MLP_ATOL)
    np.testing.assert_allclose(float(ts.aux), float(js["moe_aux_loss"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(ts.z), float(js["moe_z_loss"]), rtol=1e-6, atol=1e-6)
    assert float(ts.drop_frac) == pytest.approx(float(js["moe_drop_frac"]), abs=1e-7)
    if capacity_factor < 1.0:
        assert 0.0 < float(ts.drop_frac) < 1.0
    elif router == "seeded":
        assert float(ts.drop_frac) == 0.0
    if router == "zero":
        assert float(ts.aux) == pytest.approx(1.0, abs=1e-6)  # uniform routing


def test_zero_router_ties_go_to_the_lower_expert_index():
    """Every probability ties: each token picks experts 0..k-1, so with
    capacity for only half the tokens the later half is dropped, as
    ``jax.lax.top_k`` orders it."""
    from linnaeus_tpu_torch.models.blocks.moe import route

    probs, gates, experts, slots, keep = route(torch.zeros(2, 8, 4), 2, 4)
    assert experts[..., 0].eq(0).all() and experts[..., 1].eq(1).all()
    assert torch.equal(slots[0, :, 0], torch.arange(8))
    assert keep[:, :4].all() and not keep[:, 4:].any()
    assert torch.allclose(gates, torch.full_like(gates, 0.5))
    assert capacity(8, 4, 2, 1.0) == 4 and capacity(580, 8, 2, 1.25) == 182
    assert capacity(148, 8, 2, 1.25) == 47


@pytest.mark.parametrize("top_k, capacity_factor", [(1, 2.0), (2, 2.0), (2, 0.25)])
def test_moe_mlp_gradients_match_jax(top_k, capacity_factor):
    x, jm, params, tm = moe_pair(2, 12, 8, 16, 4, top_k, capacity_factor, seed=3)
    proj = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, s = jax_apply(jm, p, xx)
        return jnp.sum(y * proj) + s["moe_aux_loss"] + 0.1 * s["moe_z_loss"]

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y, s = tm(xt)
    ((y * torch.tensor(proj)).sum() + s.aux + 0.1 * s.z).backward()
    pairs = [("x", xt.grad, jgx)] + [(n, getattr(tm, n).grad, jg[n])
                                     for n in ("router", "wi", "bi", "wo", "bo")]
    for name, got, want in pairs:
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GRAD_RTOL * scale,
                                   err_msg=name)


def test_identical_experts_equal_the_dense_mlp():
    """Every expert holding the dense MLP and no drops: the routed output is
    the dense MLP's (the gates sum to one)."""
    torch.manual_seed(0)
    dense, moe = Mlp(16, 32, 16), MoEMlp(16, 32, num_experts=4, top_k=2, capacity_factor=4.0)
    with torch.no_grad():
        moe.wi.copy_(dense.fc1.weight.t().expand_as(moe.wi))
        moe.bi.copy_(dense.fc1.bias.expand_as(moe.bi))
        moe.wo.copy_(dense.fc2.weight.t().expand_as(moe.wo))
        moe.bo.copy_(dense.fc2.bias.expand_as(moe.bo))
        x = torch.randn(4, 12, 16)
        y, stats = moe(x)
        np.testing.assert_allclose(y.numpy(), dense(x).numpy(), rtol=0, atol=1e-5)
    assert float(stats.drop_frac) == 0.0


def test_moe_mlp_dropout_and_noise_act_in_training_only():
    """MODEL.DROP_RATE reaches the experts and router noise moves the
    routing, both in training mode only, drawn from the given generator."""
    torch.manual_seed(0)
    moe = MoEMlp(16, 32, num_experts=4, top_k=2, capacity_factor=4.0, drop=0.5, noise_std=8.0)
    x = torch.randn(2, 8, 16)
    with torch.no_grad():
        det = moe.eval()(x)[0]
        assert torch.equal(det, moe(x)[0])
        moe.train()
        for m in moe.modules():
            if hasattr(m, "generator"):
                m.generator = torch.Generator().manual_seed(5)
        tr1 = moe(x)[0]
        for m in moe.modules():
            if hasattr(m, "generator"):
                m.generator = torch.Generator().manual_seed(5)
        assert torch.equal(tr1, moe(x)[0])
        assert not torch.allclose(det, tr1) and not torch.allclose(tr1, moe(x)[0])


# ------------------------------------------------------------- the model


def tiny_kw(every_n=1, num_experts=4, top_k=2, capacity_factor=2.0):
    """tests/test_moe.py::tiny_moe_model's geometry."""
    return dict(img_size=(32, 32), convnext_depths=(1, 1, 1, 1), convnext_dims=(8, 16, 32, 64),
                rope_depths=(2, 1), rope_dims=(32, 64), rope_num_heads=(2, 2),
                drop_path_rate=0.0, moe_num_experts=num_experts, moe_top_k=top_k,
                moe_capacity_factor=capacity_factor, moe_every_n=every_n,
                meta_components=META, task_keys=TASKS, num_classes=NUM_CLASSES)


def tiny_pair(seed=0, **kw):
    """(JAX model, params with seeded noise, the port model holding them)."""
    jm = JMFormerV1(**tiny_kw(**kw), head_configs={t: {"TYPE": "Linear"} for t in TASKS})
    params = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.zeros((2, 32, 32, 3)),
                                       jnp.zeros((2, 5)))["params"])
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params)
    tm = MFormerV1(**tiny_kw(**kw))
    tm.load_state_dict(state_dict_from_jax(params, (1, 1), (2, 1), ("TEMPORAL", "SPATIAL"),
                                           TASKS), strict=True)
    return jm, params, tm


def tiny_inputs(seed=2, b=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 32, 32, 3)).astype(np.float32),
            rng.normal(size=(b, 5)).astype(np.float32))


@pytest.mark.parametrize("every_n", [1, 2])
def test_mformer_v1_with_moe_matches_jax(every_n):
    jm, params, tm = tiny_pair(every_n=every_n)
    ours = [(s + 1, j) for s in (2, 3) for j, b in enumerate(tm.stages[s]) if b.use_moe]
    theirs = [(s, j) for s, depth in ((3, 2), (4, 1)) for j in range(depth)
              if "router" in params[f"stage{s}_block{j}"]["mlp"]]
    # V-MoE placement: every n-th block of each RoPE stage, as in the TPU package
    assert ours == theirs == ([(3, 0), (3, 1), (4, 0)] if every_n == 1 else [(3, 1)])
    x, aux = tiny_inputs()
    want, inter = jax.jit(functools.partial(jm.apply, mutable=["intermediates"]))(
        {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(x), jnp.asarray(aux))
    with torch.no_grad():
        got, stats = tm.eval()(torch.tensor(x), torch.tensor(aux), moe_stats=True)
    for t in TASKS:
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]), rtol=0, atol=MODEL_ATOL)
    from linnaeus_tpu.train.step import _collect_moe_stats

    jstats = _collect_moe_stats(inter["intermediates"])
    for k in ("moe_aux", "moe_z", "moe_drop_frac"):
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-5, atol=1e-6)
    # without the flag the forward is the serving one: logits alone
    with torch.no_grad():
        plain = tm(torch.tensor(x), torch.tensor(aux))
    assert all(torch.equal(plain[t], got[t]) for t in TASKS)


def _train_forward(tm, x, aux, remat):
    tm.train()
    tm.gradient_checkpointing, tm.remat_policy = remat, "dots"
    tm.zero_grad(set_to_none=True)
    out, stats = tm(torch.tensor(x), torch.tensor(aux), moe_stats=True)
    loss = sum(v.square().mean() for v in out.values()) + 0.01 * stats["moe_aux"] \
        + 0.001 * stats["moe_z"]
    loss.backward()
    return out, stats, {n: p.grad.clone() for n, p in tm.named_parameters()}


def test_remat_dots_leaves_logits_statistics_and_gradients_unchanged():
    jm, params, tm = tiny_pair(every_n=1)
    x, aux = tiny_inputs(seed=5)
    calls = []
    for blk in tm.modules():
        if isinstance(blk, MoEMlp):
            # a pre-hook: the recompute stops once it has what the backward
            # needs, which may be before a forward hook would run
            blk.register_forward_pre_hook(lambda m, a: calls.append(1))
    off = _train_forward(tm, x, aux, remat=False)
    n_off = len(calls)
    on = _train_forward(tm, x, aux, remat=True)
    assert n_off == 3 and len(calls) - n_off == 6  # the recompute ran each MoE layer again
    for t in TASKS:
        assert torch.equal(off[0][t], on[0][t]), t
    for k in ("moe_aux", "moe_z", "moe_drop_frac"):
        assert torch.equal(off[1][k], on[1][k]), k
    for n in off[2]:
        assert torch.equal(off[2][n], on[2][n]), n
    assert float(off[2]["stages.2.0.mlp.router"].abs().sum()) > 0
    # the logits agree with the TPU package's training-mode forward
    want = jax.jit(functools.partial(jm.apply, deterministic=False))(
        {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(x), jnp.asarray(aux),
        rngs={"dropout": jax.random.PRNGKey(0)})
    for t in TASKS:
        np.testing.assert_allclose(on[0][t].detach().numpy(), np.asarray(want[t]), rtol=0,
                                   atol=MODEL_ATOL)


def test_router_noise_is_drawn_again_by_a_checkpointed_block():
    """With NOISE_STD > 0 the routing is random in training: a checkpointed
    block's recompute must draw the noise of the first forward (else its
    saved products would not fit the graph), so the gradients are the same
    with and without remat, from the step's generator."""
    from linnaeus_tpu_torch.train.state import create_train_state

    kw = tiny_kw(every_n=1)
    kw["moe_noise_std"] = 4.0
    results = []
    for remat in (False, True):
        tm = MFormerV1(**kw, seed=3)
        create_train_state(tm, torch.optim.SGD(tm.parameters(), lr=0.1), 2,
                           torch.Generator().manual_seed(9))
        assert all(m.generator is not None for m in tm.modules() if isinstance(m, MoEMlp))
        results.append(_train_forward(tm, *tiny_inputs(seed=6), remat=remat))
    for n, g in results[0][2].items():
        assert torch.equal(g, results[1][2][n]), n
    tm.eval()
    with torch.no_grad():
        a = tm(*map(torch.tensor, tiny_inputs(seed=6)))
        b = tm(*map(torch.tensor, tiny_inputs(seed=6)))
    assert all(torch.equal(a[t], b[t]) for t in TASKS)


def test_pipeline_with_moe_raises_as_in_jax():
    with pytest.raises(ValueError, match="uniform tower blocks"):
        MFormerV1(**tiny_kw(), pipeline_stages=2)


def _configs(**moe):
    """(JAX config, port config): mFormerV1_sm_moe.yaml's MODEL.MOE over the
    tiny geometry."""
    import yaml

    with open("configs/model/archs/mFormerV1_sm_moe.yaml") as fh:
        preset = yaml.safe_load(fh)["MODEL"]["MOE"]
    out = []
    for cfg in (j_default(), t_default()):
        cfg.defrost()
        cfg.MODEL.TYPE = "mFormerV1"
        cfg.MODEL.IMG_SIZE = 64
        cfg.MODEL.CONVNEXT_STAGES.DEPTHS = [1, 1, 1, 1]
        cfg.MODEL.CONVNEXT_STAGES.DIMS = [8, 16, 32, 64]
        cfg.MODEL.ROPE_STAGES.DEPTHS = [4, 2]
        cfg.MODEL.ROPE_STAGES.DIMS = [32, 64]
        cfg.MODEL.ROPE_STAGES.NUM_HEADS = [2, 2]
        cfg.MODEL.ROPE_STAGES.MLP_RATIO = [4.0, 4.0]
        cfg.DATA.TASK_KEYS_H5 = list(TASKS)
        cfg.TRAIN.MIXED_PRECISION.ENABLED = False
        cfg.TRAIN.AMP_OPT_LEVEL = "O0"
        for k, v in {**preset, **moe}.items():
            cfg.MODEL.MOE[k] = v
        out.append(cfg)
    return out


def test_config_form_builds_the_preset_as_jax_does():
    jcfg, tcfg = _configs()
    assert tcfg.MODEL.MOE.NUM_EXPERTS == 8 and tcfg.MODEL.MOE.TOP_K == 2
    jm = j_build_model(jcfg, NUM_CLASSES)
    tm = build_model(tcfg, NUM_CLASSES, device="cpu")
    params = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                       jnp.zeros((1, 5)))["params"])
    sd = state_dict_from_jax(params, (1, 1), (4, 2), ("TEMPORAL", "SPATIAL"), TASKS)
    assert set(sd) == set(tm.state_dict())
    # every 2nd block: stage 3 blocks 1 and 3, stage 4 block 1
    assert sorted(k for k in sd if k.endswith(".router")) == [
        "stages.2.1.mlp.router", "stages.2.3.mlp.router", "stages.3.1.mlp.router"]
    assert tuple(sd["stages.2.1.mlp.wi"].shape) == (8, 32, 128)
    tm.load_state_dict(sd, strict=True)
    x, aux = np.random.default_rng(7).normal(size=(2, 64, 64, 3)).astype(np.float32), None
    want = jax.jit(jm.apply)({"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(x),
                             None)
    with torch.no_grad():
        got = tm(torch.tensor(x), aux)
    for t in TASKS:
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]), rtol=0, atol=MODEL_ATOL)
    # the Flax path and layout of each bank, for the filters and Muon
    layouts = jax_layouts(tm)
    assert layouts["stages.2.1.mlp.wi"].path == "stage3_block1/mlp/wi"
    w = tm.stages[2][1].mlp.wi
    assert layouts["stages.2.1.mlp.wi"].to_jax(w) is w
    assert layouts["stages.2.0.mlp.fc1.weight"].path == "stage3_block0/mlp/Dense_0/kernel"


def test_config_form_refuses_moe_on_mformer_v0():
    cfg = t_default()
    cfg.defrost()
    cfg.MODEL.TYPE = "mFormerV0"
    cfg.MODEL.MOE.ENABLED = True
    cfg.DATA.TASK_KEYS_H5 = ["taxa_L10"]
    with pytest.raises(ValueError, match="MOE"):
        build_model(cfg, {"taxa_L10": 4}, device="cpu")


def test_moe_weights_through_a_dense_mlp_jax_reference():
    """The upcycling identity on the JAX side and the port's: identical
    experts with ample capacity give the dense MLP of the TPU package."""
    B, N, D, F, E = 3, 10, 8, 16, 4
    x = np.random.default_rng(8).normal(size=(B, N, D)).astype(np.float32)
    dense = JMlp(hidden_features=F, out_features=D)
    dv = _np_tree(dense.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"])
    moe = MoEMlp(D, F, num_experts=E, top_k=2, capacity_factor=float(E))
    with torch.no_grad():
        moe.wi.copy_(torch.tensor(dv["Dense_0"]["kernel"]).expand_as(moe.wi))
        moe.bi.copy_(torch.tensor(dv["Dense_0"]["bias"]).expand_as(moe.bi))
        moe.wo.copy_(torch.tensor(dv["Dense_1"]["kernel"]).expand_as(moe.wo))
        moe.bo.copy_(torch.tensor(dv["Dense_1"]["bias"]).expand_as(moe.bo))
        y, _ = moe(torch.tensor(x))
    want = dense.apply({"params": dv}, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=0, atol=MLP_ATOL)



def test_profile_step_sums_kernels_by_name_against_the_dense_step():
    """tools/profile_step.py's table against the dense step: rows whose
    shortened names coincide are summed, not overwritten."""
    from linnaeus_tpu_torch.tools.profile_step import is_gemm, versus_dense

    moe = [{"name": "k", "ms_per_step": 1.0, "launches_per_step": 2.0},
           {"name": "k", "ms_per_step": 0.5, "launches_per_step": 1.0},
           {"name": "sort", "ms_per_step": 0.2, "launches_per_step": 3.0}]
    dense = [{"name": "k", "ms_per_step": 1.0, "launches_per_step": 2.0}]
    rows = {r["name"]: r for r in versus_dense(moe, dense)}
    assert rows["k"]["delta_ms"] == 0.5 and rows["k"]["moe_launches"] == 3.0
    assert rows["sort"]["delta_ms"] == 0.2 and rows["sort"]["dense_ms"] == 0.0
    assert is_gemm("nvjet_tst_192x192_64x3_2x1_v_badd_coopB_NNN")
    assert not is_gemm("void at::native::radixSortKVInPlace<2, -1, 16, 2, float, long>")
