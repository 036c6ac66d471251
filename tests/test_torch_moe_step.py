"""The port's train step with MoE blocks against the TPU package's.

mFormerV1 at test_torch_train_step.py's narrow geometry (64 px, metadata
TEMPORAL(2) + SPATIAL(3)) with 4 experts, top-2, capacity factor 1.25 on
every RoPE block (three MoE layers; stage 3 holds 19 tokens, so C = 12 and
some choices drop), the same weights and batch on both sides, float32, the
JAX step's own draws handed to the port's step. Against JAX's
``make_train_step``: the total with the weighted auxiliary terms, the
three statistics and the parameters after the update, at accumulation 1
and 2, to test_torch_train_step.py's bars. Then the step built from a
config (train/build.py) with ``ROUTER_Z_LOSS_WEIGHT`` non-zero against the
JAX Trainer's wiring of the same weights; AdamW skipping the expert biases
by name; and one Muon step on the banks against JAX's.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax.experimental import pallas as pl

import linnaeus_tpu.data.collate as jc
import linnaeus_tpu.ops.flash_attention as jfa
import linnaeus_tpu.ops.fused_mlp as jfm
import linnaeus_tpu.train.step as jstep
from linnaeus_tpu.loss import soft_target_cross_entropy as j_stce
from linnaeus_tpu.models import MFormerV1 as JMFormerV1
from linnaeus_tpu.optim import build as j_build
from linnaeus_tpu.optim import schedules as j_sched
from linnaeus_tpu.optim.muon import muon as j_muon
from linnaeus_tpu.train.state import create_train_state as j_create_state
from linnaeus_tpu_torch.data import collate as tc
from linnaeus_tpu_torch.loss import soft_target_cross_entropy as t_stce
from linnaeus_tpu_torch.models.build import build_model
from linnaeus_tpu_torch.optim import build as t_build
from linnaeus_tpu_torch.optim import muon as t_muon
from linnaeus_tpu_torch.optim.build import build_optimizer
from linnaeus_tpu_torch.optim.schedules import build_schedule
from linnaeus_tpu_torch.train.state import create_train_state
from linnaeus_tpu_torch.train.step import MOE_KEYS, ScheduleScalars, make_train_step
from linnaeus_tpu_torch.utils.convert import (
    adamw_moments_from_optax,
    jax_layouts,
    state_dict_from_jax,
)
from tests.test_torch_train_step import (
    B,
    BOUNDS,
    DEPTHS,
    DIMS,
    IMG,
    META,
    NC,
    ROPE_DEPTHS,
    SEED_KEY,
    SPEC,
    TASKS,
    _batch,
    _configs,
    _scalars,
    _tree,
    step_draws,
)

BRIDGE = (DEPTHS[:2], ROPE_DEPTHS, ("TEMPORAL", "SPATIAL"), TASKS)
MOE = {"NUM_EXPERTS": 4, "TOP_K": 2, "CAPACITY_FACTOR": 1.25, "EVERY_N": 1}
AUX_W, Z_W = 0.01, 0.001


@pytest.fixture(autouse=True)
def pallas_on_cpu(monkeypatch):
    interpret = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(jfm.pl, "pallas_call", interpret)
    monkeypatch.setattr(jfa.pl, "pallas_call", interpret)


def jax_model():
    return JMFormerV1(
        img_size=(IMG, IMG), convnext_depths=DEPTHS, convnext_dims=DIMS,
        rope_depths=ROPE_DEPTHS, rope_dims=(32, 64), rope_num_heads=(2, 2),
        drop_path_rate=0.0, meta_components=META, task_keys=TASKS, num_classes=NC,
        head_configs={t: {"TYPE": "Linear"} for t in TASKS}, use_flash_attn=True,
        fused_convnext_mlp=True, moe_num_experts=MOE["NUM_EXPERTS"], moe_top_k=MOE["TOP_K"],
        moe_capacity_factor=MOE["CAPACITY_FACTOR"], moe_every_n=MOE["EVERY_N"],
    )


@functools.cache
def shared_params():
    """The JAX init with seeded noise, as numpy."""
    params = jax.jit(jax_model().init)(jax.random.PRNGKey(0), jnp.zeros((2, IMG, IMG, 3)),
                                       jnp.zeros((2, 5)))["params"]
    rng = np.random.default_rng(1)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params)


def port_model():
    model = build_model(dict(SPEC, MOE=MOE), IMG, NC, META, use_flash_attn=True,
                        fused_convnext_mlp=True, device="cpu")
    model.load_state_dict(state_dict_from_jax(shared_params(), *BRIDGE), strict=True)
    return model


def _setup(accum):
    params = shared_params()
    jcfg, cfg = _configs()
    j_schedule = j_sched.build_schedule(jcfg, 100)
    j_state = j_create_state(jax_model(), jax.tree.map(jnp.asarray, params),
                             j_build.build_optimizer(jcfg, j_schedule), num_tasks=2,
                             rng=jax.random.PRNGKey(SEED_KEY))
    mix = {"chunk_bounds": BOUNDS}
    j_step = jax.jit(jstep.make_train_step(
        {t: j_stce for t in TASKS}, TASKS, jc.MixConfig(**mix), clip_grad=5.0,
        accumulation_steps=accum, lr_schedule=j_schedule, moe_aux_weight=AUX_W,
        moe_z_weight=Z_W))
    model = port_model()
    schedule = build_schedule(cfg, 100)
    t_state = create_train_state(model, build_optimizer(cfg, schedule, model), num_tasks=2,
                                 generator=torch.Generator().manual_seed(0), lr_schedule=schedule)
    t_step = make_train_step(
        {t: t_stce for t in TASKS}, TASKS, tc.MixConfig(**mix), clip_grad=5.0,
        accumulation_steps=accum, lr_schedule=schedule, moe_aux_weight=AUX_W, moe_z_weight=Z_W)
    return j_step, j_state, t_step, t_state


@pytest.mark.parametrize("accum", [1, 2])
def test_moe_train_step_matches_jax(accum):
    j_step, j_state, t_step, t_state = _setup(accum)
    batch = _batch()
    j_scalars, t_scalars = _scalars("mixed_masked" if accum == 1 else "plain")
    cfg = jc.MixConfig(chunk_bounds=BOUNDS)
    draws = (step_draws(0, cfg) if accum == 1
             else [step_draws(0, cfg, micro=i, rows=B // accum) for i in range(accum)])
    j_state, j_m = j_step(j_state, _tree(batch, jnp.asarray), j_scalars)
    t_state, t_m = t_step(t_state, _tree(batch, torch.tensor), t_scalars, draws=draws)

    assert set(t_m) == set(j_m) and set(MOE_KEYS) <= set(t_m)
    for k in ("loss", *MOE_KEYS, *(f"loss/{t}" for t in TASKS)):
        np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), rtol=0, atol=1e-4, err_msg=k)
    assert 0.0 < float(t_m["moe_drop_frac"]) < 1.0  # capacity 1.25 drops some choices
    # the reported loss is the optimised total, which JAX's includes the
    # weighted auxiliary terms in: they are ten times the bar above
    assert AUX_W * float(t_m["moe_aux"]) + Z_W * float(t_m["moe_z"]) > 1e-3
    for k in ("grad_norm_pre_clip", "grad_norm_post_clip"):
        np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), rtol=1e-3, err_msg=k)

    mu, _, count = adamw_moments_from_optax(jax.tree.map(np.asarray, j_state.opt_state), *BRIDGE)
    want = state_dict_from_jax(jax.tree.map(np.asarray, j_state.params), *BRIDGE)
    assert count == 1
    mu_scale = max(float(v.abs().max()) for v in mu.values())
    for name, p in t_state.model.named_parameters():
        got_mu = t_state.optimizer.state[p]["exp_avg"]
        np.testing.assert_allclose(got_mu.numpy(), mu[name].numpy(), rtol=0,
                                   atol=1e-4 * mu_scale, err_msg=f"exp_avg {name}")
        # elsewhere AdamW steps on float noise: below 1e-7, and the
        # aggregate's bias, a constant shift that final_norm removes (its
        # gradient is zero but for rounding, 2e-7 here)
        real = mu[name].abs() >= (1e-7 if name != "aggregate.bias" else np.inf)
        np.testing.assert_allclose(p.detach()[real].numpy(), want[name][real].numpy(),
                                   rtol=0, atol=2e-5, err_msg=name)
    for leaf in ("router", "wi", "bi", "wo", "bo"):  # every bank leaf trained
        assert float(mu[f"stages.2.0.mlp.{leaf}"].abs().max()) > 0, leaf


def _tiny_configs():
    from tests.test_torch_moe import _configs as moe_configs

    jcfg, tcfg = moe_configs()
    for cfg in (jcfg, tcfg):
        cfg.MODEL.IMG_SIZE = IMG
        cfg.MODEL.ROPE_STAGES.DEPTHS = list(ROPE_DEPTHS)
        cfg.MODEL.CONVNEXT_STAGES.DEPTHS = list(DEPTHS)
        cfg.MODEL.MOE.NUM_EXPERTS = 4
        cfg.MODEL.MOE.EVERY_N = 1
        cfg.MODEL.DROP_PATH_RATE = 0.0
        cfg.MODEL.USE_FLASH_ATTN = True
        cfg.AUG.SINGLE_AUG_DEVICE = "cpu"  # no on-device augmentation in the step
        cfg.LOSS.GRAD_WEIGHTING.TASK.TYPE = "static"
        cfg.TRAIN.CLIP_GRAD = 5.0
        cfg.DATA.META.COMPONENTS.TEMPORAL.ENABLED = True
        cfg.DATA.META.COMPONENTS.TEMPORAL.DIM = 2
        cfg.DATA.META.COMPONENTS.SPATIAL.ENABLED = True
        cfg.DATA.META.COMPONENTS.SPATIAL.DIM = 3
        cfg.DATA.META.COMPONENTS.ELEVATION.ENABLED = False
    assert tcfg.MODEL.MOE.ROUTER_Z_LOSS_WEIGHT == 0.001
    return jcfg, tcfg


def test_config_built_step_carries_the_router_z_loss():
    """train/build.py's step optimises what the JAX Trainer's does: the
    load-balance term and the router z-loss term (ROUTER_Z_LOSS_WEIGHT) on
    top of the task losses. Without the z term the total would miss
    0.001 * z, about 2e-3 here."""
    from linnaeus_tpu.loss.utils import prepare_loss_functions as j_prepare
    from linnaeus_tpu.models.build import build_model as j_build_model
    from linnaeus_tpu_torch.train.build import build_training

    jcfg, tcfg = _tiny_configs()
    jm = j_build_model(jcfg, NC)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(3), jnp.zeros((2, IMG, IMG, 3)), jnp.zeros((2, 5)))["params"])
    j_crit = j_prepare(jcfg, NC, None)[0]
    j_step = jax.jit(jstep.make_train_step(
        j_crit, TASKS, jc.MixConfig(chunk_bounds=BOUNDS), clip_grad=5.0,
        moe_aux_weight=float(jcfg.MODEL.MOE.AUX_LOSS_WEIGHT),
        moe_z_weight=float(jcfg.MODEL.MOE.ROUTER_Z_LOSS_WEIGHT)))
    j_state = j_create_state(jm, jax.tree.map(jnp.asarray, params), optax.sgd(0.0), num_tasks=2,
                             rng=jax.random.PRNGKey(SEED_KEY))
    parts = build_training(tcfg, NC, device="cpu", seed=0, total_steps=100)
    parts.model.load_state_dict(state_dict_from_jax(params, *BRIDGE), strict=True)
    batch = _batch()
    j_scalars, t_scalars = _scalars("plain")
    _, j_m = j_step(j_state, _tree(batch, jnp.asarray), j_scalars)
    _, t_m = parts.train_step(parts.state, _tree(batch, torch.tensor), t_scalars,
                              draws=step_draws(0, jc.MixConfig(chunk_bounds=BOUNDS)))
    for k in ("loss", *MOE_KEYS):
        np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), rtol=0, atol=1e-4, err_msg=k)
    assert Z_W * float(t_m["moe_z"]) > 1e-3  # what the step would drop without the repair


def test_adamw_skips_the_expert_biases_by_name():
    """The decoupled-decay mask against the TPU package's on the same tree:
    the 2-D ``bi`` and ``bo`` are biases and take no decay, the banks and the
    router do."""
    model = port_model()
    mask = t_build._no_decay_mask(model.named_parameters())
    j_mask = flatten_dict(j_build._no_decay_mask(shared_params()), sep="/")
    layouts = jax_layouts(model)
    assert {layouts[n].path: v for n, v in mask.items()} == j_mask
    assert mask["stages.2.0.mlp.wi"] and mask["stages.2.0.mlp.router"]
    assert not mask["stages.2.0.mlp.bi"] and not mask["stages.2.0.mlp.bo"]
    assert model.stages[2][0].mlp.bi.dim() == 2


@pytest.fixture
def ns_in_float32(monkeypatch):
    from tests.test_torch_optim import _JnpInFloat32

    monkeypatch.setattr(sys.modules["linnaeus_tpu.optim.muon"], "jnp", _JnpInFloat32())
    monkeypatch.setattr(t_muon, "NS_DTYPE", torch.float32)


def test_muon_step_on_the_banks_matches_jax(ns_in_float32):
    """One Muon update (Newton-Schulz in float32 on both sides) of every MoE
    leaf: each 3-D bank is orthogonalised as its (E, D F) flattening, the
    2-D ``bi`` / ``bo`` and the router as they are."""
    params = {k: v for k, v in shared_params()["stage3_block0"]["mlp"].items()}
    rng = np.random.default_rng(5)
    grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
    tx = j_muon(0.02, momentum=0.95, nesterov=True, ns_steps=5, apply_scaling=True)
    j_params = jax.tree.map(jnp.asarray, params)
    upd, _ = tx.update(jax.tree.map(jnp.asarray, grads), tx.init(j_params), j_params)
    want = optax.apply_updates(j_params, upd)
    model = port_model()
    mlp = model.stages[2][0].mlp
    views = jax_layouts(model)
    named = {f"stages.2.0.mlp.{k}": getattr(mlp, k) for k in params}
    opt = t_muon.Muon(list(named.values()), lr=0.02, momentum=0.95, nesterov=True,
                      layouts={p: (views[n].to_jax, views[n].from_jax) for n, p in named.items()})
    for n, p in named.items():
        p.grad = torch.tensor(grads[n.rsplit(".", 1)[-1]])
    opt.step()
    for n, p in named.items():
        leaf = n.rsplit(".", 1)[-1]
        delta, want_delta = p.detach().numpy() - params[leaf], np.asarray(want[leaf]) - params[leaf]
        assert np.abs(want_delta).max() > 0
        np.testing.assert_allclose(delta, want_delta, rtol=0,
                                   atol=1e-4 * np.abs(want_delta).max(), err_msg=n)
