"""The port's schedule and optimizers against the TPU package's.

The cosine schedule with its linear warm-up is held against the optax
schedule step by step (optax computes it in float32, the port in Python
floats: 1e-6 relative plus 2e-11, a float32 step of the base rate, which the
warm-up's first value loses to cancellation in optax). One AdamW update on shared parameters and shared
gradients (seeded numpy) is held against optax parameter by parameter,
through the weight bridge, with the moments compared as well. Three
updates of SGD (Nesterov, masked decay), AdEMAMix (with and without its
alpha / beta3 warm-up) and multi-group AdamW (a heads group at 10x the rate
with its own decay, a no-decay group) on the same gradients agree with the
TPU package's optax chains to 1e-6 on every parameter. Muon's updates
agree with the TPU package's within 1e-4 of each tensor's largest update
with the Newton-Schulz iteration in float32 on both sides, and within 0.25
in its bfloat16, which XLA and torch round at other places; they agree only
because the port orthogonalises the Flax layout of each gradient (the
torch layout of a Linear scales it otherwise, and that of a convolution
flattens it into another matrix altogether).
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from linnaeus_tpu.configuration.defaults import get_default_config
from linnaeus_tpu.models import MFormerV1 as JMFormerV1
from linnaeus_tpu.optim import build as j_build
from linnaeus_tpu.optim.muon import muon as j_muon
from linnaeus_tpu.optim.muon import zeropower_via_newtonschulz5 as j_zeropower
from linnaeus_tpu.optim import schedules as j_sched
from linnaeus_tpu_torch.configuration.train_presets import ConfigNode, train_preset
from linnaeus_tpu_torch.models.build import build_model
from linnaeus_tpu_torch import configuration as tconf
from linnaeus_tpu_torch.optim import build as t_build
from linnaeus_tpu_torch.optim import muon as t_muon
from linnaeus_tpu_torch.optim import schedules as t_sched
from linnaeus_tpu_torch.utils.convert import (
    adamw_moments_from_optax,
    jax_layouts,
    state_dict_from_jax,
)

TASKS = ("taxa_L10", "taxa_L20")
NC = {"taxa_L10": 7, "taxa_L20": 3}
META = (("TEMPORAL", 2), ("SPATIAL", 3))
DEPTHS, ROPE_DEPTHS = (1, 1, 1, 1), (1, 1)
SPEC = {
    "CONVNEXT": {"DEPTHS": list(DEPTHS), "DIMS": [8, 16, 32, 64]},
    "ROPE": {"DEPTHS": list(ROPE_DEPTHS), "DIMS": [32, 64], "NUM_HEADS": [2, 2]},
    "DROP_PATH_RATE": 0.0,
}
BRIDGE = (DEPTHS, ROPE_DEPTHS, ("TEMPORAL", "SPATIAL"), TASKS)


def _jax_config():
    cfg = get_default_config()
    cfg.defrost()
    preset = train_preset()
    for section in ("OPTIMIZER", "LR_SCHEDULER"):
        for k, v in preset[section].items():
            if k != "PARAMETER_GROUPS":
                cfg[section][k] = v
    return cfg


@pytest.mark.parametrize("total,warmup", [(920, 150), (50, 0), (100, 100), (10, 25)])
def test_cosine_schedule_matches_optax(total, warmup):
    want = j_sched.cosine_schedule(1.5e-4, 1.5e-5, total, warmup, 5e-7)
    got = t_sched.cosine_schedule(1.5e-4, 1.5e-5, total, warmup, 5e-7)
    for step in list(range(0, total + 30, 7)) + [warmup - 1, warmup, warmup + 1, total]:
        step = max(step, 0)
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=2e-11,
                                   err_msg=str(step))


def test_build_schedule_and_warmup_precedence_match_jax():
    jcfg, cfg = _jax_config(), train_preset()
    want, got = j_sched.build_schedule(jcfg, 920, 115), t_sched.build_schedule(cfg, 920, 115)
    for step in (0, 1, 149, 150, 151, 500, 919, 2000):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=2e-11)
    for frac, epochs, steps in ((0.1, 2, 7), (None, 2, 7), (None, 0, 7), (0.0, 0, 0)):
        for c in (jcfg, cfg):
            c.LR_SCHEDULER.WARMUP_FRACTION = frac
            c.LR_SCHEDULER.WARMUP_EPOCHS = epochs
            c.LR_SCHEDULER.WARMUP_STEPS = steps
        assert (t_sched.resolve_warmup_steps(cfg, 920, 115)
                == j_sched.resolve_warmup_steps(jcfg, 920, 115))
    assert t_sched._warmup(got, 0, 0.0, 1.0) is got


def test_apply_lr_scaling_matches_jax():
    jcfg, cfg = _jax_config(), train_preset()
    assert t_sched.apply_lr_scaling(cfg, 256) == pytest.approx(j_sched.apply_lr_scaling(jcfg, 256))
    assert cfg.LR_SCHEDULER.BASE_LR == pytest.approx(float(jcfg.LR_SCHEDULER.BASE_LR))
    assert cfg.LR_SCHEDULER.LR_SCALING_FACTOR == pytest.approx(4.0)


@pytest.mark.parametrize("name", ["linear", "step", "wsd"])
def test_unported_schedules_raise(name):
    """Once unported, linear, step and wsd now build from the config and
    give optax's values (tests/test_torch_schedules.py holds every step);
    an unknown name still raises."""
    cfg, jcfg = train_preset(), _jax_config()
    for c in (cfg, jcfg):
        c.LR_SCHEDULER.NAME = name
    got, want = t_sched.build_schedule(cfg, 100), j_sched.build_schedule(jcfg, 100)
    for step in (0, 50, 99):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=2e-11)
    cfg.LR_SCHEDULER.NAME = "triangle"
    with pytest.raises(ValueError):
        t_sched.build_schedule(cfg, 100)


@pytest.mark.parametrize("name", ["sgd", "muon", "ademamix"])
def test_unported_optimizers_raise(name):
    """Once unported, SGD, Muon, AdEMAMix and PARAMETER_GROUPS now build;
    an unknown name still raises."""
    cfg = train_preset()
    cfg.OPTIMIZER.update(get_default_config().OPTIMIZER)
    model = build_model(SPEC, 64, NC, META, device="cpu")
    cfg.OPTIMIZER.NAME = name
    opt = t_build.build_optimizer(cfg, 1e-3, model)
    assert type(opt).__name__ == {"sgd": "SGD", "muon": "Muon", "ademamix": "AdEMAMix"}[name]
    assert sum(len(g["params"]) for g in opt.param_groups) == len(list(model.parameters()))
    cfg.OPTIMIZER.PARAMETER_GROUPS = ConfigNode({
        "ENABLED": True, "HEADS": {"FILTER": {"TYPE": "name", "PATTERNS": ["head_"]}}})
    assert {g["label"] for g in t_build.build_optimizer(cfg, 1e-3, model).param_groups} == {
        "default", "HEADS"}
    cfg.OPTIMIZER.PARAMETER_GROUPS = ConfigNode({"ENABLED": False})
    cfg.OPTIMIZER.NAME = "lamb"
    with pytest.raises(ValueError, match="lamb"):
        t_build.build_optimizer(cfg, 1e-3, model)


@functools.lru_cache(maxsize=1)
def _jax_params_and_grads():
    model = JMFormerV1(
        img_size=(64, 64), convnext_depths=DEPTHS, convnext_dims=(8, 16, 32, 64),
        rope_depths=ROPE_DEPTHS, rope_dims=(32, 64), rope_num_heads=(2, 2),
        drop_path_rate=0.0, meta_components=META, task_keys=TASKS, num_classes=NC,
        head_configs={t: {"TYPE": "Linear"} for t in TASKS},
    )
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((2, 64, 64, 3)), jnp.zeros((2, 5)))["params"]
    rng = np.random.default_rng(0)
    noisy = lambda scale: jax.tree.map(  # noqa: E731
        lambda a: np.asarray(a) * 0 + scale * rng.normal(size=a.shape).astype(np.float32), params)
    return jax.tree.map(lambda a, n: np.asarray(a) + n, params, noisy(0.05)), noisy(0.3)


def test_no_decay_mask_matches_jax():
    params, _ = _jax_params_and_grads()
    mask = j_build._no_decay_mask(params)
    flat = {k: bool(np.asarray(v).all()) for k, v in state_dict_from_jax(
        jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32), mask, params),
        *BRIDGE).items()}
    model = build_model(SPEC, 64, NC, META, device="cpu")
    got = t_build._no_decay_mask(model.named_parameters())
    assert got == flat
    assert not got["stages.0.0.gamma"] and got["stages.0.0.dwconv.weight"] and got["cls_token_1"]


@pytest.mark.parametrize("updates", [1, 3])
def test_adamw_cosine_update_matches_optax(updates):
    params, grads = _jax_params_and_grads()
    jcfg, cfg = _jax_config(), train_preset()
    j_schedule = j_sched.build_schedule(jcfg, 920)
    tx = j_build.build_optimizer(jcfg, j_schedule)
    j_params = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(j_params)

    model = build_model(SPEC, 64, NC, META, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, *BRIDGE), strict=True)
    schedule = t_sched.build_schedule(cfg, 920)
    optimizer = t_build.build_optimizer(cfg, schedule, model)
    t_grads = state_dict_from_jax(grads, *BRIDGE)  # the bridge carries gradients too

    for step in range(updates):
        # a later step of the warm-up, so the rate is not the tiny first one
        count = 140 + step
        opt_state = jax.tree.map(
            lambda x: jnp.asarray(count, x.dtype) if x.ndim == 0 and x.dtype == jnp.int32 else x,
            opt_state) if step == 0 else opt_state
        upd, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        for group in optimizer.param_groups:
            group["lr"] = schedule(count)
        if step == 0:  # bring torch's bias-correction count to the same step
            for p in model.parameters():
                optimizer.state[p] = {
                    "step": torch.tensor(float(count)), "exp_avg": torch.zeros_like(p),
                    "exp_avg_sq": torch.zeros_like(p)}
        for name, p in model.named_parameters():
            p.grad = t_grads[name].clone()
        optimizer.step()

    want = state_dict_from_jax(jax.tree.map(np.asarray, j_params), *BRIDGE)
    moved = 0.0
    before = state_dict_from_jax(params, *BRIDGE)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
        moved = max(moved, float((p.detach() - before[name]).abs().max()))
    assert moved > 1e-4  # the update was not a no-op
    mu, nu, n = adamw_moments_from_optax(jax.tree.map(np.asarray, opt_state), *BRIDGE)
    assert n == 140 + updates
    for name, p in model.named_parameters():
        st = optimizer.state[p]
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[name].numpy(), rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[name].numpy(), rtol=1e-5, atol=1e-9)


def _three_updates(opt_cfg, updates=3, lr_cfg=None):
    """(port parameters, JAX parameters, initial parameters) by port name
    after ``updates`` updates of the optimizer ``opt_cfg`` describes (keys of
    OPTIMIZER) on the same gradients, built from one config by both."""
    params, grads = _jax_params_and_grads()
    jcfg, tcfg = get_default_config(), tconf.get_default_config()
    for cfg in (jcfg, tcfg):
        cfg.defrost()
        cfg.LR_SCHEDULER.update({"NAME": "cosine", "BASE_LR": 1e-3, "MIN_LR": 1e-5,
                                 "WARMUP_STEPS": 0, **(lr_cfg or {})})
        cfg.merge_from_other_cfg({"OPTIMIZER": opt_cfg})
    j_schedule = j_sched.build_schedule(jcfg, 100)
    tx = j_build.build_optimizer(jcfg, j_schedule, params=params)
    j_params = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(j_params)
    model = build_model(SPEC, 64, NC, META, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, *BRIDGE), strict=True)
    schedule = t_sched.build_schedule(tcfg, 100)
    optimizer = t_build.build_optimizer(tcfg, schedule, model)
    t_grads = state_dict_from_jax(grads, *BRIDGE)
    for step in range(updates):
        upd, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        for group in optimizer.param_groups:
            group["lr"] = schedule(step) * group["lr_multiplier"]
        for name, p in model.named_parameters():
            p.grad = t_grads[name].clone()
        optimizer.step()
    want = state_dict_from_jax(jax.tree.map(np.asarray, j_params), *BRIDGE)
    got = {n: p.detach() for n, p in model.named_parameters()}
    return got, want, state_dict_from_jax(params, *BRIDGE), optimizer


GROUPS = {"PARAMETER_GROUPS": {
    "ENABLED": True,
    "DEFAULT": {"OPTIMIZER": "adamw", "WEIGHT_DECAY": 0.05, "LR_MULTIPLIER": 1.0},
    "HEADS": {"FILTER": {"TYPE": "name", "PATTERNS": ["head_"]}, "LR_MULTIPLIER": 10.0,
              "WEIGHT_DECAY": 0.01},
    "STAGE3": {"FILTER": {"TYPE": "and", "FILTERS": [
        {"TYPE": "name", "PATTERNS": ["stage3_"]}, {"TYPE": "dimension", "MIN_NDIM": 2}]},
        "LR_MULTIPLIER": 0.5, "WEIGHT_DECAY": 0.0},
}}


@pytest.mark.parametrize("opt_cfg", [
    {"NAME": "sgd", "MOMENTUM": 0.9, "WEIGHT_DECAY": 0.05},
    {"NAME": "ademamix", "WEIGHT_DECAY": 0.05},
    {"NAME": "ademamix", "WEIGHT_DECAY": 0.0, "T_ALPHA_BETA3": 2, "ALPHA": 8.0},
    {"NAME": "adamw", **GROUPS},
    {"NAME": "adamw", **GROUPS, "PARAMETER_GROUPS": {**GROUPS["PARAMETER_GROUPS"], "HEADS": {
        **GROUPS["PARAMETER_GROUPS"]["HEADS"], "OPTIMIZER": "sgd"}}},
], ids=["sgd", "ademamix", "ademamix_warmup", "adamw_groups", "adamw_groups_sgd_heads"])
def test_three_updates_match_optax(opt_cfg):
    got, want, before, optimizer = _three_updates(opt_cfg)
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    moved = max(float((got[n] - before[n]).abs().max()) for n in got)
    assert moved > 1e-4
    if "PARAMETER_GROUPS" in opt_cfg:
        labels = {g["label"]: g["lr_multiplier"] for g in optimizer.param_groups}
        assert labels == {"default": 1.0, "HEADS": 10.0, "STAGE3": 0.5}


class _JnpInFloat32:
    """jax.numpy with bfloat16 read as float32, for the TPU package's Muon."""

    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def ns_in_float32(monkeypatch):
    """Both Newton-Schulz iterations in float32, so the comparison sees the
    layouts and the update rule rather than bf16 rounding."""
    monkeypatch.setattr(sys.modules["linnaeus_tpu.optim.muon"], "jnp", _JnpInFloat32())
    monkeypatch.setattr(t_muon, "NS_DTYPE", torch.float32)


def _muon_updates(layouts: bool):
    """Two Muon updates (momentum 0.95, Nesterov, scaled, no decay) from the
    port and from the TPU package's ``muon`` on the same gradients; returns
    (port deltas, JAX deltas) by port name."""
    params, grads = _jax_params_and_grads()
    tx = j_muon(0.02, momentum=0.95, nesterov=True, ns_steps=5, apply_scaling=True)
    j_params = jax.tree.map(jnp.asarray, params)
    state = tx.init(j_params)
    model = build_model(SPEC, 64, NC, META, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, *BRIDGE), strict=True)
    views = jax_layouts(model)
    named = dict(model.named_parameters())
    opt = t_muon.Muon(model.parameters(), lr=0.02, momentum=0.95, nesterov=True,
                      layouts={p: (views[n].to_jax, views[n].from_jax) for n, p in named.items()}
                      if layouts else None)
    t_grads = state_dict_from_jax(grads, *BRIDGE)
    scale = np.random.default_rng(2).normal(size=2).astype(np.float32)
    for k in range(2):  # the second step's gradient differs, so momentum counts
        g = jax.tree.map(lambda a: jnp.asarray(a) * (1.0 + scale[k]), grads)
        upd, state = tx.update(g, state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        for n, p in named.items():
            p.grad = t_grads[n] * (1.0 + float(scale[k]))
        opt.step()
    want = state_dict_from_jax(jax.tree.map(np.asarray, j_params), *BRIDGE)
    before = state_dict_from_jax(params, *BRIDGE)
    return ({n: p.detach() - before[n] for n, p in named.items()},
            {n: want[n] - before[n] for n in named})


def _rel_errs(got, want):
    return {n: float((got[n] - want[n]).abs().max()) / max(float(want[n].abs().max()), 1e-12)
            for n in got}


CHECKED = ("stages.0.0.pwconv1.weight", "stages.0.0.dwconv.weight",
           "stages.2.0.attn.qkv.weight", "stem.0.weight", "stages.0.0.gamma")
# bf16 Newton-Schulz: five quintic iterations whose products and sums XLA
# and torch round at other places; the iteration does not converge (its
# singular values keep moving in about [0.7, 1.2]), so a rounding that falls
# the other way moves an entry by up to about a fifth of the largest (0.18
# measured on this model, 0.06-0.10 on single random matrices)
MUON_BF16_TOL = 0.25
# float32 Newton-Schulz: the same matrices in another summation order
MUON_FP32_TOL = 1e-4


def test_muon_matches_jax_on_linear_depthwise_and_vector(ns_in_float32):
    """Every parameter's update, the Linear, depthwise and stem kernels,
    the qkv projection, the 1-D and the singleton-dim parameters among
    them, with the iteration in float32 on both sides."""
    errs = _rel_errs(*_muon_updates(layouts=True))
    assert set(CHECKED) <= set(errs)
    bad = {n: e for n, e in errs.items() if e > MUON_FP32_TOL}
    assert not bad, bad


def test_muon_matches_jax_in_bf16():
    errs = _rel_errs(*_muon_updates(layouts=True))
    bad = {n: e for n, e in errs.items() if e > MUON_BF16_TOL}
    assert not bad, bad
    assert errs["stages.0.0.gamma"] <= 1e-5  # momentum alone: float32 both sides


def test_muon_in_the_torch_layout_would_differ(ns_in_float32):
    """The torch layout gives other updates than JAX's: a Linear (out, in)
    is scaled by max(1, out / in) ** 0.5 where JAX's (in, out) takes
    max(1, in / out) ** 0.5, and the stem and downsample kernels (O, I, kh,
    kw) flatten to (O, I kh kw) where JAX's (kh, kw, I, O) flatten to
    (kh, kw I O). The depthwise kernel has a singleton dimension in both
    layouts ((C, 1, 7, 7), (7, 7, 1, C)), so both give it momentum alone."""
    errs = _rel_errs(*_muon_updates(layouts=False))
    for name in ("stages.0.0.pwconv1.weight", "stem.0.weight",
                 "downsample_layers.0.conv.weight"):
        assert errs[name] > 0.3, (name, errs[name])
    assert errs["stages.0.0.dwconv.weight"] <= MUON_FP32_TOL


def test_muon_strict_and_zeropower_match_jax():
    rng = np.random.default_rng(3)
    for shape in ((24, 16), (16, 24), (5, 40)):
        g = rng.normal(size=shape).astype(np.float32)
        want = np.asarray(j_zeropower(jnp.asarray(g)))
        got = t_muon.zeropower_via_newtonschulz5(torch.tensor(g)).numpy()
        assert np.abs(got - want).max() <= MUON_BF16_TOL * np.abs(want).max()
    model = build_model(SPEC, 64, NC, META, device="cpu")
    with pytest.raises(ValueError, match="strict"):  # cls tokens are (1, 1, C)
        t_muon.Muon(model.parameters(), strict=True)


def test_group_rates_and_logging_match_jax():
    """lr_multipliers and lr_dict_for_logging against JAX's on a config with
    parameter groups and a group schedule of its own; the train state sets
    each optimizer group's rate to the logged rate of its label."""
    from linnaeus_tpu_torch.train.state import create_train_state

    jcfg, tcfg = get_default_config(), tconf.get_default_config()
    for cfg in (jcfg, tcfg):
        cfg.defrost()
        cfg.LR_SCHEDULER.update({"BASE_LR": 1e-3, "MIN_LR": 1e-5, "WARMUP_STEPS": 5})
        cfg.merge_from_other_cfg({"OPTIMIZER": GROUPS, "LR_SCHEDULER": {"PARAMETER_GROUPS": {
            "ENABLED": True, "HEADS": {"NAME": "linear", "BASE_LR": 2e-3}}}})
    assert t_build.lr_multipliers(tcfg) == j_build.lr_multipliers(jcfg)
    js, ts = j_sched.build_group_schedules(jcfg, 100), t_sched.build_group_schedules(tcfg, 100)
    model = build_model(SPEC, 64, NC, META, device="cpu")
    optimizer = t_build.build_optimizer(tcfg, ts["default"], model, ts)
    state = create_train_state(model, optimizer, 2, torch.Generator(), lr_schedule=ts)
    for step in (0, 3, 10, 99):
        want = j_build.lr_dict_for_logging(jcfg, js["default"], step, js)
        got = t_build.lr_dict_for_logging(tcfg, ts["default"], step, ts)
        assert set(got) == set(want) == {"lr/default", "lr/HEADS", "lr/STAGE3"}
        for k in got:  # atol: a float32 step of the largest rate (optax's warm-up)
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=2e-2 * 2**-23,
                                       err_msg=k)
        for group in optimizer.param_groups:
            assert state.group_lr(group, step) == pytest.approx(got[f"lr/{group['label']}"])
