"""The port's schedule and optimizer against the TPU package's.

The cosine schedule with its linear warm-up is held against the optax
schedule step by step (optax computes it in float32, the port in Python
floats: 1e-6 relative plus 2e-11, a float32 step of the base rate, which the
warm-up's first value loses to cancellation in optax). One AdamW update on shared parameters and shared
gradients (seeded numpy) is held against optax parameter by parameter,
through the weight bridge, with the moments compared as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from linnaeus_tpu.configuration.defaults import get_default_config
from linnaeus_tpu.models import MFormerV1 as JMFormerV1
from linnaeus_tpu.optim import build as j_build
from linnaeus_tpu.optim import schedules as j_sched
from linnaeus_tpu_torch.configuration.train_presets import ConfigNode, train_preset
from linnaeus_tpu_torch.models.build import build_model
from linnaeus_tpu_torch.optim import build as t_build
from linnaeus_tpu_torch.optim import schedules as t_sched
from linnaeus_tpu_torch.utils.convert import adamw_moments_from_optax, state_dict_from_jax

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
    cfg = train_preset()
    cfg.LR_SCHEDULER.NAME = name
    with pytest.raises(NotImplementedError, match="not ported yet"):
        t_sched.build_schedule(cfg, 100)
    cfg.LR_SCHEDULER.NAME = "triangle"
    with pytest.raises(ValueError):
        t_sched.build_schedule(cfg, 100)


@pytest.mark.parametrize("name", ["sgd", "muon", "ademamix"])
def test_unported_optimizers_raise(name):
    cfg = train_preset()
    model = build_model(SPEC, 64, NC, META, device="cpu")
    cfg.OPTIMIZER.NAME = name
    with pytest.raises(NotImplementedError, match="not ported yet"):
        t_build.build_optimizer(cfg, 1e-3, model)
    cfg.OPTIMIZER.NAME = "adamw"
    cfg.OPTIMIZER.PARAMETER_GROUPS = ConfigNode({"ENABLED": True})
    with pytest.raises(NotImplementedError, match="PARAMETER_GROUPS"):
        t_build.build_optimizer(cfg, 1e-3, model)


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
