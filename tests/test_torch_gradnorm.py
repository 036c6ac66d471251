"""The port's GradNorm against the TPU package's.

Mirrors tests/test_gradnorm_update.py. ``gradnorm_weight_update`` is held
against JAX's on the same norms and losses (fresh and initialised states,
alpha on and off) to 1e-6. The whole update (a deterministic re-forward
per task, ``torch.autograd.grad`` over the trunk, float32 norms, the
weight update) runs on the weights JAX initialised, exported through the
weight bridge, on the same images, targets and metadata: new weights,
norms and losses agree to 1e-4 relative, with GRADNORM_ACCUM_STEPS 1 and
2, and ZERO_AUX_INFO and the linear-head re-forward each turned off once
(the heads are hierarchical, so the linear heads change the logits); the
re-forward rematerialised gives the same bits. The model's mode and remat flag are left as
they were.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import linnaeus_tpu.ops.fused_mlp as jfm
from linnaeus_tpu.loss import cross_entropy as j_ce
from linnaeus_tpu.loss import gradnorm as jgn
from linnaeus_tpu.models import MFormerV1 as JMFormerV1
from linnaeus_tpu.utils.param_filters import trunk_mask_from_exclude as j_trunk
from linnaeus_tpu.utils.taxonomy import TaxonomyTree as JTree
from linnaeus_tpu_torch.loss import cross_entropy as t_ce
from linnaeus_tpu_torch.loss import gradnorm as tgn
from linnaeus_tpu_torch.models.build import build_model
from linnaeus_tpu_torch.utils.convert import state_dict_from_jax
from linnaeus_tpu_torch.utils.param_filters import trunk_mask_from_exclude
from linnaeus_tpu_torch.utils.taxonomy import TaxonomyTree

TASKS = ("taxa_L10", "taxa_L20")
NC = {"taxa_L10": 5, "taxa_L20": 3}
HIERARCHY = {"taxa_L10": {1: 1, 2: 1, 3: 2, 4: 2}}
HEADS = {"taxa_L10": {"TYPE": "HierarchicalSoftmax"}, "taxa_L20": {"TYPE": "Linear"}}
META = (("TEMPORAL", 2),)
DEPTHS, ROPE_DEPTHS = (1, 1, 1, 1), (1, 1)
SPEC = {
    "CONVNEXT": {"DEPTHS": list(DEPTHS), "DIMS": [8, 16, 32, 64]},
    "ROPE": {"DEPTHS": list(ROPE_DEPTHS), "DIMS": [32, 64], "NUM_HEADS": [2, 2]},
    "DROP_PATH_RATE": 0.2,
}
EXCLUDE = {"TYPE": "or", "FILTERS": [{"TYPE": "name", "PATTERNS": ["head"]},
                                     {"TYPE": "name", "PATTERNS": ["meta_"]}]}
B, IMG = 8, 32
RTOL = 1e-4


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jfm.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.fixture(scope="module")
def setup():
    jm = JMFormerV1(
        img_size=(IMG, IMG), convnext_depths=DEPTHS, convnext_dims=(8, 16, 32, 64),
        rope_depths=ROPE_DEPTHS, rope_dims=(32, 64), rope_num_heads=(2, 2),
        drop_path_rate=0.2, meta_components=META, task_keys=TASKS, num_classes=NC,
        head_configs=HEADS,
        hierarchy_matrices=JTree(HIERARCHY, list(TASKS), dict(NC)).build_hierarchy_matrices(),
    )
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(B, IMG, IMG, 3)).astype(np.float32)
    meta = rng.normal(size=(B, 2)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(meta))["params"]
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)
    targets = {t: np.eye(n, dtype=np.float32)[np.arange(B) % n] for t, n in NC.items()}
    model = build_model(SPEC, IMG, NC, META, head_configs=HEADS, device="cpu",
                        taxonomy_tree=TaxonomyTree(HIERARCHY, list(TASKS), dict(NC)))
    model.load_state_dict(state_dict_from_jax(params, DEPTHS, ROPE_DEPTHS, ("TEMPORAL",), TASKS),
                          strict=True)
    return jm, params, model, images, targets, meta


@pytest.mark.parametrize("alpha", [1.5, 0.0])
@pytest.mark.parametrize("initted", [False, True])
def test_weight_update_matches_jax(alpha, initted):
    rng = np.random.default_rng(1)
    norms = rng.uniform(0.1, 3.0, 4).astype(np.float32)
    losses = rng.uniform(0.5, 5.0, 4).astype(np.float32)
    w0 = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    init = rng.uniform(0.5, 5.0, 4).astype(np.float32)
    jstate = jgn.GradNormState(jnp.asarray(w0), jnp.asarray(init), jnp.asarray(initted))
    tstate = tgn.GradNormState(torch.tensor(w0), torch.tensor(init), torch.tensor(initted))
    jnew, jm = jgn.gradnorm_weight_update(jnp.asarray(norms), jnp.asarray(losses), jstate, alpha)
    tnew, tm = tgn.gradnorm_weight_update(torch.tensor(norms), torch.tensor(losses), tstate, alpha)
    for a, b in ((tnew.task_weights, jnew.task_weights),
                 (tnew.initial_losses, jnew.initial_losses)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert bool(tnew.has_initted)
    assert set(tm) == set(jm)
    for k in tm:
        np.testing.assert_allclose(np.asarray(tm[k]), np.asarray(jm[k]), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(tnew.task_weights.sum()), 4.0, rtol=1e-6)


def _jax_update(setup, accum, zero_aux, linear_heads):
    jm, params, _, images, targets, meta = setup

    def apply_fn(p, imgs, mta, deterministic=True, gradnorm_mode=True, batch_stats=None):
        return jm.apply({"params": p}, imgs, mta, deterministic=deterministic,
                        gradnorm_mode=gradnorm_mode)

    update = jgn.make_gradnorm_update_fn(
        apply_fn, {t: j_ce for t in TASKS}, TASKS, lambda p: j_trunk(p, EXCLUDE), alpha=1.5,
        zero_aux_info=zero_aux, use_linear_heads=linear_heads, accum_steps=accum)
    state = jgn.GradNormState(jnp.asarray([1.5, 0.5]), jnp.asarray([2.0, 1.0]),
                              jnp.asarray(True))
    return jax.jit(update)(params, jnp.asarray(images),
                           {t: jnp.asarray(v) for t, v in targets.items()},
                           jnp.asarray(meta), state)


def _port_update(setup, accum, zero_aux, linear_heads, remat=None):
    _, _, model, images, targets, meta = setup
    trunk = [n for n, keep in trunk_mask_from_exclude(model, EXCLUDE).items() if keep]
    update = tgn.make_gradnorm_update_fn(
        {t: t_ce for t in TASKS}, TASKS, trunk, alpha=1.5, zero_aux_info=zero_aux,
        use_linear_heads=linear_heads, accum_steps=accum, remat=remat)
    state = tgn.GradNormState(torch.tensor([1.5, 0.5]), torch.tensor([2.0, 1.0]),
                              torch.tensor(True))
    return update(model, torch.tensor(images), {t: torch.tensor(v) for t, v in targets.items()},
                  torch.tensor(meta), state)


def _compare(got, want):
    (tstate, tm), (jstate, jm) = got, want
    np.testing.assert_allclose(tstate.task_weights.numpy(), np.asarray(jstate.task_weights),
                               rtol=RTOL)
    for k in ("gradnorm/norms", "gradnorm/losses", "gradnorm/targets", "gradnorm/avg_norm"):
        np.testing.assert_allclose(np.asarray(tm[k]), np.asarray(jm[k]), rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("accum, zero_aux, linear_heads", [
    (1, True, True), (2, True, True), (1, False, True), (1, True, False)])
def test_update_matches_jax(setup, accum, zero_aux, linear_heads):
    _compare(_port_update(setup, accum, zero_aux, linear_heads),
             _jax_update(setup, accum, zero_aux, linear_heads))


def test_options_change_the_norms(setup):
    """Each option does move the result, so the comparisons above see it."""
    base = _port_update(setup, 1, True, True)[1]["gradnorm/norms"]
    for kw in ({"zero_aux": False, "linear_heads": True},
               {"zero_aux": True, "linear_heads": False}):
        other = _port_update(setup, 1, **kw)[1]["gradnorm/norms"]
        assert float((other - base).abs().max()) > 1e-4 * float(base.abs().max()), kw


def test_accumulation_matches_the_full_batch(setup):
    one, two = _port_update(setup, 1, True, True), _port_update(setup, 2, True, True)
    np.testing.assert_allclose(two[0].task_weights.numpy(), one[0].task_weights.numpy(),
                               rtol=RTOL)
    np.testing.assert_allclose(two[1]["gradnorm/norms"].numpy(),
                               one[1]["gradnorm/norms"].numpy(), rtol=RTOL)


def test_rematerialised_reforward_is_the_same_and_restores_the_model(setup):
    _, _, model, *_ = setup
    model.train()
    model.remat_policy = "dots"
    plain = _port_update(setup, 1, True, True, remat=False)
    remat = _port_update(setup, 1, True, True, remat=True)
    assert torch.equal(plain[1]["gradnorm/norms"], remat[1]["gradnorm/norms"])
    assert torch.equal(plain[0].task_weights, remat[0].task_weights)
    assert model.training and model.gradient_checkpointing is False


def test_trunk_excludes_heads_and_meta(setup):
    _, _, model, *_ = setup
    trunk = trunk_mask_from_exclude(model, EXCLUDE)
    assert not any(keep for n, keep in trunk.items() if n.startswith(("head.", "meta_")))
    assert sum(trunk.values()) > 0.8 * len(trunk) - 30


@pytest.mark.parametrize("step", [0, 1, 2, 3, 4, 100])
def test_cadence_is_the_ops_schedule_rule(step):
    from linnaeus_tpu.configuration.defaults import get_default_config
    from linnaeus_tpu.ops_schedule.ops_schedule import OpsSchedule
    from linnaeus_tpu.ops_schedule.training_progress import TrainingProgress

    cfg = get_default_config()
    cfg.defrost()
    cfg.LOSS.GRAD_WEIGHTING.TASK.UPDATE_INTERVAL = 2
    for warmup, kind in ((0, "gradnorm"), (3, "gradnorm"), (0, "static")):
        cfg.LOSS.GRAD_WEIGHTING.TASK.GRADNORM_WARMUP_STEPS = warmup
        cfg.LOSS.GRAD_WEIGHTING.TASK.TYPE = kind
        want = OpsSchedule(cfg, TrainingProgress()).should_update_gradnorm(step)
        assert tgn.should_update_gradnorm(cfg.LOSS.GRAD_WEIGHTING.TASK, step) is want
