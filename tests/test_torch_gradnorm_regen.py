"""The GradNorm re-forward's batch, collated again rather than kept.

A train step saves the generator's state before each microbatch's collate
(``TrainState.collate_rng``); ``train_step.collated`` collates the step's
batch again from those states. On tests/test_torch_train_step.py's tiny
mFormerV1 with AutoAugment, jitter, flip, erasing, mixing (mixup and
cutmix) and meta-masking, what it returns is, bit for bit, what the step's
forwards consumed (images in the compute dtype, metadata) and what its
criteria saw (the mixed soft targets), at accumulation 1 and 2, for the
last of two steps. The GradNorm step through it against the TPU package's
Trainer, which regenerates the batch from the step's key and updates on it
(``linnaeus_tpu/train/loop.py``): the same weights (the port's step at a
rate of 0 leaves them as they were), JAX's draws handed to the port, the
norms, losses and new task weights to tests/test_torch_gradnorm.py's 1e-4.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import linnaeus_tpu.data.collate as jc
import linnaeus_tpu.ops.flash_attention as jfa
import linnaeus_tpu.ops.fused_mlp as jfm
import linnaeus_tpu.train.step as jstep
from linnaeus_tpu_torch.data import collate as tc
from linnaeus_tpu_torch.loss import gradnorm as tgn
from linnaeus_tpu_torch.loss import soft_target_cross_entropy as t_stce
from linnaeus_tpu_torch.models.build import build_model
from linnaeus_tpu_torch.train.state import create_train_state
from linnaeus_tpu_torch.train.step import make_gradnorm_step, make_train_step
from linnaeus_tpu_torch.utils.convert import state_dict_from_jax
from tests import test_torch_train_step as ts


def port_state(lr=1e-3, model=None):
    model = model or build_model(ts.SPEC, ts.IMG, ts.NC, ts.META, device="cpu")
    return create_train_state(model, torch.optim.AdamW(model.parameters(), lr=lr), num_tasks=2,
                              generator=torch.Generator().manual_seed(0))


@pytest.fixture(autouse=True)
def pallas_on_cpu(monkeypatch):
    interpret = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(jfm.pl, "pallas_call", interpret)
    monkeypatch.setattr(jfa.pl, "pallas_call", interpret)
    monkeypatch.setattr(jfm, "_FORCE_KERNEL_BWD", True)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("cutmix", [False, True])
def test_collated_again_is_what_the_step_consumed(accum, cutmix):
    state = port_state()
    _, taug = ts._augmenters()
    targets_seen = {t: [] for t in ts.TASKS}

    def criterion(task):
        def seen(logits, target):
            targets_seen[task].append(target.detach().clone())
            return t_stce(logits, target)
        return seen

    step = make_train_step({t: criterion(t) for t in ts.TASKS}, ts.TASKS,
                           tc.MixConfig(chunk_bounds=ts.BOUNDS, cutmix_enabled=cutmix),
                           accumulation_steps=accum, augment_fn=taug)
    scalars = ts._scalars("mixed_masked")[1]._replace(use_cutmix=cutmix)
    batch = ts._tree(ts._uint8_batch(), torch.tensor)
    seen = []
    hook = state.model.register_forward_pre_hook(
        lambda mod, args: seen.append((args[0].detach().clone(), args[1].clone())))
    step(state, batch, scalars)
    seen.clear()
    for t in ts.TASKS:
        targets_seen[t].clear()
    _, m = step(state, batch, scalars)  # the second step's draws differ from the first's
    hook.remove()
    assert len(seen) == accum == len(state.collate_rng) and float(m["mixed_frac"]) > 0
    images, targets, meta = step.collated(state, batch, scalars)
    assert torch.equal(images, torch.cat([s[0] for s in seen]).to(state.model.dtype))
    assert torch.equal(meta, torch.cat([s[1] for s in seen]))
    for t in ts.TASKS:
        assert torch.equal(targets[t], torch.cat(targets_seen[t]))
    # the regeneration leaves the step's own generator where the step left it
    before = state.generator.get_state()
    step.collated(state, batch, scalars)
    assert torch.equal(state.generator.get_state(), before)


def test_collated_needs_a_step_first():
    state = port_state()
    step = make_train_step({t: t_stce for t in ts.TASKS}, ts.TASKS,
                           tc.MixConfig(chunk_bounds=ts.BOUNDS))
    with pytest.raises(ValueError, match="no train step"):
        step.collated(state, ts._tree(ts._batch(), torch.tensor), ts._scalars("plain")[1])


def test_gradnorm_step_matches_the_jax_trainers_regeneration():
    depths, rope_depths, img = (1, 1, 1, 1), (1, 1), 32
    jm = ts.JMFormerV1(
        img_size=(img, img), convnext_depths=depths, convnext_dims=ts.DIMS,
        rope_depths=rope_depths, rope_dims=(32, 64), rope_num_heads=(2, 2),
        drop_path_rate=0.0, meta_components=ts.META, task_keys=ts.TASKS, num_classes=ts.NC,
        head_configs={t: {"TYPE": "Linear"} for t in ts.TASKS})
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((2, img, img, 3)),
                     jnp.zeros((2, 5)))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)
    mix_cfg = jc.MixConfig(chunk_bounds=ts.BOUNDS)
    batch = dict(ts._batch())
    batch["images"] = batch["images"][:, :img, :img]
    j_scalars, t_scalars = ts._scalars("mixed_masked")

    # the TPU package's Trainer after step 0: that step's preprocess key
    # again, the batch collated again, the update on the parameters
    r_pre, _ = jstep.train_step_rngs(jax.random.PRNGKey(ts.SEED_KEY), 0)
    jpre = jstep.make_preprocess_fn(mix_cfg, has_meta=True)
    images, targets, meta, _ = jpre(dict(ts._tree(batch, jnp.asarray), _scalars=j_scalars), r_pre)

    def apply_fn(p, imgs, mta, deterministic=True, gradnorm_mode=True, batch_stats=None):
        return jm.apply({"params": p}, imgs, mta, deterministic=deterministic,
                        gradnorm_mode=gradnorm_mode)

    def jtrunk(p):
        return {k: jax.tree.map(lambda a: jnp.asarray(
            0.0 if k == "head" or k.startswith("meta_") else 1.0), v) for k, v in p.items()}

    jstate, jm_ = jax.jit(ts.jgn_update(apply_fn, jtrunk))(
        jax.tree.map(jnp.asarray, params), images, targets, meta, ts.jgn_state())

    spec = {"CONVNEXT": {"DEPTHS": list(depths), "DIMS": list(ts.DIMS)},
            "ROPE": {"DEPTHS": list(rope_depths), "DIMS": [32, 64], "NUM_HEADS": [2, 2]},
            "DROP_PATH_RATE": 0.0}
    model = build_model(spec, img, ts.NC, ts.META, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, depths, rope_depths, ("TEMPORAL", "SPATIAL"),
                                              ts.TASKS), strict=True)
    state = port_state(lr=0.0, model=model)
    step = make_train_step({t: t_stce for t in ts.TASKS}, ts.TASKS,
                           tc.MixConfig(chunk_bounds=ts.BOUNDS))
    draws = ts.step_draws(0, mix_cfg)
    t_batch = ts._tree(batch, torch.tensor)
    state, _ = step(state, t_batch, t_scalars, draws=draws)
    trunk = [n for n, _ in model.named_parameters() if not n.startswith(("head", "meta_"))]
    update = tgn.make_gradnorm_update_fn({t: t_stce for t in ts.TASKS}, ts.TASKS, trunk,
                                         alpha=1.5)
    state, tm = make_gradnorm_step(update, step)(state, t_batch, t_scalars, draws=draws)
    for k in ("gradnorm/norms", "gradnorm/losses"):
        np.testing.assert_allclose(np.asarray(tm[k]), np.asarray(jm_[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(state.gradnorm.task_weights.numpy(),
                               np.asarray(jstate.task_weights), rtol=1e-4)
    assert not np.allclose(np.asarray(jstate.task_weights), 1.0)
