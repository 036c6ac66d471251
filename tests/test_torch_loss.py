"""The port's loss package against the TPU package's on shared inputs.

Inputs come from numpy with a fixed seed; the null-masking coins are the
JAX draws of the same keys, handed to the port as operands. float32, 1e-5.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linnaeus_tpu.loss as jl
from linnaeus_tpu.loss.gradnorm import init_gradnorm_state as j_init_gradnorm
from linnaeus_tpu.loss.taxonomy_smoothing import build_taxonomy_smoothing_matrix as j_matrix
from linnaeus_tpu_torch import loss as tl
from linnaeus_tpu_torch.configuration.train_presets import train_preset

ATOL = 1e-5
NC = {"a": 7, "b": 4}


def _data(seed=0, B=10, soft=True):
    rng = np.random.default_rng(seed)
    logits = {t: 2.0 * rng.normal(size=(B, n)).astype(np.float32) for t, n in NC.items()}
    labels = {t: rng.integers(-1, n, B) for t, n in NC.items()}  # -1: unmapped
    labels["a"][:3] = 0  # null-labelled samples
    if not soft:
        return logits, {t: v.astype(np.int32) for t, v in labels.items()}
    targets = {}
    for t, n in NC.items():
        rows = np.zeros((B, n), np.float32)
        ok = labels[t] >= 0
        rows[ok, labels[t][ok]] = 1.0
        targets[t] = rows
    targets["b"][0] = [0.3, 0.7, 0.0, 0.0]  # a mixed row
    return logits, targets


def _t(x):
    return {k: _t(v) for k, v in x.items()} if isinstance(x, dict) else torch.tensor(np.asarray(x))


def _j(x):
    return {k: _j(v) for k, v in x.items()} if isinstance(x, dict) else jnp.asarray(x)


@pytest.mark.parametrize("soft", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ["cross_entropy", "soft_target_cross_entropy",
                                  "label_smoothing_cross_entropy"])
def test_criteria_match_jax(name, soft, weighted):
    logits, targets = _data(1, soft=soft)
    if not soft:  # hard labels are never unmapped on this path
        targets = {t: np.maximum(v, 0) for t, v in targets.items()}
    cw = np.linspace(0.5, 2.0, 7).astype(np.float32) if weighted else None
    want = getattr(jl, name)(jnp.asarray(logits["a"]), jnp.asarray(targets["a"]),
                             class_weights=None if cw is None else jnp.asarray(cw))
    got = getattr(tl, name)(torch.tensor(logits["a"]), torch.tensor(targets["a"]),
                            class_weights=None if cw is None else torch.tensor(cw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_criteria_promote_bf16_logits_to_float32():
    logits, targets = _data(2)
    got = tl.cross_entropy(torch.tensor(logits["a"]).bfloat16(), torch.tensor(targets["a"]))
    want = jl.cross_entropy(jnp.asarray(logits["a"], jnp.bfloat16), jnp.asarray(targets["a"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_taxonomy_smoothing_matches_jax():
    rng = np.random.default_rng(3)
    dist = rng.integers(1, 5, (7, 7)).astype(np.float32)
    dist[2, 5] = np.inf
    want = j_matrix(7, dist, alpha=0.2, beta=0.7, root_class_ids=[1])
    got = tl.build_taxonomy_smoothing_matrix(7, dist, alpha=0.2, beta=0.7, root_class_ids=[1])
    np.testing.assert_array_equal(got, want)
    logits, targets = _data(3)
    np.testing.assert_allclose(
        tl.taxonomy_smoothed_cross_entropy(
            torch.tensor(logits["a"]), torch.tensor(targets["a"]), torch.tensor(got)).numpy(),
        np.asarray(jl.taxonomy_smoothed_cross_entropy(
            jnp.asarray(logits["a"]), jnp.asarray(targets["a"]), jnp.asarray(want))), atol=ATOL)


def _coins(key, B):
    return {t: _t(jax.random.uniform(jax.random.fold_in(key, i), (B,)))
            for i, t in enumerate(NC)}


@pytest.mark.parametrize("soft", [True, False])
@pytest.mark.parametrize("prob", [0.0, 0.5, 1.0])
def test_null_masking_and_class_weighting_match_jax(prob, soft):
    logits, targets = _data(4, soft=soft)
    per_task = {t: np.abs(logits[t]).sum(-1) for t in NC}
    cw = {"a": np.linspace(0.5, 2.0, 7).astype(np.float32)}
    key = jax.random.PRNGKey(5)
    if not soft:
        cw, targets = None, targets  # class weights index hard labels: keep them mapped
    j_masked, j_stats = jl.apply_loss_masking(
        _j(per_task), _j(targets), prob, key, class_weights=None if cw is None else _j(cw))
    t_masked, t_stats = tl.apply_loss_masking(
        _t(per_task), _t(targets), prob, coins=_coins(key, 10),
        class_weights=None if cw is None else _t(cw))
    for t in NC:
        np.testing.assert_allclose(t_masked[t].numpy(), np.asarray(j_masked[t]), atol=ATOL)
        for k in ("null_total", "null_included", "valid_count"):
            assert int(t_stats[t][k]) == int(j_stats[t][k]), (t, k)


@pytest.mark.parametrize("kw", [{}, {"is_validation": True}, {"phase1_mask_null": True},
                                {"apply_class_weights": False}])
def test_weighted_hierarchical_loss_matches_jax(kw):
    logits, targets = _data(6)
    keys = tuple(NC)
    weights = np.array([1.3, 0.7], np.float32)
    cw = {"b": np.array([1.0, 2.0, 0.5, 1.5], np.float32)}
    key = jax.random.PRNGKey(8)
    j_total, j_comp = jl.weighted_hierarchical_loss(
        _j(logits), _j(targets), {t: jl.soft_target_cross_entropy for t in keys},
        jnp.asarray(weights), 0.5, key, class_weights=_j(cw), task_keys=keys, **kw)
    t_total, t_comp = tl.weighted_hierarchical_loss(
        _t(logits), _t(targets), {t: tl.soft_target_cross_entropy for t in keys},
        torch.tensor(weights), 0.5, coins=_coins(key, 10), class_weights=_t(cw),
        task_keys=keys, **kw)
    np.testing.assert_allclose(float(t_total), float(j_total), atol=ATOL)
    for t in keys:
        for part in ("tasks", "weighted_tasks"):
            np.testing.assert_allclose(float(t_comp[part][t]), float(j_comp[part][t]), atol=ATOL)


def test_null_masking_needs_coins_only_between_0_and_1():
    logits, targets = _data(7)
    losses = {t: torch.tensor(np.abs(logits[t]).sum(-1)) for t in NC}
    tl.apply_null_masking(losses, _t(targets), 1.0)
    with pytest.raises(ValueError, match="Generator"):
        tl.apply_null_masking(losses, _t(targets), 0.5)
    g = torch.Generator().manual_seed(0)
    masked, stats = tl.apply_null_masking(losses, _t(targets), 0.5, generator=g)
    assert 0 <= int(stats["a"]["null_included"]) <= int(stats["a"]["null_total"]) and int(stats["a"]["null_total"]) >= 3


def test_prepare_loss_functions_and_class_weights_match_jax():
    from linnaeus_tpu.configuration.defaults import get_default_config
    from linnaeus_tpu.loss.utils import calculate_class_weights as j_cw

    jcfg = get_default_config()
    jcfg.defrost()
    funcs = ["CrossEntropyLoss", "LabelSmoothingCrossEntropy", "SoftTargetCrossEntropy",
             "CrossEntropy"]
    jcfg.LOSS.TASK_SPECIFIC.TRAIN.FUNCS = funcs
    jcfg.DATA.TASK_KEYS_H5 = ["taxa_L10", "taxa_L20", "taxa_L30", "taxa_L40"]
    cfg = train_preset()
    cfg.LOSS.TASK_SPECIFIC.TRAIN.FUNCS = funcs
    nc = dict.fromkeys(cfg.DATA.TASK_KEYS_H5, 7)
    j_train, j_val = jl.prepare_loss_functions(jcfg, nc)
    t_train, t_val = tl.prepare_loss_functions(cfg, nc)
    logits, targets = _data(9)
    for task in nc:
        for (jf, tf) in ((j_train[task], t_train[task]), (j_val[task], t_val[task])):
            np.testing.assert_allclose(
                tf(torch.tensor(logits["a"]), torch.tensor(targets["a"])).numpy(),
                np.asarray(jf(jnp.asarray(logits["a"]), jnp.asarray(targets["a"]))), atol=ATOL)
    cfg.LOSS.TASK_SPECIFIC.TRAIN.FUNCS = ["Hinge"]
    with pytest.raises(ValueError, match="Unknown loss"):
        tl.prepare_loss_functions(cfg, nc)
    counts = {"a": np.array([100, 0, 5, 50, 1, 20, 20])}
    for mode in ("inverse", "sqrt_inverse", "none"):
        np.testing.assert_array_equal(
            tl.calculate_class_weights(counts, mode)["a"], j_cw(counts, mode)["a"])


@pytest.mark.parametrize("init", [None, [2.0, 1.0, 1.0]])
def test_gradnorm_state_matches_jax(init):
    want = j_init_gradnorm(3, init)
    got = tl.init_gradnorm_state(3, init)
    np.testing.assert_allclose(got.task_weights.numpy(), np.asarray(want.task_weights), atol=1e-7)
    assert got.initial_losses.tolist() == [0.0] * 3 and not bool(got.has_initted)
    assert isinstance(types.SimpleNamespace(**vars(got)).task_weights, torch.Tensor)
