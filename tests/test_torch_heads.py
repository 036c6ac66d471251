"""The port's classification heads against the JAX package's MultiTaskHeads.

Same parameters (the level classifiers' Dense kernels, transposed) and the
same three-level taxonomy tree (the port's copy of TaxonomyTree on one
side, the original on the other), float32, to 2e-6: HierarchicalSoftmax,
ConditionalClassifier ``soft`` and eval ``hard``, training-mode routing,
Linear and hierarchical tasks mixed, and ``gradnorm_mode``. The ``gumbel``
routing draws from the port's generator and is held against a numpy
evaluation on the same draws. A whole tiny mFormerV1 with hierarchical
heads, built from one config by both packages, matches the JAX logits to
the model bar of 4e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import linnaeus_tpu.ops.fused_mlp as jfm
from linnaeus_tpu import configuration as jconf
from linnaeus_tpu.configuration import archs as jarchs
from linnaeus_tpu.models.build import build_model as jbuild_model
from linnaeus_tpu.models.heads.heads import MultiTaskHeads as JHeads
from linnaeus_tpu.models.heads.heads import configure_classification_heads as jconfigure
from linnaeus_tpu.utils.taxonomy import TaxonomyTree as JTree
from linnaeus_tpu_torch import configuration as tconf
from linnaeus_tpu_torch.configuration import archs as tarchs
from linnaeus_tpu_torch.models.build import build_model
from linnaeus_tpu_torch.models.heads.heads import (
    MultiTaskHeads,
    configure_classification_heads,
    gumbel_noise,
)
from linnaeus_tpu_torch.utils.convert import state_dict_from_jax
from linnaeus_tpu_torch.utils.taxonomy import TaxonomyTree

TASKS = ("taxa_L10", "taxa_L20", "taxa_L30")
NC = {"taxa_L10": 9, "taxa_L20": 5, "taxa_L30": 3}
# species 1..8 under genera 1..4 under families 1..2 (0 = null at every rank)
HIERARCHY = {
    "taxa_L10": {1: 1, 2: 1, 3: 2, 4: 2, 5: 3, 6: 3, 7: 4, 8: 4},
    "taxa_L20": {1: 1, 2: 1, 3: 2, 4: 2},
}
FEATS = 16
TOL = 2e-6
MODEL_TOL = 4e-5


def _trees():
    return (TaxonomyTree(HIERARCHY, list(TASKS), dict(NC)),
            JTree(HIERARCHY, list(TASKS), dict(NC)))


def _feats(n=6, seed=0):
    return np.random.default_rng(seed).normal(size=(n, FEATS)).astype(np.float32)


def _pair(head_configs, with_tree=True):
    """(port heads, JAX heads, JAX params) on the same seeded weights."""
    ttree, jtree = _trees()
    jheads = jconfigure(head_configs, NC, list(TASKS), jtree if with_tree else None)
    params = jheads.init(jax.random.PRNGKey(0), jnp.zeros((1, FEATS)))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.5 * rng.normal(size=a.shape)
                          .astype(np.float32), params)
    theads = configure_classification_heads(
        head_configs, NC, list(TASKS), FEATS, ttree if with_tree else None)
    theads.load_state_dict(_head_state(params), strict=True)
    return theads, jheads, params


def _head_state(params):
    state = {}
    for t in TASKS:
        dense = params[f"head_{t}"]["Dense_0"]
        state[f"{t}.fc.weight"] = torch.tensor(dense["kernel"].T)
        if "bias" in dense:
            state[f"{t}.fc.bias"] = torch.tensor(dense["bias"])
    return state


def _compare(theads, jheads, params, feats, training=False, gradnorm_mode=False):
    theads.train(training)
    with torch.no_grad():
        ours = theads(torch.tensor(feats), gradnorm_mode=gradnorm_mode)
    theirs = jheads.apply({"params": params}, jnp.asarray(feats),
                          deterministic=not training, gradnorm_mode=gradnorm_mode)
    for t in TASKS:
        assert ours[t].dtype == torch.float32
        np.testing.assert_allclose(ours[t].numpy(), np.asarray(theirs[t]), atol=TOL, err_msg=t)
    return ours


def test_the_trees_give_the_same_matrices():
    ttree, jtree = _trees()
    ours, theirs = ttree.build_hierarchy_matrices(), jtree.build_hierarchy_matrices()
    assert sorted(ours) == sorted(theirs) == ["taxa_L20_taxa_L10", "taxa_L30_taxa_L20"]
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


HEAD_CASES = {
    "hierarchical_softmax": {t: {"TYPE": "HierarchicalSoftmax"} for t in TASKS},
    "conditional_soft": {t: {"TYPE": "ConditionalClassifier", "ROUTING_STRATEGY": "soft",
                             "TEMPERATURE": 0.7} for t in TASKS},
    "conditional_hard": {t: {"TYPE": "ConditionalClassifier", "ROUTING_STRATEGY": "hard"}
                         for t in TASKS},
    "mixed": {"taxa_L10": {"TYPE": "HierarchicalSoftmax"},
              "taxa_L20": {"TYPE": "Linear", "USE_BIAS": False},
              "taxa_L30": {"TYPE": "ConditionalClassifier", "ROUTING_STRATEGY": "soft"}},
    "mixed_conditional_under_softmax": {
        "taxa_L10": {"TYPE": "ConditionalClassifier", "ROUTING_STRATEGY": "hard",
                     "TEMPERATURE": 2.0},
        "taxa_L20": {"TYPE": "HierarchicalSoftmax"},
        "taxa_L30": {"TYPE": "Linear"}},
}


@pytest.mark.parametrize("case", sorted(HEAD_CASES))
def test_heads_match_jax(case):
    theads, jheads, params = _pair(HEAD_CASES[case])
    base = _compare(theads, jheads, params, _feats(), gradnorm_mode=True)
    refined = _compare(theads, jheads, params, _feats())
    # the refinement fires below the coarsest rank and leaves that rank alone
    np.testing.assert_array_equal(refined["taxa_L30"].numpy(), base["taxa_L30"].numpy())
    changed = [t for t in TASKS[:-1] if not torch.equal(refined[t], base[t])]
    hierarchical = [t for t in TASKS[:-1] if HEAD_CASES[case][t]["TYPE"] != "Linear"]
    assert changed == hierarchical


@pytest.mark.parametrize("case", ["conditional_soft", "conditional_hard", "hierarchical_softmax"])
def test_training_mode_routing_matches_jax(case):
    """In training ``hard`` routing falls back to the soft one, as in JAX."""
    theads, jheads, params = _pair(HEAD_CASES[case])
    _compare(theads, jheads, params, _feats(seed=3), training=True)


def test_hard_routing_differs_from_soft():
    feats = _feats(seed=4)
    hard = _pair(HEAD_CASES["conditional_hard"])[0].eval()(torch.tensor(feats))
    soft_cfg = {t: {"TYPE": "ConditionalClassifier", "ROUTING_STRATEGY": "soft"} for t in TASKS}
    soft = _pair(soft_cfg)[0].eval()(torch.tensor(feats))
    assert not torch.allclose(hard["taxa_L10"], soft["taxa_L10"])


def test_gumbel_routing_against_numpy_on_the_same_draws():
    cfg = {t: {"TYPE": "ConditionalClassifier", "ROUTING_STRATEGY": "gumbel",
               "TEMPERATURE": 0.5} for t in TASKS}
    theads, _, params = _pair(cfg)
    feats = _feats(seed=5)
    theads.generator = torch.Generator().manual_seed(123)
    theads.train()
    with torch.no_grad():
        ours = theads(torch.tensor(feats))
    # numpy on the same draws: the generator replayed in the same order
    # (coarse to fine, one draw of the parent's shape a level)
    replay = torch.Generator().manual_seed(123)
    ttree, _ = _trees()
    mats = ttree.build_hierarchy_matrices()

    def softmax(z):
        z = z - z.max(-1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(-1, keepdims=True)

    base = {t: feats @ params[f"head_{t}"]["Dense_0"]["kernel"] + params[f"head_{t}"]["Dense_0"]["bias"]
            for t in TASKS}
    want = dict(base)
    for child, parent in (("taxa_L20", "taxa_L30"), ("taxa_L10", "taxa_L20")):
        g = gumbel_noise(torch.Size(want[parent].shape), replay, torch.device("cpu")).numpy()
        probs = softmax((want[parent] + g) / 0.5)
        want[child] = base[child] + np.log(probs @ mats[f"{parent}_{child}"] + 1e-10)
    for t in TASKS:
        np.testing.assert_allclose(ours[t].numpy(), want[t], atol=1e-5, err_msg=t)
    # other draws give other logits; eval mode routes softly and draws nothing
    with torch.no_grad():
        again = theads(torch.tensor(feats))
        assert not torch.allclose(again["taxa_L10"], ours["taxa_L10"])
        state = theads.generator.get_state()
        theads.eval()
        theads(torch.tensor(feats))
    assert torch.equal(theads.generator.get_state(), state)


def test_gumbel_in_training_needs_the_generator():
    cfg = {t: {"TYPE": "ConditionalClassifier", "ROUTING_STRATEGY": "gumbel"} for t in TASKS}
    theads = _pair(cfg)[0].train()
    with pytest.raises(ValueError, match="generator"):
        theads(torch.tensor(_feats()))


def test_matrices_are_float32_buffers_outside_the_state_dict():
    theads, _, _ = _pair(HEAD_CASES["hierarchical_softmax"])
    assert set(theads.state_dict()) == {f"{t}.fc.{p}" for t in TASKS for p in ("weight", "bias")}
    buffers = dict(theads.named_buffers())
    assert sorted(buffers) == ["hierarchy_taxa_L20_taxa_L10", "hierarchy_taxa_L30_taxa_L20"]
    assert all(b.dtype == torch.float32 for b in buffers.values())
    assert theads.matrix("taxa_L20_taxa_L10").shape == (5, 9)


@pytest.mark.parametrize("heads", [
    {t: {"TYPE": "Linear"} for t in TASKS},
    {"taxa_L10": {"TYPE": "HierarchicalSoftmax"}},
    {"taxa_L20": {"TYPE": "ConditionalClassifier"}},
    {"taxa_L10": {"TYPE": "Conv1d", "KERNEL_SIZE": 1}},
    {},
])
def test_no_taxonomy_tree_raises_where_jax_raises(heads):
    def outcome(fn):
        try:
            fn()
            return None
        except ValueError as e:
            return "no taxonomy_tree" in str(e)

    assert outcome(lambda: configure_classification_heads(heads, NC, list(TASKS), FEATS)) == \
        outcome(lambda: jconfigure(heads, NC, list(TASKS)))
    tcfg, jcfg = _tiny_config(heads, tconf), _tiny_config(heads, jconf)
    ours = outcome(lambda: build_model(tcfg, NC, None, device="cpu"))
    assert ours == outcome(lambda: jbuild_model(jcfg, NC, None))
    assert ours == (True if any(h.get("TYPE") in ("HierarchicalSoftmax", "ConditionalClassifier")
                                for h in heads.values()) else None)
    # the keyword form too
    spec = {"CONVNEXT": {"DEPTHS": [1, 1, 1, 1], "DIMS": [8, 16, 32, 64]},
            "ROPE": {"DEPTHS": [1, 1], "DIMS": [32, 64], "NUM_HEADS": [2, 2]}}
    assert outcome(lambda: build_model(spec, 64, NC, head_configs=heads, device="cpu")) == ours


def _tiny_config(heads, conf, fp32=True):
    """A tiny mFormerV1 config of ``conf``'s package: three tasks,
    TEMPORAL + SPATIAL metadata, 64 px, float32 when ``fp32``."""
    cfg = conf.get_default_config()
    (tarchs if conf is tconf else jarchs).apply_arch(cfg, "mFormerV1_sm")
    cfg.set_new_allowed(True)
    cfg.merge_from_other_cfg({
        "DATA": {"TASK_KEYS_H5": list(TASKS)},
        "MODEL": {"TYPE": "mFormerV1", "IMG_SIZE": 64, "DROP_PATH_RATE": 0.0,
                  "CONVNEXT_STAGES": {"DEPTHS": [1, 1, 1, 1], "DIMS": [8, 16, 32, 64]},
                  "ROPE_STAGES": {"DEPTHS": [1, 1], "DIMS": [32, 64], "NUM_HEADS": [2, 2]},
                  "CLASSIFICATION": {"HEADS": heads}},
        "TRAIN": {"GRADIENT_CHECKPOINTING": {"ENABLED_NORMAL_STEPS": False}},
    })
    if fp32:
        cfg.TRAIN.MIXED_PRECISION.ENABLED = False
        cfg.TRAIN.AMP_OPT_LEVEL = "O0"
    return cfg


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jfm.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("case", ["hierarchical_softmax", "mixed"])
def test_tiny_model_with_hierarchical_heads_matches_jax(interpret_mode, case):
    heads = HEAD_CASES[case]
    ttree, jtree = _trees()
    jm = jbuild_model(_tiny_config(heads, jconf), NC, jtree)
    rng = np.random.default_rng(0)
    images = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    meta = rng.normal(size=(2, 5)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(meta))["params"]
    noise = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * noise.normal(size=a.shape).astype(np.float32), params)
    ref = jm.apply({"params": params}, jnp.asarray(images), jnp.asarray(meta))
    model = build_model(_tiny_config(heads, tconf), NC, ttree, device="cpu")
    assert model.dtype == torch.float32
    model.load_state_dict(state_dict_from_jax(params, (1, 1), (1, 1), ("TEMPORAL", "SPATIAL"),
                                              TASKS), strict=True)
    with torch.no_grad():
        out = model(torch.tensor(images), torch.tensor(meta))
    for t in TASKS:
        np.testing.assert_allclose(out[t].numpy(), np.asarray(ref[t]), atol=MODEL_TOL, err_msg=t)
    # the refinement is part of what was compared
    with torch.no_grad():
        base = model.head(model.forward_features(torch.tensor(images), torch.tensor(meta)),
                          gradnorm_mode=True)
    assert not torch.allclose(base["taxa_L10"], out["taxa_L10"])


def test_heads_without_matrices_give_base_logits_as_in_jax():
    """The module itself, as in JAX, refines only with matrices; the
    build functions raise before that (above)."""
    heads = HEAD_CASES["hierarchical_softmax"]
    _, _, params = _pair(heads)
    jheads = JHeads(task_keys=TASKS, num_classes=NC, head_configs=heads)
    theads = MultiTaskHeads(FEATS, TASKS, NC, heads)
    theads.load_state_dict(_head_state(params), strict=True)
    assert not theads.pairs
    _compare(theads, jheads, params, _feats(seed=6))
