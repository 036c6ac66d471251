"""The port's parameter filters against the TPU package's.

A tiny mFormerV1 with metadata heads, a Conv1d head and hierarchical heads
is built by both packages; each filter is evaluated by the JAX functions on
the Flax params and by the port's on the torch model (through the Flax path
and layout of every parameter), and the selected sets of Flax paths must be
equal: the default GradNorm EXCLUDE_CONFIG, the ``["head_"]`` pattern of
configs/experiments/generic_mformer_example.yaml, dimension bounds, and
nested and / or / not filters. Labels, trunk masks and the inspection
report are compared too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linnaeus_tpu.configuration.defaults import get_default_config
from linnaeus_tpu.models import MFormerV1 as JMFormerV1
from linnaeus_tpu.utils import param_filters as jpf
from linnaeus_tpu.utils.taxonomy import TaxonomyTree as JTree
from linnaeus_tpu_torch.models.build import build_model
from linnaeus_tpu_torch.utils import param_filters as tpf
from linnaeus_tpu_torch.utils.convert import jax_layouts, state_dict_from_jax
from linnaeus_tpu_torch.utils.taxonomy import TaxonomyTree

TASKS = ("taxa_L10", "taxa_L20", "taxa_L30")
NC = {"taxa_L10": 9, "taxa_L20": 5, "taxa_L30": 3}
HIERARCHY = {
    "taxa_L10": {1: 1, 2: 1, 3: 2, 4: 2, 5: 3, 6: 3, 7: 4, 8: 4},
    "taxa_L20": {1: 1, 2: 1, 3: 2, 4: 2},
}
HEADS = {
    "taxa_L10": {"TYPE": "HierarchicalSoftmax"},
    "taxa_L20": {"TYPE": "ConditionalClassifier", "ROUTING_STRATEGY": "soft"},
    "taxa_L30": {"TYPE": "Conv1d", "KERNEL_SIZE": 3},
}
META = (("TEMPORAL", 2), ("SPATIAL", 3))
DEPTHS, ROPE_DEPTHS = (1, 1, 1, 1), (1, 1)
SPEC = {
    "CONVNEXT": {"DEPTHS": list(DEPTHS), "DIMS": [8, 16, 32, 64]},
    "ROPE": {"DEPTHS": list(ROPE_DEPTHS), "DIMS": [32, 64], "NUM_HEADS": [2, 2]},
    "DROP_PATH_RATE": 0.0,
}

FILTERS = {
    "default_exclude": dict(get_default_config().LOSS.GRAD_WEIGHTING.TASK.EXCLUDE_CONFIG),
    "head_": {"TYPE": "name", "PATTERNS": ["head_"]},
    "min_ndim_2": {"TYPE": "dimension", "MIN_NDIM": 2},
    "max_ndim_1": {"TYPE": "dimension", "MAX_NDIM": 1},
    "ndim_3": {"TYPE": "dimension", "MIN_NDIM": 3, "MAX_NDIM": 3},
    "stage3_matrices": {"TYPE": "and", "FILTERS": [
        {"TYPE": "name", "PATTERNS": ["stage3_"]},
        {"TYPE": "not", "FILTERS": [{"TYPE": "dimension", "MAX_NDIM": 1}]}]},
    "nested": {"TYPE": "or", "FILTERS": [
        {"TYPE": "and", "FILTERS": [{"TYPE": "name", "PATTERNS": ["Dense_0", "qkv"]},
                                    {"TYPE": "dimension", "MIN_NDIM": 2}]},
        {"TYPE": "not", "FILTERS": [{"TYPE": "name", "PATTERNS": ["stage", "head", "meta_",
                                                                  "downsample"]}]}]},
}


@pytest.fixture(scope="module")
def models():
    jtree = JTree(HIERARCHY, list(TASKS), dict(NC))
    jm = JMFormerV1(
        img_size=(64, 64), convnext_depths=DEPTHS, convnext_dims=(8, 16, 32, 64),
        rope_depths=ROPE_DEPTHS, rope_dims=(32, 64), rope_num_heads=(2, 2),
        drop_path_rate=0.0, meta_components=META, task_keys=TASKS, num_classes=NC,
        head_configs=HEADS, hierarchy_matrices=jtree.build_hierarchy_matrices(),
    )
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 64, 64, 3)), jnp.zeros((2, 5)))["params"]
    params = jax.tree.map(np.asarray, params)
    model = build_model(SPEC, 64, NC, META, head_configs=HEADS, device="cpu",
                        taxonomy_tree=TaxonomyTree(HIERARCHY, list(TASKS), dict(NC)))
    model.load_state_dict(state_dict_from_jax(params, DEPTHS, ROPE_DEPTHS,
                                              ("TEMPORAL", "SPATIAL"), TASKS), strict=True)
    return params, model


def _jax_paths(params):
    return sorted(jpf._path_str(p) for p, _ in jax.tree_util.tree_leaves_with_path(params))


def test_every_parameter_has_its_flax_path_and_layout(models):
    params, model = models
    layouts = jax_layouts(model)
    assert sorted(lay.path for lay in layouts.values()) == _jax_paths(params)
    leaves = {jpf._path_str(p): leaf for p, leaf in jax.tree_util.tree_leaves_with_path(params)}
    for name, p in model.named_parameters():
        lay = layouts[name]
        view = lay.to_jax(p.detach())
        np.testing.assert_array_equal(view.numpy(), leaves[lay.path], err_msg=name)
        assert torch.equal(lay.from_jax(view), p.detach())


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_selected_sets_match_jax(models, name):
    params, model = models
    cfg = FILTERS[name]
    want = jpf.list_matching(params, jpf.build_filter_from_config(cfg))
    got = tpf.list_matching(model, tpf.build_filter_from_config(cfg))
    assert got == want
    assert 0 < len(got) < len(_jax_paths(params))


def test_head_pattern_selects_the_heads_in_both(models):
    """``head_`` is a Flax-path pattern: it selects every classification head
    (head/head_<task>/...) and the metadata heads (meta_*_head_<stage>), and
    no torch name is matched against."""
    _, model = models
    mask = tpf.param_mask(model, tpf.build_filter_from_config(FILTERS["head_"]))
    selected = {n for n, on in mask.items() if on}
    assert {f"head.{t}.fc.weight" for t in TASKS} <= selected
    assert all(n.startswith(("head.", "meta_")) for n in selected)


def test_labels_trunk_mask_and_report_match_jax(models):
    params, model = models
    groups_cfg = {"HEADS": FILTERS["head_"], "MATRICES": FILTERS["min_ndim_2"]}
    jgroups = {g: jpf.build_filter_from_config(c) for g, c in groups_cfg.items()}
    tgroups = {g: tpf.build_filter_from_config(c) for g, c in groups_cfg.items()}
    layouts = jax_layouts(model)
    jlabels = {jpf._path_str(p): v for p, v in jax.tree_util.tree_leaves_with_path(
        jpf.param_labels(params, jgroups))}
    tlabels = tpf.param_labels(model, tgroups)
    assert {layouts[n].path: v for n, v in tlabels.items()} == jlabels
    assert set(tlabels.values()) == {"HEADS", "MATRICES", "default"}

    exclude = tpf.resolve_gradnorm_exclude(get_default_config().LOSS.GRAD_WEIGHTING.TASK)
    jmask = {jpf._path_str(p): bool(v) for p, v in jax.tree_util.tree_leaves_with_path(
        jpf.trunk_mask_from_exclude(params, exclude))}
    tmask = tpf.trunk_mask_from_exclude(model, exclude)
    assert {layouts[n].path: v for n, v in tmask.items()} == jmask
    assert tpf.filtering_report(model, tgroups) == jpf.filtering_report(params, jgroups)


def test_legacy_exclude_patterns_and_bad_filters():
    cfg = get_default_config().LOSS.GRAD_WEIGHTING.TASK
    cfg.defrost()
    cfg.EXCLUDE_CONFIG.FILTERS = []
    cfg.EXCLUDE_PATTERNS = ["head", "meta_"]
    assert tpf.resolve_gradnorm_exclude(cfg) == jpf.resolve_gradnorm_exclude(cfg)
    for bad in ({"TYPE": "regex"}, {"TYPE": "not", "FILTERS": []}):
        with pytest.raises(ValueError):
            tpf.build_filter_from_config(bad)
