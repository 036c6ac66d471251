"""The port's registries, aggregations, resolvers, attention zoo and misc
blocks against the TPU package's.

Every module is initialised in JAX at a tiny size, its parameters moved by
seeded numpy noise, copied into the port's module and both are run on the
same seeded input; float32 outputs agree to 2e-6 (the per-block bar), the
zoo's softmax modules to 5e-6. mFormerV1 is built with every
MODEL.AGGREGATION.TYPE, its weights bridged with ``state_dict_from_jax``,
and its logits held to 4e-5 (the model bar). The factory's ``list_*`` name
what the JAX registries name.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import linnaeus_tpu.ops.fused_mlp as jfm
from linnaeus_tpu.configuration import get_default_config as j_default
from linnaeus_tpu.models import MFormerV1 as JMFormerV1
from linnaeus_tpu.models import aggregation as jagg
from linnaeus_tpu.models import factory as jfactory
from linnaeus_tpu.models.attention import zoo as jzoo
from linnaeus_tpu.models.blocks import misc as jmisc
from linnaeus_tpu_torch.configuration import get_default_config as t_default
from linnaeus_tpu_torch.models import aggregation as tagg
from linnaeus_tpu_torch.models import factory as tfactory
from linnaeus_tpu_torch.models.attention import zoo as tzoo
from linnaeus_tpu_torch.models.blocks import misc as tmisc
from linnaeus_tpu_torch.models.mformer_v1 import MFormerV1
from linnaeus_tpu_torch.utils import convert

BLOCK_ATOL = 2e-6
ZOO_ATOL = 5e-6
TASKS = ("taxa_L10", "taxa_L20")
NC = {"taxa_L10": 7, "taxa_L20": 3}
META = (("TEMPORAL", 2), ("SPATIAL", 3))


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jfm.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def seeded(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def init(module, *args, seed=1, scale=0.05, **kw):
    variables = module.init(jax.random.PRNGKey(0), *map(jnp.asarray, args), **kw)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + scale * rng.normal(size=a.shape)
                        .astype(np.float32), variables).get("params", {})


def load(module, params, entries):
    module.load_state_dict(convert._gather(params, entries), strict=True)
    return module


def close(got, want, atol):
    if isinstance(got, tuple):
        got = got[0]
    if isinstance(want, tuple):
        want = want[0]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


def test_the_registries_name_what_the_jax_registries_name():
    import linnaeus_tpu.models  # noqa: F401  (fills the JAX registries)

    for kind in ("models", "heads", "attention", "aggregations", "resolvers"):
        assert getattr(tfactory, f"list_{kind}")() == getattr(jfactory, f"list_{kind}")(), kind
    assert tfactory.create_model("mFormerV1", img_size=(32, 32), convnext_depths=(1, 1, 1, 1),
                                 convnext_dims=(8, 16, 32, 64), rope_depths=(1, 1),
                                 rope_dims=(32, 64), rope_num_heads=(2, 2)).__class__ is MFormerV1
    assert isinstance(tfactory.create_aggregation("default"), tagg.IdentityAggregation)
    for create in (tfactory.create_model, tfactory.create_head, tfactory.create_attention,
                   tfactory.create_aggregation, tfactory.create_resolver):
        with pytest.raises(ValueError, match="Unknown .* 'nope'. Available"):
            create("nope")


# ---------------------------------------------------------------- aggregation
@pytest.mark.parametrize("name", ["AdaptivePooling", "Concatenation", "Conv1d", "Identity",
                                  "default"])
def test_aggregations_match_jax(name):
    tokens = seeded(3, 4, 16)
    kw = {"out_features": 12} if name == "Concatenation" else {}
    jmod = jfactory.AGGREGATION_REGISTRY[name](**kw)
    params = init(jmod, tokens)
    if name == "Concatenation":
        tmod = load(tagg.ConcatenationAggregation(64, 12), params, convert._linear("fc", ("Dense_0",)))
    elif name == "Conv1d":
        tmod = load(tagg.Conv1dAggregation(4), params, convert._linear("fc", ("Dense_0",)))
    else:
        tmod = tfactory.AGGREGATION_REGISTRY[name]()
    close(tmod(torch.tensor(tokens)), jmod.apply({"params": params}, jnp.asarray(tokens)),
          BLOCK_ATOL)


@pytest.mark.parametrize("name", ["LearnedProjection", "AdaptivePooling", "Concatenation",
                                  "Identity"])
def test_resolvers_match_jax(name):
    feats = seeded(3, 20)
    if name in ("LearnedProjection", "AdaptivePooling"):
        jmod = jfactory.RESOLVER_REGISTRY[name](projection_dim=7)
    else:
        jmod = jfactory.RESOLVER_REGISTRY[name]()
    args = (feats, seeded(3, 5, seed=4)) if name == "Concatenation" else (feats,)
    params = init(jmod, *args)
    if name == "LearnedProjection":
        tmod = load(tagg.LearnedProjectionResolver(20, 7), params,
                    convert._linear("fc", ("Dense_0",)))
    elif name == "AdaptivePooling":
        tmod = tagg.AdaptivePoolingResolver(7)
    else:
        tmod = tfactory.RESOLVER_REGISTRY[name]()
    close(tmod(*map(torch.tensor, args)),
          jmod.apply({"params": params}, *map(jnp.asarray, args)), BLOCK_ATOL)


def test_configure_builders_read_the_config_as_jax_does():
    for agg, out in (("Concatenation", 33), ("AdaptivePooling", None), ("Identity", None),
                     ("Conv1d", None)):
        jcfg, tcfg = j_default(), t_default()
        for cfg in (jcfg, tcfg):
            cfg.MODEL.AGGREGATION.TYPE = agg
            cfg.MODEL.AGGREGATION.PARAMETERS = {"out_channels": out} if out else {}
        jmod, tmod = jagg.configure_aggregation_layer(jcfg), tagg.configure_aggregation_layer(
            tcfg, num_tokens=2, dim=16)
        assert type(tmod).__name__ == type(jmod).__name__
        if out:
            assert tmod.fc.out_features == jmod.out_features == out
    for res in ("LearnedProjection", "AdaptivePooling", "Concatenation", "Identity"):
        jcfg, tcfg = j_default(), t_default()
        for cfg in (jcfg, tcfg):
            cfg.MODEL.FEATURE_RESOLVER.TYPE = res
            cfg.MODEL.FEATURE_RESOLVER.PARAMETERS = {"projection_dim": 9}
        jmod, tmod = (jagg.configure_feature_resolver(jcfg),
                      tagg.configure_feature_resolver(tcfg, in_features=16))
        assert type(tmod).__name__ == type(jmod).__name__
        if res != "Concatenation" and res != "Identity":
            assert getattr(jmod, "projection_dim") == 9
    tcfg.MODEL.FEATURE_RESOLVER.TYPE = "nope"
    with pytest.raises(ValueError, match="Unknown resolver TYPE 'nope'"):
        tagg.configure_feature_resolver(tcfg, 16)


# ---------------------------------------------------------------- attention
def _attn_case(name):
    """(jax module, port module builder from params, inputs, extra kwargs)."""
    grid = seeded(2, 6, 6, 16, seed=2)
    tokens = seeded(2, 9, 16, seed=3)
    lin = convert._linear
    if name == "CBAM":
        return (jzoo.CBAM(reduction=4), (grid,),
                lambda p: load(tzoo.CBAM(16, reduction=4), p,
                               lin("mlp.0", ("Dense_0",)) + lin("mlp.2", ("Dense_1",))
                               + convert._conv2d("spatial", ("Conv_0",))), {})
    if name == "ECA":
        return (jzoo.ECA(kernel_size=3), (grid,),
                lambda p: load(tzoo.ECA(3), p, [("conv.weight", ("Conv_0", "kernel"),
                                                 lambda k: np.transpose(k, (2, 1, 0))),
                                                ("conv.bias", ("Conv_0", "bias"), None)]), {})
    if name == "Linformer":
        return (jzoo.LinformerAttention(dim=16, num_heads=2, proj_k=4), (tokens,),
                lambda p: load(tzoo.LinformerAttention(16, 9, num_heads=2, proj_k=4), p,
                               lin("qkv", ("qkv",)) + lin("proj", ("proj",))
                               + [("E", ("E",), None)]), {})
    if name == "EfficientSelfAttention":
        return (jzoo.EfficientSelfAttention(dim=16, num_heads=2, sr_ratio=2), (tokens,),
                lambda p: load(tzoo.EfficientSelfAttention(16, 2, 2), p,
                               lin("q", ("q",)) + lin("kv", ("kv",)) + lin("proj", ("proj",))
                               + convert._conv2d("sr", ("sr",))
                               + convert._norm("norm", ("LayerNorm_0",))), {"H": 3, "W": 3})
    if name == "DifferentialAttention":
        return (jzoo.DifferentialAttention(dim=16, num_heads=2), (tokens,),
                lambda p: load(tzoo.DifferentialAttention(16, 2), p,
                               lin("qkv", ("qkv",)) + lin("proj", ("proj",))
                               + [("lam", ("lam",), None)]), {})
    if name == "TaskSpecificAttention":
        return (jzoo.TaskSpecificAttention(dim=16, num_tasks=3), (tokens,),
                lambda p: load(tzoo.TaskSpecificAttention(16, 3), p,
                               [("task_queries", ("task_queries",), None)]), {})
    return (jzoo.HierarchicalAttention(dim=16, num_tasks=3), (tokens,),
            lambda p: load(tzoo.HierarchicalAttention(16, 3), p,
                           [("task_queries", ("task_queries",), None)] + lin("cond", ("cond",))),
            {})


@pytest.mark.parametrize("name", ["CBAM", "ECA", "Linformer", "EfficientSelfAttention",
                                  "DifferentialAttention", "TaskSpecificAttention",
                                  "HierarchicalAttention"])
def test_attention_zoo_matches_jax(name):
    jmod, args, build, kw = _attn_case(name)
    assert tfactory.ATTENTION_REGISTRY[name].__name__ == type(jmod).__name__
    params = init(jmod, *args, scale=0.3, **kw)
    tmod = build(params)
    got = tmod(*map(torch.tensor, args), **kw)
    close(got, jmod.apply({"params": params}, *map(jnp.asarray, args), **kw), ZOO_ATOL)


def test_diff_transformer_block_and_progressive_patch_embed_match_jax():
    tokens = seeded(2, 9, 16, seed=5)
    jblk = jmisc.DiffTransformerBlock(dim=16, num_heads=2)
    params = init(jblk, tokens)
    lin = convert._linear
    tblk = load(tmisc.DiffTransformerBlock(16, num_heads=2), params,
                convert._norm("norm1", ("norm1",)) + convert._norm("norm2", ("norm2",))
                + lin("attn.qkv", ("attn", "qkv")) + lin("attn.proj", ("attn", "proj"))
                + [("attn.lam", ("attn", "lam"), None)]
                + lin("mlp.fc1", ("mlp", "Dense_0")) + lin("mlp.fc2", ("mlp", "Dense_1")))
    close(tblk(torch.tensor(tokens)), jblk.apply({"params": params}, jnp.asarray(tokens)),
          ZOO_ATOL)

    grid = seeded(2, 16, 16, 3, seed=6)
    for stages in (2, 3):
        jpe = jmisc.ProgressivePatchEmbed(embed_dim=32, num_stages=stages)
        params = init(jpe, grid)
        entries = []
        for i in range(stages):
            entries += convert._conv2d(f"conv{i}", (f"conv{i}",))
            entries += convert._norm(f"norm{i}", (f"norm{i}",))
        tpe = load(tmisc.ProgressivePatchEmbed(3, 32, num_stages=stages), params, entries)
        (got, h, w), (want, jh, jw) = tpe(torch.tensor(grid)), jpe.apply({"params": params},
                                                                          jnp.asarray(grid))
        assert (h, w) == (jh, jw) == (16 >> stages, 16 >> stages)
        close(got, want, BLOCK_ATOL)


# ------------------------------------------------- mFormerV1 with each aggregation
@pytest.mark.parametrize("aggregation", ["Conv1d", "default", "AdaptivePooling",
                                         "Concatenation", "Identity"])
def test_mformer_v1_with_each_aggregation_matches_jax(aggregation):
    kw = dict(img_size=(32, 32), convnext_depths=(1, 1, 1, 1), convnext_dims=(8, 16, 32, 64),
              rope_depths=(1, 1), rope_dims=(32, 64), rope_num_heads=(2, 2), drop_path_rate=0.0,
              meta_components=META, task_keys=TASKS, num_classes=NC, aggregation=aggregation)
    images, meta = seeded(2, 32, 32, 3, seed=7), seeded(2, 5, seed=8)
    jm = JMFormerV1(head_configs={t: {"TYPE": "Linear"} for t in TASKS}, **kw)
    params = init(jm, images, meta)
    model = MFormerV1(**kw)
    model.load_state_dict(convert.state_dict_from_jax(params, (1, 1), (1, 1),
                                                      ("TEMPORAL", "SPATIAL"), TASKS), strict=True)
    assert sorted(convert.jax_layouts(model)) == sorted(n for n, _ in model.named_parameters())
    with torch.no_grad():
        out = model.eval()(torch.tensor(images), torch.tensor(meta))
    ref = jm.apply({"params": params}, jnp.asarray(images), jnp.asarray(meta))
    for t in TASKS:
        np.testing.assert_allclose(out[t].numpy(), np.asarray(ref[t]), atol=4e-5, rtol=0)
