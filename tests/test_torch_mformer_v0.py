"""The port's mFormerV0 against the TPU package's on the same weights.

The tiny geometry of tests/test_mformer_v0.py (64 px, dims (8, 12, 24, 32,
64), MBConv depths (1, 1), attention depths (1, 1), 2 heads, metadata
TEMPORAL(2) + SPATIAL(3)) is initialised in JAX, its params and running
statistics are moved with seeded numpy noise so every branch contributes,
bridged with ``utils/convert.py::load_jax_variables`` and loaded strict.

Bars, float32: whole-model logits 4e-5, each block 2e-6, BatchNorm running
statistics 1e-6 after training-mode forwards; bfloat16 compute: logits
0.05, the bar of tests/test_torch_mformer_v1.py. Two regression cases hold
what a port that copied torch's defaults would get wrong, each shown to
exceed its bar: torch's BatchNorm updates the running variance with the
unbiased batch variance (Flax with the biased one), and torch's symmetric
``padding=1`` at stride 2 is not Flax's "SAME" (0, 1).
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from linnaeus_tpu.configuration import get_default_config as j_default
from linnaeus_tpu.configuration import load_config as j_load
from linnaeus_tpu.configuration import merge_configs as j_merge
from linnaeus_tpu.models import MFormerV0 as JMFormerV0
from linnaeus_tpu.models import build_model as j_build
from linnaeus_tpu.models.blocks import mbconv as jmb
from linnaeus_tpu.models.blocks import relative_mhsa as jrel
from linnaeus_tpu.utils.model_utils import interpolate_rel_pos_bias as j_interp
from linnaeus_tpu_torch.configuration import get_default_config as t_default
from linnaeus_tpu_torch.configuration import load_config as t_load
from linnaeus_tpu_torch.configuration import merge_configs as t_merge
from linnaeus_tpu_torch.models.blocks.common import BatchNorm
from linnaeus_tpu_torch.models.blocks.mbconv import MBConvBlock, SqueezeExcite, same_padding
from linnaeus_tpu_torch.models.blocks.relative_mhsa import (
    OverlapPatchEmbed,
    RelativeAttention,
    RelativeMHSABlock,
    build_relative_position_index,
)
from linnaeus_tpu_torch.models.build import build_model
from linnaeus_tpu_torch.models.mformer_v0 import MFormerV0
from linnaeus_tpu_torch.utils import convert
from linnaeus_tpu_torch.utils.model_utils import interpolate_rel_pos_bias

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS = ("taxa_L10", "taxa_L20")
NC = {"taxa_L10": 7, "taxa_L20": 3}
META = (("TEMPORAL", 2), ("SPATIAL", 3))
TINY = dict(img_size=(64, 64), stage_dims=(8, 12, 24, 32, 64), mbconv_depths=(1, 1),
            attn_depths=(1, 1), num_heads=(2, 2), drop_path_rate=0.0, meta_components=META,
            task_keys=TASKS, num_classes=NC, head_configs={t: {"TYPE": "Linear"} for t in TASKS})
BLOCK_ATOL = 2e-6
STATS_TOL = 1e-6


def noisy(tree, rng, scale=0.05):
    """Every leaf moved by seeded noise; running variances kept positive."""
    out = jax.tree.map(lambda a: np.asarray(a) + scale * rng.normal(size=a.shape)
                       .astype(np.float32), tree)
    if "batch_stats" in out:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, a: np.abs(a) + 0.5 if path[-1].key == "var" else a,
            out["batch_stats"])
    return out


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def gather(tree, entries):
    return convert._gather(tree, entries)


def close(got, want, atol, rtol=0.0, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol, err_msg=msg)


# ------------------------------------------------------------------ BatchNorm
def _bn_pair(eps, dtype, x):
    """A Flax BatchNorm and the port's on the same seeded scale, bias and
    running statistics."""
    jbn = fnn.BatchNorm(momentum=0.9, epsilon=eps, dtype=dtype)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=True)
    variables = noisy(variables, np.random.default_rng(3), scale=0.3)
    tbn = BatchNorm(x.shape[-1], eps=eps)
    with torch.no_grad():
        tbn.weight.copy_(torch.tensor(variables["params"]["scale"]))
        tbn.bias.copy_(torch.tensor(variables["params"]["bias"]))
        tbn.running_mean.copy_(torch.tensor(variables["batch_stats"]["mean"]))
        tbn.running_var.copy_(torch.tensor(variables["batch_stats"]["var"]))
    return jbn, variables, tbn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eps", [1e-5, 0.01])
def test_batchnorm_matches_flax_in_train_and_eval(dtype, eps):
    rng = np.random.default_rng(0)
    x = (1.5 * rng.normal(size=(4, 6, 6, 3)) + 0.7).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jbn, variables, tbn = _bn_pair(eps, jdt, x)
    xj, xt = jnp.asarray(x, jdt), torch.tensor(x).to(tdt)
    out_bar = BLOCK_ATOL if dtype == "float32" else 2e-2

    # training mode: batch statistics, the buffers updated once
    yj, mutated = jbn.apply(variables, xj, use_running_average=False, mutable=["batch_stats"])
    tbn.train()
    yt = tbn(xt)
    assert yt.dtype == tdt
    close(yt, yj, out_bar)
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        close(getattr(tbn, ours), mutated["batch_stats"][theirs], STATS_TOL, STATS_TOL)

    # eval mode: the buffers normalise and stay as they are
    before = {k: v.clone() for k, v in tbn.state_dict().items()}
    tbn.eval()
    yt = tbn(xt)
    yj = jbn.apply({"params": variables["params"], **mutated}, xj, use_running_average=True)
    close(yt, yj, out_bar)
    assert all(torch.equal(v, tbn.state_dict()[k]) for k, v in before.items())


def test_batchnorm_running_variance_is_biased_where_torch_is_not():
    """The case of a (4, 6, 6, 3) batch from var 1, Flax momentum 0.9:
    torch's own update (unbiased, its momentum 0.1) misses Flax's running
    variance by far more than the bar; the port's meets it."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 6, 6, 3)).astype(np.float32)
    jbn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=True)
    _, mutated = jbn.apply(variables, jnp.asarray(x), use_running_average=False,
                           mutable=["batch_stats"])
    want = np.asarray(mutated["batch_stats"]["var"])
    tbn = BatchNorm(3, eps=1e-5).train()
    tbn(torch.tensor(x))
    close(tbn.running_var.numpy(), want, STATS_TOL, STATS_TOL)
    mean, var = torch.zeros(3), torch.ones(3)
    F.batch_norm(torch.tensor(x).permute(0, 3, 1, 2), mean, var, training=True, momentum=0.1)
    assert np.abs(var.numpy() - want).max() > 100 * STATS_TOL


# -------------------------------------------------------------------- MBConv
def _mbconv_sd(tree, stats):
    entries = (convert._conv_kernel("_expand_conv", ("expand_conv",))
               + convert._conv_kernel("_depthwise_conv", ("depthwise_conv",))
               + convert._conv2d("_se_reduce", ("se", "reduce"))
               + convert._conv2d("_se_expand", ("se", "expand"))
               + convert._conv_kernel("_project_conv", ("project_conv",)))
    for ours, theirs in convert._MBCONV_BNS:
        entries += convert._norm(ours, (theirs,))
    sd = gather(tree, entries)
    for ours, theirs in convert._MBCONV_BNS:
        sd.update(gather(stats, [(f"{ours}.running_mean", (theirs, "mean"), None),
                                 (f"{ours}.running_var", (theirs, "var"), None)]))
    return sd


@pytest.mark.parametrize("stride,cin,cout,size", [(1, 12, 12, 8), (2, 8, 12, 8), (2, 8, 12, 7)])
def test_mbconv_matches_jax_in_eval_and_training(stride, cin, cout, size):
    rng = np.random.default_rng(stride + size)
    x = rng.normal(size=(3, size, size, cin)).astype(np.float32)
    jblk = jmb.MBConvBlock(input_filters=cin, output_filters=cout, stride=stride)
    variables = noisy(jblk.init(jax.random.PRNGKey(1), jnp.asarray(x)), rng)
    tblk = MBConvBlock(cin, cout, stride=stride)
    tblk.load_state_dict(_mbconv_sd(variables["params"], variables["batch_stats"]), strict=True)
    assert tblk._se_reduce.weight.shape[0] == int(cin * 0.25)  # the input width, not oup
    tblk.eval()
    close(tblk(torch.tensor(x)).detach().numpy(), jblk.apply(variables, jnp.asarray(x)),
          BLOCK_ATOL)
    yj, mutated = jblk.apply(variables, jnp.asarray(x), deterministic=False,
                             mutable=["batch_stats"])
    tblk.train()
    close(tblk(torch.tensor(x)).detach().numpy(), yj, BLOCK_ATOL)
    want = _mbconv_sd(variables["params"], to_np(mutated["batch_stats"]))
    for key, value in tblk.state_dict().items():
        if "running" in key:
            close(value.numpy(), want[key].numpy(), STATS_TOL, STATS_TOL, key)


def test_stride_two_depthwise_pads_as_flax_same():
    """Flax's "SAME" at stride 2 on an even grid pads (0, 1); torch's
    symmetric padding=1 misses it by far more than the block bar."""
    assert same_padding(8, 3, 2) == (0, 1) and same_padding(7, 3, 2) == (1, 1)
    assert same_padding(8, 3, 1) == (1, 1) and same_padding(8, 1, 1) == (0, 0)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    jconv = fnn.Conv(4, (3, 3), strides=(2, 2), padding="SAME", feature_group_count=4,
                     use_bias=False)
    params = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jconv.apply(params, jnp.asarray(x)))
    w = torch.tensor(convert._conv(np.asarray(params["params"]["kernel"])))
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    ours = F.conv2d(F.pad(xt, (0, 1, 0, 1)), w, stride=2, groups=4).permute(0, 2, 3, 1)
    close(ours.numpy(), want, BLOCK_ATOL)
    symmetric = F.conv2d(xt, w, stride=2, padding=1, groups=4).permute(0, 2, 3, 1)
    assert np.abs(symmetric.numpy() - want).max() > 1000 * BLOCK_ATOL
    blk = MBConvBlock(4, 4, stride=2, expand_ratio=1, se_ratio=0.0)
    with torch.no_grad():
        blk._depthwise_conv.weight.copy_(w)
    close(blk._depthwise(torch.tensor(x)).detach().numpy(), want, BLOCK_ATOL)


def test_squeeze_excite_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 5, 16)).astype(np.float32)
    jse = jmb.SqueezeExcite(16, squeeze_base=8)
    variables = noisy(jse.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    tse = SqueezeExcite(16, squeeze_base=8)
    tse.load_state_dict(gather(variables["params"], convert._conv2d("reduce", ("reduce",))
                               + convert._conv2d("expand", ("expand",))), strict=True)
    close(tse(torch.tensor(x)).detach().numpy(), jse.apply(variables, jnp.asarray(x)),
          BLOCK_ATOL)


# --------------------------------------------------------- relative attention
def _attn_entries(dst="", src=()):
    p = f"{dst}." if dst else ""
    return (convert._linear(f"{p}qkv", src + ("qkv",)) + convert._linear(f"{p}proj", src + ("proj",))
            + [(f"{p}relative_position_bias_table", src + ("relative_position_bias_table",),
                None)])


def _block_entries(stride):
    out = []
    if stride == 2:
        out += convert._conv2d("patch_embed.proj", ("patch_embed", "proj"))
        out += convert._norm("patch_embed.norm", ("patch_embed", "LayerNorm_0"))
    out += convert._norm("norm1", ("norm1",)) + _attn_entries("attn", ("attn",))
    out += convert._norm("norm2", ("norm2",))
    out += convert._linear("mlp.fc1", ("mlp", "Dense_0"))
    out += convert._linear("mlp.fc2", ("mlp", "Dense_1"))
    return out


def test_relative_position_index_and_bias_resampling_equal_the_originals():
    for h, w, extra in ((4, 4, 2), (3, 5, 1), (6, 2, 4)):
        np.testing.assert_array_equal(build_relative_position_index(h, w, extra),
                                      jrel.build_relative_position_index(h, w, extra))
    table = np.random.default_rng(7).normal(size=(7 * 7 + 1, 3)).astype(np.float32)
    for dst in ((4, 4), (6, 6), (2, 5)):
        got = interpolate_rel_pos_bias(table, (4, 4), dst)
        np.testing.assert_array_equal(got, j_interp(table, (4, 4), dst))
        np.testing.assert_array_equal(got[-1], table[-1])
    with pytest.raises(ValueError, match="rows"):
        interpolate_rel_pos_bias(table, (3, 3), (4, 4))


def test_overlap_patch_embed_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 8, 8, 12)).astype(np.float32)
    jpe = jrel.OverlapPatchEmbed(embed_dim=16)
    variables = noisy(jpe.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    tpe = OverlapPatchEmbed(12, 16)
    tpe.load_state_dict(gather(variables["params"],
                               convert._conv2d("proj", ("proj",))
                               + convert._norm("norm", ("LayerNorm_0",))), strict=True)
    (yj, hj, wj), (yt, ht, wt) = jpe.apply(variables, jnp.asarray(x)), tpe(torch.tensor(x))
    assert (ht, wt) == (hj, wj) == (4, 4)
    close(yt.detach().numpy(), yj, BLOCK_ATOL)


@pytest.mark.parametrize("fp32_softmax", [True, False])
@pytest.mark.parametrize("head_split", [False, True])
def test_relative_attention_matches_jax(fp32_softmax, head_split):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 2 + 16, 32)).astype(np.float32)
    kw = dict(extra_token_num=2, num_heads=2, qkv_bias=True, attn_fp32_softmax=fp32_softmax,
              head_split=head_split)
    jattn = jrel.RelativeAttention(dim=32, img_size=(4, 4), **kw)
    variables = noisy(jattn.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    tattn = RelativeAttention(32, (4, 4), **kw)
    tattn.load_state_dict(gather(variables["params"], _attn_entries()), strict=True)
    close(tattn(torch.tensor(x)).detach().numpy(), jattn.apply(variables, jnp.asarray(x)),
          BLOCK_ATOL)
    # bf16 compute: the score dtype follows attn_fp32_softmax as in JAX
    jb = jrel.RelativeAttention(dim=32, img_size=(4, 4), dtype=jnp.bfloat16, **kw)
    tattn_bf16 = tattn(torch.tensor(x).bfloat16())
    close(tattn_bf16.float().detach().numpy(),
          jb.apply(variables, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32), 3e-2)


def test_attention_dropout_falls_on_the_probabilities():
    """With every output of the probabilities' dropout zeroed, the
    attention is its projection's bias alone."""
    attn = RelativeAttention(8, (2, 2), extra_token_num=1, num_heads=2, attn_drop=0.5).train()
    attn.attn_drop.forward = lambda p: torch.zeros_like(p)
    out = attn(torch.randn(2, 5, 8))
    close(out.detach().numpy(), attn.proj.bias.detach().expand(2, 5, 8).numpy(), 0.0)


@pytest.mark.parametrize("stride", [2, 1])
def test_relative_mhsa_block_matches_jax(stride):
    rng = np.random.default_rng(10 + stride)
    extras = rng.normal(size=(2, 3, 32)).astype(np.float32)
    if stride == 2:
        x = rng.normal(size=(2, 8, 8, 24)).astype(np.float32)
        kw = dict(input_dim=24, output_dim=32, image_size=(8, 8))
    else:
        x = rng.normal(size=(2, 3 + 16, 32)).astype(np.float32)
        kw = dict(input_dim=32, output_dim=32, image_size=(4, 4))
    common = dict(stride=stride, num_heads=2, extra_token_num=3, qkv_bias=True)
    jblk = jrel.RelativeMHSABlock(**kw, **common)
    jextras = [jnp.asarray(extras[:, i:i + 1]) for i in range(3)] if stride == 2 else None
    variables = noisy(jblk.init(jax.random.PRNGKey(0), jnp.asarray(x), jextras), rng)
    tblk = RelativeMHSABlock(kw["input_dim"], kw["output_dim"], kw["image_size"], **common)
    tblk.load_state_dict(gather(variables["params"], _block_entries(stride)), strict=True)
    got = tblk(torch.tensor(x), torch.tensor(extras) if stride == 2 else None)
    close(got.detach().numpy(), jblk.apply(variables, jnp.asarray(x), jextras), BLOCK_ATOL)


# ---------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def tiny():
    """The JAX model, its noisy variables (params and batch_stats) and the
    inputs."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    meta = rng.normal(size=(4, 5)).astype(np.float32)
    jm = JMFormerV0(**TINY)
    variables = noisy(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(meta)),
                      rng)
    return jm, variables, x, meta


def japply(module, **kw):
    """``module.apply`` compiled, with ``kw`` fixed."""
    return jax.jit(lambda v, x, meta: module.apply(v, x, meta, **kw))


def port_model(variables, **kw):
    model = MFormerV0(**(TINY | kw))
    convert.load_jax_variables(model, variables)
    return model


def test_whole_model_logits_and_running_statistics_match_jax(tiny):
    jm, variables, x, meta = tiny
    model = port_model(variables).eval()
    assert sorted(convert.jax_layouts(model)) == sorted(n for n, _ in model.named_parameters())
    with torch.no_grad():
        out = model(torch.tensor(x), torch.tensor(meta))
    ref = japply(jm)(variables, jnp.asarray(x), jnp.asarray(meta))
    for t in TASKS:
        close(out[t].numpy(), ref[t], 4e-5, msg=t)

    # two training-mode forwards: the logits, and the statistics updated twice
    model.train()
    vs = variables
    train_apply = japply(jm, deterministic=False, mutable=["batch_stats"])
    for _ in range(2):
        ref, mutated = train_apply(vs, jnp.asarray(x), jnp.asarray(meta))
        vs = {"params": variables["params"], "batch_stats": to_np(mutated["batch_stats"])}
        with torch.no_grad():
            out = model(torch.tensor(x), torch.tensor(meta))
        for t in TASKS:
            close(out[t].numpy(), ref[t], 4e-5, msg=t)
    want = convert.state_dict_from_variables(model, vs)
    stats = [k for k in want if "running" in k]
    assert len(stats) == 2 * (3 + 3 + 3)
    for key in stats:
        close(model.state_dict()[key].numpy(), want[key].numpy(), STATS_TOL, STATS_TOL, key)


@pytest.mark.parametrize("fp32_softmax", [True, False])
def test_bf16_logits_match_jax(tiny, fp32_softmax):
    jm, variables, x, meta = tiny
    jb = JMFormerV0(**TINY, dtype=jnp.bfloat16, attn_fp32_softmax=fp32_softmax)
    model = port_model(variables, dtype=torch.bfloat16, attn_fp32_softmax=fp32_softmax).eval()
    with torch.no_grad():
        out = model(torch.tensor(x), torch.tensor(meta))
    ref = japply(jb)(variables, jnp.asarray(x), jnp.asarray(meta))
    for t in TASKS:
        assert out[t].dtype == torch.float32
        close(out[t].numpy(), np.asarray(ref[t], np.float32), 0.05, msg=t)


def test_only_last_cls_and_the_bridge_refuse_what_does_not_fit(tiny):
    jm, variables, x, meta = tiny
    jl = JMFormerV0(**TINY, only_last_cls=True)
    v = noisy(jax.jit(jl.init)(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(meta)),
              np.random.default_rng(2))
    model = port_model(v, only_last_cls=True).eval()
    assert not hasattr(model, "aggregate") and not hasattr(model, "cl_1_fc")
    with torch.no_grad():
        out = model(torch.tensor(x), torch.tensor(meta))
    ref = japply(jl)(v, jnp.asarray(x), jnp.asarray(meta))
    for t in TASKS:
        close(out[t].numpy(), ref[t], 4e-5, msg=t)
    with pytest.raises(ValueError, match="batch_stats"):
        convert.state_dict_from_variables(model, {"params": v["params"]})


def _configs():
    """The default config with configs/model/archs/mFormerV0_sm.yaml merged
    over it, cut to the tiny widths, in both packages."""
    out = []
    os.environ.setdefault("CONFIG_DIR", REPO)
    for default, load, merge in ((j_default, j_load, j_merge), (t_default, t_load, t_merge)):
        cfg = merge(default(), load(os.path.join(REPO, "configs/model/archs/mFormerV0_sm.yaml")))
        cfg.defrost()
        cfg.MODEL.IMG_SIZE = 64
        cfg.MODEL.STAGES.DIMS = [8, 12, 24, 32, 64]
        cfg.MODEL.STAGES.MBCONV_DEPTHS = [1, 1]
        cfg.MODEL.STAGES.ATTN_DEPTHS = [1, 1]
        cfg.MODEL.STAGES.NUM_HEADS = [2, 2]
        cfg.TRAIN.AMP_OPT_LEVEL = "O0"
        cfg.TRAIN.MIXED_PRECISION.ENABLED = False
        cfg.DATA.TASK_KEYS_H5 = list(TASKS)
        out.append(cfg)
    return out


def test_config_form_matches_jax_build_model(tiny):
    _, _, x, _ = tiny
    jcfg, tcfg = _configs()
    assert tcfg.MODEL.TYPE == "mFormerV0" and tcfg.MODEL.NAME == "mFormerV0_sm"
    jm = j_build(jcfg, num_classes=NC)
    meta_dim = sum(d for _, d in jm.meta_components)
    rng = np.random.default_rng(11)
    meta = rng.normal(size=(4, meta_dim)).astype(np.float32)
    variables = noisy(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(meta)),
                      rng)
    model = build_model(tcfg, NC, device="cpu")
    assert isinstance(model, MFormerV0) and not model.training
    for field in ("stage_dims", "mbconv_depths", "attn_depths", "meta_components"):
        assert tuple(getattr(model, field)) == tuple(getattr(jm, field)), field
    assert model.only_last_cls is jm.only_last_cls is False
    assert model.stage_3[0].attn.num_heads == jm.num_heads[0] == 2 and \
        model.stage_1[0].drop_connect.rate == jm.drop_rate == 0.1
    convert.load_jax_variables(model, variables)
    with torch.no_grad():
        out = model(torch.tensor(x), torch.tensor(meta))
    ref = japply(jm)(variables, jnp.asarray(x), jnp.asarray(meta))
    for t in TASKS:
        close(out[t].numpy(), ref[t], 4e-5, msg=t)


def test_the_registry_lists_both_models_and_the_presets_build():
    _, tcfg = _configs()
    tcfg.MODEL.TYPE = "mFormerV2"
    with pytest.raises(ValueError, match=r"Registered: \['mFormerV0', 'mFormerV1'\]"):
        build_model(tcfg, NC, device="cpu")
    model = build_model({"DIMS": (8, 12, 24, 32, 64), "MBCONV_DEPTHS": (1, 1),
                         "ATTN_DEPTHS": (1, 1), "NUM_HEADS": (2, 2)}, 64, NC, META,
                        device="cpu")
    assert isinstance(model, MFormerV0) and model.head.task_keys == TASKS
    assert model.gradient_checkpointing is False
