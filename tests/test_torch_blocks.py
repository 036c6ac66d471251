"""The port's blocks against their Flax modules at tiny widths, in fp32.

Each Flax module is initialised from a fixed key, its params are perturbed
with seeded numpy noise (so a 1e-6 layer scale or a unit LayerNorm cannot
hide a wrong path), copied into the port's module, and both run on the same
numpy inputs. Tolerance 1e-5 (float32, tiny widths).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import linnaeus_tpu.ops.fused_mlp as jfm
from linnaeus_tpu.models.blocks.common import MetaHead as JMetaHead
from linnaeus_tpu.models.blocks.convnext import ConvNeXtBlock as JConvNeXtBlock
from linnaeus_tpu.models.blocks.rope_mhsa import RoPE2DMHSABlock as JRoPEBlock
from linnaeus_tpu_torch.models.blocks.common import MetaHead
from linnaeus_tpu_torch.models.blocks.convnext import ConvNeXtBlock
from linnaeus_tpu_torch.models.blocks.rope_mhsa import RoPE2DMHSABlock

ATOL = 1e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(
        jfm.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _init(module, x, seed=0):
    params = module.init(jax.random.PRNGKey(0), x)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32), params
    )


def _load(module, pairs):
    """pairs: {port key: (numpy value, transpose axes or None)}."""
    state = {
        k: torch.tensor(v if axes is None else np.transpose(v, axes))
        for k, (v, axes) in pairs.items()
    }
    module.load_state_dict(state, strict=True)
    return module.eval()


def _dense(p, key):
    return {f"{key}.weight": (p["kernel"], (1, 0)), f"{key}.bias": (p["bias"], None)}


def _ln(p, key):
    return {f"{key}.weight": (p["scale"], None), f"{key}.bias": (p["bias"], None)}


@pytest.mark.parametrize("act_exact", [False, True])
@pytest.mark.parametrize("fused", [None, True, False])
def test_convnext_block(act_exact, fused):
    x = np.random.default_rng(1).normal(size=(2, 6, 6, 8)).astype(np.float32)
    jm = JConvNeXtBlock(dim=8, act_exact=act_exact, fused_mlp=fused)
    p = _init(jm, jnp.asarray(x))
    ref = jm.apply({"params": p}, jnp.asarray(x))
    tm = _load(ConvNeXtBlock(8, act_exact=act_exact, fused_mlp=fused), {
        "dwconv.weight": (p["Conv_0"]["kernel"], (3, 2, 0, 1)),
        "dwconv.bias": (p["Conv_0"]["bias"], None),
        **_ln(p["LayerNorm_0"], "norm"),
        **_dense(p["Dense_0"], "pwconv1"),
        **_dense(p["Dense_1"], "pwconv2"),
        "gamma": (p["gamma"], None),
    })
    with torch.no_grad():
        out = tm(torch.tensor(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("mixed", [True, False])
@pytest.mark.parametrize("fidelity", ["rotate", "reference_cos"])
@pytest.mark.parametrize("flash", [False, True])
def test_rope_block(mixed, fidelity, flash):
    # 2 extra tokens + a 4x3 grid; large inputs make the rotation matter
    x = 3.0 * np.random.default_rng(2).normal(size=(2, 14, 16)).astype(np.float32)
    kw = dict(img_grid_size=(4, 3), extra_token_num=2, num_heads=2,
              rope_mixed=mixed, rope_fidelity=fidelity)
    jm = JRoPEBlock(dim=16, **kw)
    p = _init(jm, jnp.asarray(x))
    ref = jm.apply({"params": p}, jnp.asarray(x))
    pairs = {
        **_ln(p["norm1"], "norm1"),
        **_dense(p["attn"]["qkv"], "attn.qkv"),
        **_dense(p["attn"]["proj"], "attn.proj"),
        **_ln(p["norm2"], "norm2"),
        **_dense(p["mlp"]["Dense_0"], "mlp.fc1"),
        **_dense(p["mlp"]["Dense_1"], "mlp.fc2"),
    }
    if mixed:
        pairs["attn.freqs"] = (p["attn"]["freqs"], None)
    tm = _load(RoPE2DMHSABlock(16, use_flash_attn=flash, **kw), pairs)
    with torch.no_grad():
        out = tm(torch.tensor(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_meta_head():
    x = np.random.default_rng(3).normal(size=(3, 5)).astype(np.float32)
    jm = JMetaHead(out_dim=16)
    p = _init(jm, jnp.asarray(x))
    ref = jm.apply({"params": p}, jnp.asarray(x))
    r = p["ResNormLayer_0"]
    tm = _load(MetaHead(5, 16), {
        **_dense(p["Dense_0"], "0"),
        **_ln(p["LayerNorm_0"], "2"),
        **_dense(r["Dense_0"], "3.w1"),
        **_ln(r["LayerNorm_0"], "3.norm_fn1"),
        **_dense(r["Dense_1"], "3.w2"),
        **_ln(r["LayerNorm_1"], "3.norm_fn2"),
    })
    with torch.no_grad():
        out = tm(torch.tensor(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_convnext_block_drop_path_in_training():
    """In training an active drop-path must scale the MLP branch alone: the
    K2 route then skips the kernel's residual add. Both routes draw the same
    per-sample mask from the same seed."""
    x = torch.tensor(np.random.default_rng(4).normal(size=(4, 5, 5, 8)).astype(np.float32))
    fused = ConvNeXtBlock(8, drop_path=0.5, layer_scale_init_value=0.5, fused_mlp=True)
    plain = ConvNeXtBlock(8, drop_path=0.5, layer_scale_init_value=0.5, fused_mlp=False)
    plain.load_state_dict(fused.state_dict())
    outs = []
    for block in (fused, plain):
        block.train()
        torch.manual_seed(0)
        with torch.no_grad():
            outs.append(block(x))
        torch.manual_seed(0)
        kept = torch.rand(4) < 0.5  # the mask DropPath drew
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=ATOL)
    assert kept.any() and not kept.all()
    for i, k in enumerate(kept.tolist()):
        assert torch.equal(outs[0][i], x[i]) != k  # dropped samples are the residual


def test_convnext_block_fused_tail_under_grad_with_drop_path():
    """Active drop-path: the fused tail runs without the in-kernel residual
    and the block adds the dropped branch itself. Same keep masks (same
    generator seed) through the fused and the plain tail give the same
    output and the same gradients."""
    rng = np.random.default_rng(0)
    x0 = torch.tensor(rng.normal(size=(6, 5, 5, 8)).astype(np.float32))
    results = []
    for fused in (True, False):
        blk = ConvNeXtBlock(8, drop_path=0.5, layer_scale_init_value=0.5, fused_mlp=fused).train()
        with torch.no_grad():
            for i, p in enumerate(blk.parameters()):
                p.copy_(torch.tensor(
                    np.random.default_rng(10 + i).normal(size=tuple(p.shape)).astype(np.float32)
                ) * 0.3)
        blk.drop_path.generator = torch.Generator().manual_seed(1)
        x = x0.clone().requires_grad_()
        out = blk(x)
        out.square().sum().backward()
        results.append((out.detach(), x.grad, [p.grad for p in blk.parameters()]))
    (o1, g1, p1), (o2, g2, p2) = results
    dropped = (o1 - x0).flatten(1).abs().amax(1) == 0
    assert 0 < int(dropped.sum()) < 6  # some samples kept, some dropped
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=1e-5)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), atol=1e-4)
    for a, b in zip(p1, p2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4)


def _parent_drop_path(drop_path, x):
    """DropPath.forward as it was before drop path became a per-sample scale:
    a division, a zero tensor and a ``where`` over the broadcast mask."""
    from linnaeus_tpu_torch.parallel.ops import draw_rows

    if not drop_path.training or drop_path.rate <= 0.0:
        return x
    keep = 1.0 - drop_path.rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = draw_rows(torch.rand, shape, x.device, drop_path.generator,
                     drop_path.data_group) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _parent_convnext_forward(block, x, fused):
    """ConvNeXtBlock.forward as it was before drop path moved into the
    residual add: DropPath.forward on the branch, then the add (the fused
    tail then skipped its own residual add)."""
    from linnaeus_tpu_torch.models.blocks.common import gelu
    from linnaeus_tpu_torch.models.blocks.convnext import _conv_nhwc
    from linnaeus_tpu_torch.ops.fused_mlp import fused_convnext_mlp

    y = _conv_nhwc(block.dwconv, x)
    if fused:
        active = block.training and block.drop_path.rate != 0.0
        out = fused_convnext_mlp(
            y, None if active else x, block.norm.weight, block.norm.bias,
            block.pwconv1.weight, block.pwconv1.bias, block.pwconv2.weight, block.pwconv2.bias,
            block.gamma, eps=block.norm.eps, approximate_gelu=not block.act_exact)
        return x + _parent_drop_path(block.drop_path, out) if active else out
    y = block.pwconv2(gelu(block.pwconv1(block.norm(y)), block.act_exact)) * block.gamma
    return x + _parent_drop_path(block.drop_path, y)


def _parent_rope_forward(block, x):
    x = x + _parent_drop_path(block.drop_path, block.attn(block.norm1(x)))
    return x + _parent_drop_path(block.drop_path, block.mlp(block.norm2(x)))


def _drop_path_blocks(rate):
    torch.manual_seed(5)
    return {
        "convnext_fused": ConvNeXtBlock(8, drop_path=rate, layer_scale_init_value=0.5,
                                        fused_mlp=True),
        "convnext_plain": ConvNeXtBlock(8, drop_path=rate, layer_scale_init_value=0.5,
                                        fused_mlp=False),
        "rope": RoPE2DMHSABlock(16, img_grid_size=(4, 3), extra_token_num=2, num_heads=2,
                                drop_path=rate),
    }


def _run_both(kind, block, x):
    """(this forward, the parent's forward), each from a fresh generator of
    one seed, and the generator's state after each."""
    outs, states = [], []
    for parent in (False, True):
        block.drop_path.generator = torch.Generator().manual_seed(23)
        with torch.no_grad():
            if kind == "rope":
                out = _parent_rope_forward(block, x) if parent else block(x)
            else:
                out = (_parent_convnext_forward(block, x, kind == "convnext_fused") if parent
                       else block(x))
        outs.append(out)
        states.append(block.drop_path.generator.get_state())
    return outs, states


@pytest.mark.parametrize("kind", ["convnext_fused", "convnext_plain", "rope"])
def test_blocks_in_training_draw_the_parents_uniforms(kind):
    """At rate 0.5 in training the scaled residual takes the same uniforms
    from the same generator as DropPath.forward did (the generator ends in
    the same state), keeps the same samples and gives the eager sum."""
    block = _drop_path_blocks(0.5)[kind].train()
    x = torch.randn((8, 14, 16) if kind == "rope" else (8, 5, 5, 8),
                    generator=torch.Generator().manual_seed(1))
    (got, want), (after, parent_after) = _run_both(kind, block, x)
    assert torch.equal(after, parent_after)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    if kind != "rope":  # a dropped sample of a ConvNeXt block is its input
        dropped = [torch.equal(got[i], x[i]) for i in range(8)]
        assert dropped == [torch.equal(want[i], x[i]) for i in range(8)]
        assert any(dropped) and not all(dropped)


@pytest.mark.parametrize("kind", ["convnext_fused", "convnext_plain", "rope"])
@pytest.mark.parametrize("rate,training", [(0.5, False), (0.0, True)])
def test_blocks_without_a_scale_are_the_parents_bits(kind, rate, training):
    """Eval, and rate 0 in training, take no scale: the parent's formula bit
    for bit, and nothing drawn."""
    block = _drop_path_blocks(rate)[kind].train(training)
    x = torch.randn((3, 14, 16) if kind == "rope" else (3, 5, 5, 8),
                    generator=torch.Generator().manual_seed(2))
    (got, want), (after, parent_after) = _run_both(kind, block, x)
    assert torch.equal(got, want)
    assert torch.equal(after, torch.Generator().manual_seed(23).get_state())
    assert torch.equal(parent_after, after)


# ------------------------------------------------- where the scores are stored
# fp32: both settings are the same float32 math. bf16: with fp32_softmax=False
# both sides round q * scale and the scores to bf16 at the same places, so the
# outputs differ by a bf16 step of the output (|out| < 2: 2**-7) at most.
SDPA_ATOL = {"float32": 1e-5, "bfloat16": 2 ** -7}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fp32_softmax", [True, False])
@pytest.mark.parametrize("layout", ["bnhd", "bhnd"])
def test_plain_attention_score_dtype_matches_jax(dtype, fp32_softmax, layout):
    from linnaeus_tpu.ops.attention import scaled_dot_product_attention as jax_sdpa
    from linnaeus_tpu_torch.ops.attention import scaled_dot_product_attention

    rng = np.random.default_rng(5)
    shape = (2, 19, 3, 32) if layout == "bnhd" else (2, 3, 19, 32)
    arrays = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    jq, jk, jv = (jnp.asarray(a, dtype) for a in arrays)
    q, k, v = (torch.tensor(np.asarray(a, np.float32)).to(getattr(torch, dtype))
               for a in (jq, jk, jv))
    ref = jax_sdpa(jq, jk, jv, layout=layout, fp32_softmax=fp32_softmax)
    out = scaled_dot_product_attention(q, k, v, layout=layout, fp32_softmax=fp32_softmax)
    assert out.dtype == q.dtype and tuple(out.shape) == shape
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=SDPA_ATOL[dtype])
    if dtype == "bfloat16":
        # the knob is not a no-op: bf16 scores move the result
        other = scaled_dot_product_attention(q, k, v, layout=layout,
                                             fp32_softmax=not fp32_softmax)
        assert not torch.equal(out, other)


# bf16 block: the two frameworks round LayerNorm, GELU and the residual adds
# at other places; |out| reaches ~10 here, where a bf16 step is 2**-4
ROPE_BLOCK_ATOL = {"float32": ATOL, "bfloat16": 0.15}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fp32_softmax", [True, False])
def test_rope_block_attn_fp32_softmax(dtype, fp32_softmax):
    x = 3.0 * np.random.default_rng(6).normal(size=(2, 14, 16)).astype(np.float32)
    kw = dict(img_grid_size=(4, 3), extra_token_num=2, num_heads=2,
              attn_fp32_softmax=fp32_softmax)
    jm = JRoPEBlock(dim=16, dtype=getattr(jnp, dtype), **kw)
    p = _init(JRoPEBlock(dim=16, **kw), jnp.asarray(x))
    jx = jnp.asarray(x, dtype)
    ref = jm.apply({"params": p}, jx)
    tm = _load(RoPE2DMHSABlock(16, **kw), {
        **_ln(p["norm1"], "norm1"),
        **_dense(p["attn"]["qkv"], "attn.qkv"),
        **_dense(p["attn"]["proj"], "attn.proj"),
        **_ln(p["norm2"], "norm2"),
        **_dense(p["mlp"]["Dense_0"], "mlp.fc1"),
        **_dense(p["mlp"]["Dense_1"], "mlp.fc2"),
        "attn.freqs": (p["attn"]["freqs"], None),
    })
    assert tm.attn.attn_fp32_softmax is fp32_softmax
    with torch.no_grad():
        out = tm(torch.tensor(np.asarray(jx, np.float32)).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=ROPE_BLOCK_ATOL[dtype])
