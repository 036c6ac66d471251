"""The port's K1 forward (plain version on CPU) against the TPU package.

The JAX side is ``flash_attention`` run through Pallas interpret mode, as
tests/test_flash_attention.py runs it, and ``sdpa_bnhd``. Inputs come from
numpy with a fixed seed. Tolerances are the TPU kernel tests' own: fp32
2e-5, bf16 3e-2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import linnaeus_tpu.ops.flash_attention as jfa
from linnaeus_tpu.ops.attention import sdpa_bnhd as jax_sdpa_bnhd
from linnaeus_tpu_torch.ops import flash_attention as tfa
from linnaeus_tpu_torch.ops import kernel_bars
from linnaeus_tpu_torch.ops.attention import scaled_dot_product_attention, sdpa_bnhd

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(
        jfa.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _qkv(n, d, dtype, seed=0, B=2, H=3):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(B, n, H, d)).astype(np.float32) for _ in range(3)]
    jax_t = [jnp.asarray(a, dtype) for a in arrays]  # (B, N, H, D)
    torch_t = [torch.tensor(np.asarray(t, np.float32)).to(getattr(torch, dtype)) for t in jax_t]
    return jax_t, torch_t


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [37, 130])
@pytest.mark.parametrize("d", [16, 64])
def test_plain_k1_matches_pallas_flash_and_sdpa(dtype, n, d):
    (jq, jk, jv), (q, k, v) = _qkv(n, d, dtype)
    B, N, H, D = q.shape
    block = jfa._auto_blocks(n)[0]
    j_out, (*_, j_lse) = jfa._flash_fwd_rule(
        *(jnp.swapaxes(t, 1, 2) for t in (jq, jk, jv)), None, block, block)
    out, lse = tfa.flash_attention_fwd(q, k, v)

    assert out.shape == (B, N, H, D) and out.dtype == q.dtype
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(out), _np(jnp.swapaxes(j_out, 1, 2)), atol=tol)
    j_lse = np.asarray(j_lse)[:, 0, :N].reshape(B, H, N)
    np.testing.assert_allclose(_np(lse), j_lse, atol=tol)
    np.testing.assert_allclose(_np(out), _np(jax_sdpa_bnhd(jq, jk, jv)), atol=tol)
    np.testing.assert_allclose(_np(out), _np(sdpa_bnhd(q, k, v)), atol=tol)
    assert tfa.LAUNCHES == 0  # CPU tensors never reach the kernel


def test_dispatch_routes_both_layouts_to_k1():
    _, (q, k, v) = _qkv(37, 16, "float32", seed=1)
    flash = scaled_dot_product_attention(q, k, v, use_flash=True, layout="bnhd")
    plain = scaled_dot_product_attention(q, k, v, use_flash=False, layout="bnhd")
    np.testing.assert_allclose(_np(flash), _np(plain), atol=2e-5)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    head_major = scaled_dot_product_attention(qh, kh, vh, use_flash=True, layout="bhnd")
    np.testing.assert_allclose(_np(head_major.transpose(1, 2)), _np(plain), atol=2e-5)
    assert tfa.LAUNCHES == 0


# ------------------------------------------------------------------ backward
# fp32: the TPU kernel tests' own bar for gradients (1e-3 to 2e-3 relative,
# tests/test_flash_attention.py); the port's plain backward follows the fused
# Pallas kernel cast for cast, so it sits far inside it. bf16: P and dS are
# rounded to 8 mantissa bits on both sides, but the JAX forward's lse comes
# from an online softmax over padded blocks and the output gradients are
# rounded once more, so two bf16 steps relative to the largest gradient.
GRAD_RTOL = {"float32": 2e-3, "bfloat16": 2e-2}


def _jax_grads(jq, jk, jv, jg):
    def loss(q, k, v):
        out = jfa.flash_attention(
            *(jnp.swapaxes(t, 1, 2) for t in (q, k, v)), bwd="kernel")
        return jnp.sum(jnp.swapaxes(out, 1, 2).astype(jnp.float32) * jg)

    return jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [37, 148])
def test_plain_k1_backward_matches_pallas_fused_backward(dtype, n):
    """dq, dk, dv of the port's Function (plain route) against jax.grad
    through the fused Pallas backward kernel (interpret mode), on strided
    q/k/v views of one qkv tensor."""
    rng = np.random.default_rng(n)
    B, H, D = 2, 3, 64
    qkv = rng.normal(size=(B, n, 3, H, D)).astype(np.float32)
    g = rng.normal(size=(B, n, H, D)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(qkv[:, :, i], dtype) for i in range(3))
    assert jfa._auto_blocks(n)[0] >= n  # one block: the fused kernel runs
    want = _jax_grads(jq, jk, jv, jnp.asarray(g))

    t = torch.tensor(np.asarray(jnp.asarray(qkv, dtype), np.float32)).to(getattr(torch, dtype))
    t.requires_grad_()
    q, k, v = t.unbind(2)  # strided views, as out of the qkv projection
    out = tfa.flash_attention(q, k, v)
    (out.float() * torch.tensor(g)).sum().backward()
    assert t.grad.dtype == t.dtype
    for name, got, ref in zip("qkv", t.grad.unbind(2), want):
        ref = _np(ref)
        np.testing.assert_allclose(
            _np(got), ref, rtol=0, atol=GRAD_RTOL[dtype] * np.abs(ref).max(), err_msg=name)
    assert tfa.LAUNCHES == 0 and tfa.BWD_LAUNCHES == 0


def test_plain_k1_backward_reference_equals_autograd_of_plain_forward():
    _, (q, k, v) = _qkv(37, 64, "float32", seed=3)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    out, lse = tfa.flash_attention_reference(q, k, v, 0.2)
    want = torch.autograd.grad((out * g).sum(), (q, k, v))
    got = tfa.flash_attention_bwd_reference(q, k, v, out, lse, g, 0.2)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a.detach()), _np(b), atol=2e-6)


# ------------------------------------------------------------ split backward
def _split_inputs(dtype, seed=7, B=1, H=2, N=300, D=32):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, N, 3, H, D)).astype(np.float32)
    g = rng.normal(size=(B, N, H, D)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(qkv[:, :, i], dtype) for i in range(3))
    t = torch.tensor(np.asarray(jnp.asarray(qkv, dtype), np.float32)).to(getattr(torch, dtype))
    return (jq, jk, jv), t, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_split_backward_matches_pallas_split_kernels(dtype):
    """dq, dk and dv of the port's Function (plain route: the dQ and dK/dV
    kernels' plain versions) against jax.grad through the Pallas dQ and dK/dV kernels (interpret
    mode, 128 x 128 blocks over 300 tokens: three blocks a side, the last
    one ragged), at (1, 2, 300, 32). fp32: atol 2e-3, the TPU kernel test's
    bar; bf16: two bf16 steps of the largest gradient, as for the fused
    kernel."""
    (jq, jk, jv), t, g = _split_inputs(dtype)

    def loss(q, k, v):
        out = jfa.flash_attention(
            *(jnp.swapaxes(a, 1, 2) for a in (q, k, v)), bwd="kernel",
            block_q=128, block_k=128, auto_blocks=False)
        return jnp.sum(jnp.swapaxes(out, 1, 2).astype(jnp.float32) * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    t.requires_grad_()
    q, k, v = t.unbind(2)
    out = tfa.flash_attention(q, k, v)
    (out.float() * torch.tensor(g)).sum().backward()
    assert t.grad.dtype == t.dtype
    for name, got, ref in zip("qkv", t.grad.unbind(2), want):
        ref = _np(ref)
        atol = 2e-3 if dtype == "float32" else GRAD_RTOL[dtype] * np.abs(ref).max()
        np.testing.assert_allclose(_np(got), ref, rtol=0, atol=atol, err_msg=name)
    assert tfa.DQ_LAUNCHES == 0 and tfa.DKV_LAUNCHES == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_split_backward_equals_plain_fused_backward(dtype):
    """All the operands share one dtype, so the two routes' casts fall on
    the same values: the plain versions agree to float32 rounding."""
    _, t, g = _split_inputs(dtype, seed=8, B=2, H=3, N=70, D=64)
    q, k, v = t.unbind(2)
    do = torch.tensor(g).to(t.dtype)
    o, lse = tfa.flash_attention_reference(q, k, v, 0.2)
    fused = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do, 0.2)
    delta = tfa.attention_delta(o, do)
    assert delta.shape == lse.shape and delta.dtype == torch.float32
    dq = tfa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, 0.2)
    dk, dv = tfa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, 0.2)
    for name, a, b in zip("qkv", (dq, dk, dv), fused):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-6 * float(b.abs().max()),
                                   err_msg=name)


def _jax_takes_split_backward(n: int) -> bool:
    """The TPU package's own condition (its ``_flash_bwd_rule``): the fused
    kernel runs only where the padded row is one block."""
    block_q, block_k = jfa._auto_blocks(n)
    nq_pad = -(-n // block_q) * block_q
    nk_pad = -(-n // block_k) * block_k
    return not (nq_pad == block_q and nk_pad == block_k)


@pytest.mark.parametrize("n", [1, 148, 580, 1024, 1025, 1028])
def test_the_backward_is_the_pair_on_both_sides_of_the_tpu_switch(n):
    """The TPU package takes its one-pass kernel up to 1024 tokens and its
    split pair past them; the port's backward is the pair at every length:
    its gradients are the pair's plain versions bit for bit, and the
    one-pass plain version's to float32 rounding."""
    assert _jax_takes_split_backward(n) == (n > 1024)
    _, t, g = _split_inputs("float32", seed=n, B=1, H=1, N=n, D=64)
    q, k, v = t.requires_grad_().unbind(2)
    do = torch.tensor(g)
    out = tfa.flash_attention(q, k, v, 0.125)
    got = torch.autograd.grad((out * do).sum(), t)[0].unbind(2)
    q, k, v = (a.detach() for a in (q, k, v))
    o, lse = tfa.flash_attention_reference(q, k, v, 0.125)
    pair = tfa.plain_attention_bwd(q, k, v, o, lse, do, 0.125)
    one_pass = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do, 0.125)
    for name, a, b, c in zip("qkv", got, pair, one_pass):
        assert torch.equal(a, b), name
        np.testing.assert_allclose(_np(a), _np(c), rtol=0,
                                   atol=1e-6 * max(float(c.abs().max()), 1.0), err_msg=name)


# ------------------------------------------- the tensor-core kernels' arithmetic
# Plain PyTorch emulations of what the bfloat16 kernels compute on the card,
# tile by tile and cast for cast, held to the plain versions within the bars
# the card enforces (ops/kernel_bars.py's K1_TOL and BWD_TOL): the tiling and
# the cast points chosen for the kernels stay inside those bars whatever the
# card does with them.
K1_TOL = {str(dt).removeprefix("torch."): v for dt, v in kernel_bars.K1_TOL.items()}
BWD_TOL = {str(dt).removeprefix("torch."): v for dt, v in kernel_bars.BWD_TOL.items()}
LOG2E = 1.4426950408889634
MASKED = -1e30


def _pad_rows(t, rows):
    """(B, H, n, D) -> (B, H, rows, D) with zero rows, as the kernels' copies
    fill a tile past N."""
    return torch.nn.functional.pad(t, (0, 0, 0, rows - t.shape[2]))


def _emulate_tiled_forward(q, k, v, scale, keys):
    """The forward kernel's arithmetic: key tiles of ``keys``, float32 scores,
    keys past N at -1e30, a running max of the raw scores, p = exp2(s c - m c)
    with c = scale log2(e), p cast to the input dtype per tile for P V, the
    denominator from the unrounded p, O = acc / max(l, 1e-30), lse =
    m scale + log l."""
    B, N, H, D = q.shape
    qf, kf, vf = (t.transpose(1, 2).float() for t in (q, k, v))
    tiles = -(-N // keys)
    kf, vf = _pad_rows(kf, tiles * keys), _pad_rows(vf, tiles * keys)
    c = scale * LOG2E
    m = torch.full((B, H, N, 1), MASKED)
    l = torch.zeros(B, H, N, 1)
    acc = torch.zeros(B, H, N, D)
    for t in range(tiles):
        cols = slice(t * keys, (t + 1) * keys)
        s = qf @ kf[:, :, cols].transpose(-1, -2)
        s[..., torch.arange(t * keys, (t + 1) * keys) >= N] = MASKED
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - m_new * c)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + p.to(q.dtype).float() @ vf[:, :, cols]
        m = m_new
    l = l.clamp_min(1e-30)
    lse = (m * scale + torch.log(l)).squeeze(-1)
    return (acc / l).transpose(1, 2).to(q.dtype), lse


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [37, 148])
@pytest.mark.parametrize("keys", [64, 128])
def test_tiled_online_softmax_forward_stays_inside_the_kernel_bar(dtype, n, keys):
    _, (q, k, v) = _qkv(n, 64, dtype, seed=n + keys)
    want, want_lse = tfa.flash_attention_reference(q, k, v)
    got, got_lse = _emulate_tiled_forward(q, k, v, 64 ** -0.5, keys)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got).all() and torch.isfinite(got_lse).all()
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=K1_TOL[dtype])
    np.testing.assert_allclose(_np(got_lse), _np(want_lse), rtol=0, atol=K1_TOL[dtype])


def _emulate_transposed_backward(q, k, v, o, lse, do, scale, tile=64):
    """The key-tile backward kernel's arithmetic: for each 64-key tile a walk
    over the 64-query tiles with the scores transposed, S^T = K Q^T and
    dP^T = V dO^T, P^T = exp2(S^T c - lse log2 e) and dS^T = P^T (dP^T -
    delta) zero past N and cast to the input dtype per tile pair, dV += P^T dO
    and dK += dS^T Q in float32, dK scaled at the end. dQ, which the kernel
    leaves to the dQ kernel, is summed here over the key tiles in float32 as
    a one-pass key-tile kernel would, and scaled at the end."""
    B, N, H, D = q.shape
    qf, kf, vf, of, dof = (t.transpose(1, 2).float() for t in (q, k, v, o, do))
    delta = (dof * of).sum(-1)  # (B, H, N)
    tiles = -(-N // tile)
    rows = tiles * tile
    qf, kf, vf, dof = (_pad_rows(t, rows) for t in (qf, kf, vf, dof))
    lse_p = torch.nn.functional.pad(lse, (0, rows - N))
    delta_p = torch.nn.functional.pad(delta, (0, rows - N))
    live = torch.arange(rows) < N
    c = scale * LOG2E
    dq = torch.zeros(B, H, rows, D)
    dk = torch.zeros(B, H, rows, D)
    dv = torch.zeros(B, H, rows, D)
    for kt in range(tiles):
        ks = slice(kt * tile, (kt + 1) * tile)
        for qt in range(tiles):
            qs = slice(qt * tile, (qt + 1) * tile)
            st = kf[:, :, ks] @ qf[:, :, qs].transpose(-1, -2)  # [key][query]
            dpt = vf[:, :, ks] @ dof[:, :, qs].transpose(-1, -2)
            pair = live[ks, None] & live[None, qs]
            pt = torch.where(pair, torch.exp2(st * c - lse_p[:, :, None, qs] * LOG2E),
                             torch.zeros(()))
            dst = (pt * (dpt - delta_p[:, :, None, qs])).to(q.dtype).float()
            dv[:, :, ks] += pt.to(q.dtype).float() @ dof[:, :, qs]
            dk[:, :, ks] += dst @ qf[:, :, qs]
            dq[:, :, qs] += dst.transpose(-1, -2) @ kf[:, :, ks]
    out = (dq * scale, dk * scale, dv)
    return tuple(t[:, :, :N].transpose(1, 2).to(q.dtype) for t in out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [37, 148])
def test_transposed_score_backward_stays_inside_the_kernel_bar(dtype, n):
    _, (q, k, v) = _qkv(n, 64, dtype, seed=n + 1)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(n)).to(q.dtype)
    scale = 64 ** -0.5
    o, lse = tfa.flash_attention_reference(q, k, v, scale)
    want = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do, scale)
    got = _emulate_transposed_backward(q, k, v, o, lse, do, scale)
    delta = tfa.attention_delta(o, do)
    want_dkv = tfa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale)
    for name, a, b in zip(("dq", "dk", "dv", "dk (split)", "dv (split)"),
                          got + got[1:], want + want_dkv):
        assert a.dtype == b.dtype and torch.isfinite(a).all(), name
        np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                   atol=BWD_TOL[dtype] * float(b.float().abs().max()),
                                   err_msg=name)


def _emulate_tiled_dq(q, k, v, do, lse, delta, scale, tile=64):
    """The tensor-core dQ kernel's arithmetic: 64-query tiles that walk the
    64-key tiles in order; K and V rows past N are zeros; S and dP in
    float32; P = exp2(S c - lse log2 e) with c = scale log2(e); dS =
    P (dP - delta), zero for keys past N, cast once to the input dtype;
    dQ += dS K in float32; query rows past N read lse = delta = 0 and are
    dropped; dQ scaled at the end."""
    B, N, H, D = q.shape
    qf, kf, vf, dof = (t.transpose(1, 2).float() for t in (q, k, v, do))
    tiles = -(-N // tile)
    rows = tiles * tile
    qf, kf, vf, dof = (_pad_rows(t, rows) for t in (qf, kf, vf, dof))
    lse_p = torch.nn.functional.pad(lse, (0, rows - N))
    delta_p = torch.nn.functional.pad(delta, (0, rows - N))
    key_live = torch.arange(rows) < N
    c = scale * LOG2E
    dq = torch.zeros(B, H, rows, D)
    for qt in range(tiles):
        qs = slice(qt * tile, (qt + 1) * tile)
        shift = -lse_p[:, :, qs, None] * LOG2E
        for kt in range(tiles):
            ks = slice(kt * tile, (kt + 1) * tile)
            s = qf[:, :, qs] @ kf[:, :, ks].transpose(-1, -2)
            dp = dof[:, :, qs] @ vf[:, :, ks].transpose(-1, -2)
            ds = torch.exp2(s * c + shift) * (dp - delta_p[:, :, qs, None])
            ds = torch.where(key_live[ks], ds, torch.zeros(()))
            dq[:, :, qs] += ds.to(q.dtype).float() @ kf[:, :, ks]
    return (dq * scale)[:, :, :N].transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [37, 148, 200])
def test_fixed_order_dq_sum_stays_inside_the_kernel_bar_and_repeats(dtype, n):
    """K1's dQ is summed in a fixed order: the block that owns a query tile
    adds dS K over the key tiles in order (the dQ kernel's arithmetic,
    :func:`_emulate_tiled_dq`). That sum holds the one-pass plain backward's
    dQ (the TPU package's fused kernel, cast for cast) at the kernel bar,
    and a second call is the same bits."""
    _, (q, k, v) = _qkv(n, 64, dtype, seed=n + 3)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(n + 3)).to(q.dtype)
    scale = 64 ** -0.5
    o, lse = tfa.flash_attention_reference(q, k, v, scale)
    want = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do, scale)[0]
    delta = tfa.attention_delta(o, do)
    got = _emulate_tiled_dq(q, k, v, do, lse, delta, scale)
    assert got.dtype == want.dtype and torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=BWD_TOL[dtype] * float(want.float().abs().max()))
    assert torch.equal(got, _emulate_tiled_dq(q, k, v, do, lse, delta, scale))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 37, 64, 65, 300])
def test_tiled_dq_stays_inside_the_kernel_bar(dtype, n):
    _, (q, k, v) = _qkv(n, 64, dtype, seed=n + 2)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(n)).to(q.dtype)
    scale = 64 ** -0.5
    o, lse = tfa.flash_attention_reference(q, k, v, scale)
    delta = tfa.attention_delta(o, do)
    want = tfa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, scale)
    got = _emulate_tiled_dq(q, k, v, do, lse, delta, scale)
    assert got.dtype == want.dtype and got.shape == want.shape and torch.isfinite(got).all()
    # with one key P is 1 and dQ is zero in exact arithmetic, and what is left
    # is the rounding of O in delta (bf16) or float32 noise of a few 1e-7 on
    # both sides (exp2 against exp, dP against delta): the gradient's scale
    # counts as no less than 1e-3 / 5e-2
    floor = {"bfloat16": 1e-3, "float32": 5e-2}[dtype]
    bar = BWD_TOL[dtype] * max(float(want.float().abs().max()), floor)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=bar)


# ------------------------------------------------------------------ alignment
def test_qkv_slices_are_aligned_for_the_bfloat16_kernels():
    for B, N, H in ((2, 37, 3), (1, 580, 6), (1, 148, 12)):
        qkv = torch.zeros(B, N, 3, H, 64, dtype=torch.bfloat16)
        for t in qkv.unbind(2):
            assert tfa.misalignment(t) is None
        tfa._check_aligned(q=qkv[:, :, 0], k=qkv[:, :, 1], v=qkv[:, :, 2])


@pytest.mark.parametrize("fault", ["offset", "token stride", "head stride"])
def test_a_misaligned_bfloat16_view_raises(fault):
    B, N, H, D = 2, 6, 2, 64  # sizes that leave the other strides on 16-byte lines
    if fault == "offset":  # starts 8 bytes into a 16-byte line
        bad = torch.zeros(B * N * H * D + 4, dtype=torch.bfloat16)[4:].view(B, N, H, D)
        match = "first element"
    elif fault == "token stride":  # rows of H * D + 4 elements: 8 bytes over
        bad = torch.zeros(B, N, H * D + 4, dtype=torch.bfloat16)[..., : H * D].unflatten(-1, (H, D))
        match = "token stride"
    else:  # heads D + 4 elements apart
        bad = torch.zeros(B, N, H, D + 4, dtype=torch.bfloat16)[..., :D]
        match = "head stride"
    assert bad.shape == (B, N, H, D) and bad.stride(-1) == 1
    assert match in tfa.misalignment(bad)
    with pytest.raises(ValueError, match="misaligned"):
        tfa._check_aligned(q=bad)
    # the same view in float32 goes to kernels that read element by element
    assert tfa.misalignment(bad.float()[:, :, :, :]) is None
    # a misaligned dO is copied, not refused
    good = torch.zeros(B, N, H, D, dtype=torch.bfloat16)
    fixed = tfa._check_dout(good, bad)
    assert tfa.misalignment(fixed) is None and torch.equal(fixed, bad)
    assert tfa._check_dout(good, good) is good


@pytest.mark.parametrize("operand", ["q", "k", "v", "dO", "dq"])
def test_the_dq_launch_refuses_a_misaligned_bfloat16_operand(operand):
    """The tensor-core dQ kernel reads and writes in 16-byte pieces: the
    launch checks every operand and its output before it reaches the
    library."""
    B, N, H, D = 1, 6, 2, 64
    good = {n: torch.zeros(B, N, H, D, dtype=torch.bfloat16) for n in ("q", "k", "v", "dO", "dq")}
    good[operand] = torch.zeros(B * N * H * D + 4, dtype=torch.bfloat16)[4:].view(B, N, H, D)
    stats = torch.zeros(B, H, N)
    with pytest.raises(ValueError, match=f"{operand} is misaligned"):
        tfa._launch_bwd_dq(good["q"], good["k"], good["v"], good["dO"], stats, stats, 0.125,
                           out=good["dq"])
