"""The port's K2 forward (plain version on CPU) against the TPU package's
``fused_convnext_mlp`` run through Pallas interpret mode, as
tests/test_fused_mlp.py runs it. Inputs come from numpy with a fixed seed.
Tolerances are the TPU kernel tests' own: fp32 1e-5, bf16 5e-2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import linnaeus_tpu.ops.fused_mlp as jfm
from linnaeus_tpu_torch.ops import fused_mlp as tfm
from linnaeus_tpu_torch.ops import kernel_bars

TOL = {"float32": 1e-5, "bfloat16": 5e-2}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(
        jfm.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _inputs(M, C, dtype, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {
        "y": f(M, C), "x": f(M, C),
        "ls": 1.0 + 0.1 * f(C), "lb": 0.1 * f(C),
        "w1": 0.1 * f(C, 4 * C), "b1": 0.1 * f(4 * C),
        "w2": 0.1 * f(4 * C, C), "b2": 0.1 * f(C),
        "g": 0.5 + 0.1 * f(C),
    }


def _torch(a, dtype):
    return torch.tensor(np.asarray(jnp.asarray(a, dtype), np.float32)).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("with_gamma", [False, True])
def test_plain_k2_matches_pallas(dtype, approximate, residual, with_gamma):
    a = _inputs(70, 16, dtype)  # 70 rows: a ragged last tile
    jdt = getattr(jnp, dtype)
    gamma = a["g"] if with_gamma else None
    ref = jfm.fused_convnext_mlp(
        jnp.asarray(a["y"], jdt), jnp.asarray(a["x"], jdt) if residual else None,
        a["ls"], a["lb"], jnp.asarray(a["w1"], jdt), a["b1"],
        jnp.asarray(a["w2"], jdt), a["b2"], gamma, approximate_gelu=approximate,
    )
    out = tfm.fused_convnext_mlp(
        _torch(a["y"], dtype), _torch(a["x"], dtype) if residual else None,
        torch.tensor(a["ls"]), torch.tensor(a["lb"]),
        _torch(a["w1"], dtype).t().contiguous(), torch.tensor(a["b1"]),
        _torch(a["w2"], dtype).t().contiguous(), torch.tensor(a["b2"]),
        None if gamma is None else torch.tensor(gamma),
        approximate_gelu=approximate,
    )
    assert out.dtype == getattr(torch, dtype) and out.shape == (70, 16)
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), atol=TOL[dtype]
    )
    assert tfm.LAUNCHES == 0  # CPU tensors never reach the kernel


def test_plain_k2_keeps_leading_dims():
    a = _inputs(2 * 5 * 7, 8, "float32", seed=1)
    t = {k: torch.tensor(v) for k, v in a.items()}
    y4 = t["y"].reshape(2, 5, 7, 8)
    out = tfm.fused_convnext_mlp(
        y4, t["x"].reshape(2, 5, 7, 8), t["ls"], t["lb"], t["w1"].t(), t["b1"],
        t["w2"].t(), t["b2"], t["g"],
    )
    flat = tfm.fused_convnext_mlp(
        t["y"], t["x"], t["ls"], t["lb"], t["w1"].t(), t["b1"], t["w2"].t(),
        t["b2"], t["g"],
    )
    assert out.shape == (2, 5, 7, 8)
    torch.testing.assert_close(out.reshape(-1, 8), flat, rtol=0, atol=0)


# ------------------------------------------------------------------ backward
# fp32: the TPU kernel test's own bar (2e-4, tests/test_fused_mlp.py). bf16:
# h0, h1, da2 and da1 are rounded to 8 mantissa bits on both sides; a
# rounding that falls the other way after a differently ordered float32 sum
# moves a gradient by a bf16 step, so 2e-2 of each gradient's largest value.
BWD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
GRAD_NAMES = ("dy", "dx", "dls", "dlb", "dw1", "db1", "dw2", "db2", "dg")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("residual,with_gamma", [(True, True), (False, True), (True, False)])
@pytest.mark.parametrize("M,C", [(70, 16), (300, 136)])
def test_plain_k2_backward_matches_pallas_backward(monkeypatch, dtype, approximate, residual,
                                                   with_gamma, M, C):
    """dy, dresidual and the seven parameter gradients of the port's
    Function (plain route) against jax.grad through the Pallas backward
    kernel in interpret mode. (300, 136): a C > 128 row, the JAX wide
    tiling, with rows that are no multiple of its 256-row tile."""
    monkeypatch.setattr(jfm, "_FORCE_KERNEL_BWD", True)
    a = _inputs(M, C, dtype, seed=C)
    cot = np.random.default_rng(1).normal(size=(M, C)).astype(np.float32)
    jdt = getattr(jnp, dtype)

    def loss(y, x, ls, lb, w1, b1, w2, b2, g):
        out = jfm.fused_convnext_mlp(
            y, x if residual else None, ls, lb, w1, b1, w2, b2, g if with_gamma else None,
            approximate_gelu=approximate)
        return jnp.sum(out.astype(jnp.float32) * cot)

    jargs = [jnp.asarray(a[k], jdt if k in ("y", "x", "w1", "w2") else jnp.float32)
             for k in ("y", "x", "ls", "lb", "w1", "b1", "w2", "b2", "g")]
    want = jax.grad(loss, argnums=tuple(range(9)))(*jargs)

    cast = lambda k: _torch(a[k], dtype) if k in ("y", "x", "w1", "w2") else torch.tensor(a[k])  # noqa: E731
    t = {k: cast(k) for k in a}
    t["w1"], t["w2"] = t["w1"].t().contiguous(), t["w2"].t().contiguous()
    for v in t.values():
        v.requires_grad_()
    out = tfm.fused_convnext_mlp(
        t["y"], t["x"] if residual else None, t["ls"], t["lb"], t["w1"], t["b1"], t["w2"],
        t["b2"], t["g"] if with_gamma else None, approximate_gelu=approximate)
    (out.float() * torch.tensor(cot)).sum().backward()

    got = [t[k].grad for k in ("y", "x", "ls", "lb", "w1", "b1", "w2", "b2", "g")]
    for name, g_t, g_j in zip(GRAD_NAMES, got, want):
        ref = np.asarray(g_j, np.float32)
        if name in ("dw1", "dw2"):
            ref = ref.T  # JAX keeps (in, out), torch Linear (out, in)
        if (name == "dx" and not residual) or (name == "dg" and not with_gamma):
            assert g_t is None and not ref.any(), name
            continue
        assert g_t.dtype == (getattr(torch, dtype) if name in ("dy", "dx", "dw1", "dw2")
                             else torch.float32), name
        tol = BWD_TOL[dtype] * max(np.abs(ref).max(), 1.0 if dtype == "float32" else 0.0)
        np.testing.assert_allclose(g_t.float().numpy(), ref, rtol=0, atol=tol, err_msg=name)
    assert tfm.LAUNCHES == 0 and tfm.BWD_LAUNCHES == 0


@pytest.mark.parametrize("approximate", [True, False])
def test_plain_k2_with_a_drop_path_scale_matches_the_eager_formula(approximate):
    """The Function (plain route) with drop path's per-sample scale against
    the formula it replaces, residual + where(mask, branch / keep, 0) over
    K2 without its residual, and autograd through it, in float32: the
    output (a dropped sample's rows the residual, bit for bit) and the nine
    gradients."""
    B, rows, C = 5, 14, 24
    names = ("y", "x", "ls", "lb", "w1", "b1", "w2", "b2", "g")
    a = {k: torch.tensor(v) for k, v in _inputs(B * rows, C, "float32", seed=3).items()}
    a["w1"], a["w2"] = a["w1"].t().contiguous(), a["w2"].t().contiguous()
    u, keep = torch.tensor([0.3, 0.8, 0.1, 0.95, 0.5]), 0.7
    kept = (u < keep).repeat_interleave(rows)[:, None]
    cot = torch.randn(B * rows, C, generator=torch.Generator().manual_seed(1))

    got_t = {k: a[k].clone().requires_grad_() for k in names}
    got = tfm.fused_convnext_mlp(*(got_t[k] for k in names), approximate_gelu=approximate,
                                 scale=tfm.SampleScale(u, keep))
    (got * cot).sum().backward()
    want_t = {k: a[k].clone().requires_grad_() for k in names}
    branch = tfm.fused_convnext_mlp(want_t["y"], None, *(want_t[k] for k in names[2:]),
                                    approximate_gelu=approximate)
    want = want_t["x"] + torch.where(kept, branch / keep, torch.zeros_like(branch))
    (want * cot).sum().backward()

    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0, atol=1e-6)
    assert kept.any() and not kept.all()
    dropped = ~kept[:, 0]
    assert torch.equal(got.detach()[dropped], a["x"][dropped])
    for k in names:
        ref = want_t[k].grad
        tol = 1e-5 * max(ref.abs().max().item(), 1.0)
        np.testing.assert_allclose(got_t[k].grad.numpy(), ref.numpy(), rtol=0, atol=tol,
                                   err_msg=k)
    assert torch.equal(got_t["x"].grad, cot)  # the residual's gradient is dout
    assert not got_t["y"].grad[dropped].any()
    assert tfm.LAUNCHES == 0 and tfm.BWD_LAUNCHES == 0


@pytest.mark.parametrize("approximate", [True, False])
def test_plain_k2_backward_reference_equals_autograd_of_plain_forward(approximate):
    a = {k: torch.tensor(v) for k, v in _inputs(70, 24, "float32", seed=2).items()}
    w1, w2 = a["w1"].t().contiguous(), a["w2"].t().contiguous()
    leaves = [t.requires_grad_() for t in (a["y"], a["ls"], a["lb"], w1, a["b1"], w2, a["b2"], a["g"])]
    y, ls, lb, w1, b1, w2, b2, g = leaves
    cot = torch.randn(70, 24, generator=torch.Generator().manual_seed(0))
    out = tfm.fused_convnext_mlp_reference(y, a["x"], ls, lb, w1, b1, w2, b2, g, 1e-6, approximate)
    want = torch.autograd.grad((out * cot).sum(), leaves)
    got = tfm.fused_convnext_mlp_bwd_reference(
        y.detach(), cot, *(t.detach() for t in leaves[1:]), 1e-6, approximate)
    for name, p, q in zip(("dy", "dls", "dlb", "dw1", "db1", "dw2", "db2", "dg"), got, want):
        np.testing.assert_allclose(p.numpy(), q.numpy(), atol=5e-6, err_msg=name)


# ------------------------------------- the tensor-core backward's arithmetic
# A plain PyTorch emulation of what the bfloat16 backward kernels compute on
# the card, pass by pass, tile by tile and cast for cast, held to the plain
# version within the bars the card enforces (ops/kernel_bars.py's BWD_TOL):
# the decomposition, the padding and the cast points chosen for the kernels
# stay inside those bars whatever the card does with them.
KERNEL_BWD_TOL = {str(dt).removeprefix("torch."): v for dt, v in kernel_bars.BWD_TOL.items()}


def _fast_tanh(x):
    """The kernels' tanh is the card's one-instruction approximation, whose
    relative error is at most 2**-11: taken here at that bound, with
    alternating sign."""
    sign = 1.0 - 2.0 * (torch.arange(x.numel()).reshape(x.shape) % 2)
    return torch.tanh(x) * (1.0 + sign * 2.0 ** -11)


def _kernel_gelu(a, approximate, tanh):
    if not approximate:
        return 0.5 * a * (1.0 + torch.erf(a * 0.7071067811865476))
    return 0.5 * a * (1.0 + tanh(0.7978845608028654 * (a + 0.044715 * a * a * a)))


def _kernel_gelu_grad(a, approximate, tanh):
    if not approximate:
        return tfm._gelu_grad(a, False)
    c, k = 0.7978845608028654, 0.044715
    t = tanh(c * (a + k * a * a * a))
    return 0.5 * (1.0 + t) + 0.5 * a * (1.0 - t * t) * c * (1.0 + 3.0 * k * a * a)


def _emulate_two_pass_backward(y, dout, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, approximate,
                               row_blocks=3, slabs=2):
    """The tensor-core route: a prologue that makes h0 = round(LN(y)) and
    d2 = round(dout gamma) once; a row pass over blocks of two 64-row tiles
    (zero rows past M) and 64-column hidden chunks, taken 32 columns at a
    time where the width across C is 128 or more, with dh0 accumulated
    across C padded to the product's width (64 at C = 32, 192 at C = 160)
    and three column sums kept per block (dh0 n, dh0, dout); a weight pass
    per hidden chunk and slab of row tiles on transposed chunk activations,
    accumulating G^T = h1^T dout and dW1c, 32 tile rows at a time where the
    row pass takes 32 columns; then dW2 = gamma G, db2 = gamma sum dout,
    dgamma = sum_j W2 G + b2 sum dout, slabs and blocks summed in order.
    No a2 product. The fast tanh belongs to the bfloat16 kernels; float32
    operands (which on the card keep the CUDA-core kernels) take the exact
    one."""
    dt = y.dtype
    tanh = _fast_tanh if dt == torch.bfloat16 else torch.tanh
    M, C = y.shape
    Hd = w1.shape[0]
    N = 64 if C <= 64 else 96 if C == 96 else 128 if C <= 128 else 192  # width across C
    sub = 32 if N >= 128 else 64
    rd = lambda t: t.to(dt).float()  # noqa: E731
    yf = y.float()
    mean = yf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((yf - mean).square().mean(-1, keepdim=True) + eps)
    tiles = -(-M // 128) * 2  # whole blocks of two tiles
    pad_rows = lambda t: torch.nn.functional.pad(t, (0, 0, 0, tiles * 64 - M))  # noqa: E731
    pad_cols = lambda t: torch.nn.functional.pad(t, (0, N - C))  # noqa: E731
    h0 = pad_rows(rd((yf - mean) * rstd * ln_w + ln_b))
    d2 = pad_rows(rd(dout.float() * gamma))
    yp, dop, mean, rstd = (pad_rows(t) for t in (yf, dout.float(), mean, rstd))
    live = (torch.arange(tiles * 64) < M)[:, None]
    w1f, w2f = w1.float(), w2.float()
    w1p = pad_cols(w1f)  # [hidden][c], zero columns past C

    dy = torch.zeros(tiles * 64, C)
    part = torch.zeros(row_blocks, 3, C)
    for t in range(tiles):
        rows = slice(t * 64, (t + 1) * 64)
        dh0 = torch.zeros(64, N)
        for hc in range(0, Hd, sub):
            ch = slice(hc, hc + sub)
            a1 = h0[rows] @ w1f[ch].t() + b1[ch]  # inner C, no padding
            dh1 = d2[rows] @ w2f[:, ch]
            dh0 += rd(dh1 * _kernel_gelu_grad(a1, approximate, tanh)) @ w1p[ch]
        dh0 = dh0[:, :C]
        n = (yp[rows] - mean[rows]) * rstd[rows]
        block = part[(t // 2) % row_blocks]
        block[0] += (dh0 * n).sum(0)
        block[1] += dh0.sum(0)
        block[2] += dop[rows].sum(0)
        dn = dh0 * ln_w
        dy[rows] = rstd[rows] * (dn - dn.sum(-1, keepdim=True) / C
                                 - n * ((dn * n).sum(-1, keepdim=True) / C))
    assert bool((torch.where(live, 0.0, dy) == 0).all())  # zero rows give zero dy
    dls, dlb, sum_dout = (sum(part[r, k] for r in range(row_blocks)) for k in range(3))

    ws_w1, ws_g = torch.zeros(slabs, Hd, N), torch.zeros(slabs, Hd, N)
    ws_b1 = torch.zeros(slabs, Hd)
    for hc in range(0, Hd, 64):
        ch = slice(hc, hc + 64)
        for s in range(slabs):
            for t in range(s, tiles, slabs):
                for r0 in range(t * 64, (t + 1) * 64, sub):
                    rows = slice(r0, r0 + sub)
                    a1t = w1f[ch] @ h0[rows].t() + b1[ch, None]  # [hidden][row]
                    dh1t = w2f[:, ch].t() @ d2[rows].t()
                    da1t = dh1t * _kernel_gelu_grad(a1t, approximate, tanh)
                    ws_g[s, ch] += rd(_kernel_gelu(a1t, approximate, tanh)) @ pad_cols(dop[rows])
                    ws_w1[s, ch] += rd(da1t) @ pad_cols(h0[rows])
                    ws_b1[s, ch] += da1t.sum(1)
    dw1 = sum(ws_w1[s] for s in range(slabs))[:, :C]
    g = sum(ws_g[s] for s in range(slabs))[:, :C].t()  # G = dout^T h1, (C, Hd)
    db1 = sum(ws_b1[s] for s in range(slabs))
    dw2 = gamma[:, None] * g
    db2 = gamma * sum_dout
    dg = (w2f * g).sum(1) + b2 * sum_dout
    return dy[:M].to(dt), dls, dlb, dw1, db1, dw2, db2, dg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("M,C", [(70, 32), (200, 96), (130, 192), (200, 64), (130, 160)])
def test_two_pass_tensor_core_backward_stays_inside_the_kernel_bar(dtype, approximate, M, C):
    a = _inputs(M, C, dtype, seed=M + C)
    y, dout = _torch(a["y"], dtype), _torch(a["x"], dtype)
    w1, w2 = _torch(a["w1"].T.copy(), dtype), _torch(a["w2"].T.copy(), dtype)
    vectors = [torch.tensor(a[k]) for k in ("ls", "lb", "b1", "b2", "g")]
    ls, lb, b1, b2, g = vectors
    args = (y, dout, ls, lb, w1, b1, w2, b2, g, 1e-6, approximate)
    want = tfm.fused_convnext_mlp_bwd_reference(*args)
    got = _emulate_two_pass_backward(*args)
    for name, p, q in zip(("dy", "dls", "dlb", "dw1", "db1", "dw2", "db2", "dg"), got, want):
        assert p.shape == q.shape and p.dtype == q.dtype and torch.isfinite(p).all(), name
        bar = KERNEL_BWD_TOL[dtype] * float(q.float().abs().max())
        np.testing.assert_allclose(p.float().numpy(), q.float().numpy(), rtol=0, atol=bar,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("C", [16, 32, 40, 64, 96, 128, 160, 192, 224])
def test_backward_kernel_rule(dtype, C):
    """bfloat16 at multiples of 32 up to the widest backward takes the
    tensor cores; float32, the odd widths and ragged hidden chunks do not."""
    wide = dtype == torch.bfloat16 and C % 32 == 0 and C <= tfm.MAX_WIDTH_BWD
    assert tfm.backward_kernel(C, dtype) == ("wgmma" if wide else "cuda_cores")
    assert tfm.backward_kernel(C, dtype, 4 * C) == tfm.backward_kernel(C, dtype)
    assert tfm.backward_kernel(C, dtype, 4 * C + 8) == "cuda_cores"
    assert tfm.backward_kernel(C, dtype) in tfm.BWD_KERNELS


# -------------------------------------- the tensor-core forward's arithmetic
# A plain PyTorch emulation of what the bfloat16 forward kernel computes on
# the card, tile by tile and cast for cast, held against the TPU package's
# kernel in interpret mode within the TPU kernel tests' bars: the tiling, the
# padding and the cast points chosen for the kernel stay inside those bars
# whatever the card does with them.


def _hardware_sigmoid_gelu(a):
    """The kernel's tanh-form GELU: x / (1 + exp(-2 u)) with the card's
    exp2 and reciprocal approximations, each good to a few units of
    float32's last place: taken here at 2**-21, with alternating sign."""
    u = 0.7978845608028654 * (a + 0.044715 * a * a * a)
    sign = 1.0 - 2.0 * (torch.arange(a.numel()).reshape(a.shape) % 2)
    return a / (1.0 + torch.exp(-2.0 * u)) * (1.0 + sign * 2.0 ** -21)


def emulate_tensor_core_tail(h_in, residual, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, approximate,
                             dt):
    """LN -> the MLP tail -> epilogue as the tensor-core kernels tile it, on
    float32 rows ``h_in`` (y itself for K2, the convolution's unrounded
    output for K3): 64-row tiles with zero rows past M, C padded with zero
    columns to whole 64-column atoms, the hidden dim in 64-column chunks, h0
    and each chunk's h1 rounded to ``dt``, the second product accumulated in
    float32 across the chunks, then (acc + b2) * gamma [+ residual] in
    float32 and one cast."""
    M, C = h_in.shape
    Hd = w1.shape[0]
    assert Hd % 64 == 0 and C % 32 == 0
    CP = -(-C // 64) * 64
    rd = lambda t: t.to(dt).float()  # noqa: E731
    w1f = w1.float()                                                 # [hidden][c]
    w2p = torch.nn.functional.pad(w2.float(), (0, 0, 0, CP - C))     # [c padded][hidden]
    gelu = (_hardware_sigmoid_gelu if dt == torch.bfloat16 else
            lambda a: torch.nn.functional.gelu(a, approximate="tanh")) if approximate else (
        lambda a: torch.nn.functional.gelu(a))
    out = torch.empty(M, C, dtype=dt)
    for r0 in range(0, M, 64):
        rows = min(64, M - r0)
        yt = torch.zeros(64, C)
        yt[:rows] = h_in[r0:r0 + rows]
        mean = yt.mean(-1, keepdim=True)
        rstd = torch.rsqrt((yt - mean).square().mean(-1, keepdim=True) + eps)
        h0 = rd((yt - mean) * rstd * ln_w + ln_b)
        h0[rows:] = 0.0                                              # rows past M arrive as zeros
        acc = torch.zeros(64, CP)
        for hc in range(0, Hd, 64):
            ch = slice(hc, hc + 64)
            a1 = h0 @ w1f[ch].t() + b1[ch]                           # inner C, no padding read
            acc += rd(gelu(a1)) @ w2p[:, ch].t()                     # across the padded C
        t = (acc[:rows, :C] + b2) * gamma
        if residual is not None:
            t = t + residual[r0:r0 + rows].float()
        out[r0:r0 + rows] = t.to(dt)
        assert bool((acc[:, C:] == 0).all())                         # padded columns stay zero
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("M,C", [(70, 32), (200, 96), (130, 192)])
def test_tensor_core_forward_tiling_matches_pallas(dtype, approximate, residual, M, C):
    a = _inputs(M, C, dtype, seed=M + C)
    jdt, dt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jfm.fused_convnext_mlp(
        jnp.asarray(a["y"], jdt), jnp.asarray(a["x"], jdt) if residual else None,
        a["ls"], a["lb"], jnp.asarray(a["w1"], jdt), a["b1"],
        jnp.asarray(a["w2"], jdt), a["b2"], a["g"], approximate_gelu=approximate,
    )
    y, x = _torch(a["y"], dtype), _torch(a["x"], dtype)
    w1, w2 = _torch(a["w1"].T.copy(), dtype), _torch(a["w2"].T.copy(), dtype)
    ls, lb, b1, b2, g = (torch.tensor(a[k]) for k in ("ls", "lb", "b1", "b2", "g"))
    out = emulate_tensor_core_tail(y.float(), x if residual else None, ls, lb, w1, b1, w2, b2, g,
                                   1e-6, approximate, dt)
    assert out.dtype == dt and out.shape == (M, C) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=TOL[dtype])
    # and within the same bar of the wrapper's plain version, which the card run holds it to
    plain = tfm.fused_convnext_mlp_reference(y, x if residual else None, ls, lb, w1, b1, w2, b2, g,
                                             1e-6, approximate)
    np.testing.assert_allclose(out.float().numpy(), plain.float().numpy(), atol=TOL[dtype])


WIDTHS = [16, 32, 40, 64, 96, 128, 160, 192, 224, 256, 288, 384, 512]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("C", WIDTHS)
def test_forward_kernel_rule(dtype, C):
    """bfloat16 at multiples of 32 up to the widest forward takes the tensor
    cores; float32, the odd widths and ragged hidden chunks do not."""
    wide = dtype == torch.bfloat16 and C % 32 == 0 and C <= tfm.MAX_WIDTH
    assert tfm.forward_kernel(C, dtype) == ("wgmma" if wide else "cuda_cores")
    assert tfm.forward_kernel(C, dtype, 4 * C) == tfm.forward_kernel(C, dtype)
    assert tfm.forward_kernel(C, dtype, 4 * C + 8) == "cuda_cores"
    assert tfm.forward_kernel(C, dtype) in tfm.KERNELS
    # the backward's tensor-core widths are among the forward's
    if tfm.backward_kernel(C, dtype) == "wgmma":
        assert tfm.forward_kernel(C, dtype) == "wgmma"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("C", WIDTHS)
def test_kernel_takes_rule(dtype, C):
    """The widths the kernels take at all: up to 256 forward, up to 192
    where a gradient is wanted; float16 never."""
    known = dtype in (torch.float32, torch.bfloat16)
    assert tfm.kernel_takes(C, dtype, needs_grad=False) == (known and C <= 256)
    assert tfm.kernel_takes(C, dtype, needs_grad=True) == (known and C <= 192)
    assert (tfm.MAX_WIDTH, tfm.MAX_WIDTH_BWD) == (256, 192)


class _Recorder:
    """Stands in for ``fused_convnext_mlp`` in the block: records the call
    and answers with the plain version."""

    def __init__(self):
        self.calls = 0

    def __call__(self, y, residual, ln_w, ln_b, w1, b1, w2, b2, gamma, *, eps, approximate_gelu,
                 scale=None):
        self.calls += 1
        return tfm.fused_convnext_mlp(y, residual, ln_w, ln_b, w1, b1, w2, b2, gamma, eps=eps,
                                      approximate_gelu=approximate_gelu, scale=scale)


@pytest.mark.parametrize("dim", [96, 192, 256, 384, 512])
@pytest.mark.parametrize("grad", [False, True])
def test_block_chooses_by_shape_before_any_launch(monkeypatch, dim, grad):
    """``ConvNeXtBlock(fused_mlp=None)`` on a tensor that says it lies on the
    card goes to K2 exactly where ``kernel_takes`` says so (lg's and xl's
    widths past it take the plain modules); on a CPU tensor never."""
    from linnaeus_tpu_torch.models.blocks import convnext

    block = convnext.ConvNeXtBlock(dim).requires_grad_(grad)
    rec = _Recorder()
    monkeypatch.setattr(convnext, "fused_convnext_mlp", rec)
    x = torch.randn(1, 7, 7, dim)
    with torch.set_grad_enabled(grad):
        want = block(x)
        assert rec.calls == 0  # a CPU tensor takes the plain modules

        class OnCard(torch.Tensor):  # the same values, claiming to be a CUDA tensor
            is_cuda = True

        monkeypatch.setattr(convnext, "conv_nhwc",
                            lambda conv, t: conv(t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
                            .as_subclass(OnCard))
        got = block(x)
    assert rec.calls == int(tfm.kernel_takes(dim, torch.float32, needs_grad=grad))
    assert rec.calls == int(dim <= (192 if grad else 256))
    torch.testing.assert_close(got.as_subclass(torch.Tensor), want, rtol=1e-5, atol=1e-5)


class _FakeCuda:
    type = "cuda"

    def __eq__(self, other):
        return isinstance(other, _FakeCuda)

    def __ne__(self, other):
        return not self == other


class _Face:
    """A CUDA tensor's face as ``_check_operands`` reads it."""

    def __init__(self, shape, dtype, ptr=0):
        self.shape, self.dtype, self.device, self._ptr = torch.Size(shape), dtype, _FakeCuda(), ptr

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self._ptr


def _faces(dtype, C, M=8, y_ptr=0, w2_ptr=0):
    f, T = torch.float32, _Face
    return (T((M, C), dtype, y_ptr), T((M, C), dtype), T((C,), f), T((C,), f),
            T((4 * C, C), dtype), T((4 * C,), f), T((C, 4 * C), dtype, w2_ptr), T((C,), f),
            T((C,), f))


@pytest.mark.parametrize("C", [288, 384, 512])
def test_forced_kernel_past_its_widths_raises_by_name(C):
    """``fused_mlp=True`` is a demand, not a preference: past the kernels'
    widths the wrapper's check raises a ValueError that names the width."""
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match=f"width C={C} is outside 1..256"):
            tfm._check_operands(*_faces(dtype, C))
    tfm._check_operands(*_faces(torch.bfloat16, 256))


def test_bf16_operands_must_be_16_byte_aligned():
    """The tensor-core route copies 16 bytes at a time: a bfloat16 operand
    whose first element is off a 16-byte boundary is refused by name; the
    CUDA-core route (float32, odd widths) does not care."""
    dt = torch.bfloat16
    tfm._check_operands(*_faces(dt, 32))
    with pytest.raises(ValueError, match="y is misaligned.*8 bytes past"):
        tfm._check_operands(*_faces(dt, 32, y_ptr=4096 + 8))
    with pytest.raises(ValueError, match="w2 is misaligned.*2 bytes past"):
        tfm._check_operands(*_faces(dt, 32, w2_ptr=2))
    tfm._check_operands(*_faces(torch.float32, 32, y_ptr=4))  # float32: CUDA cores
    tfm._check_operands(*_faces(dt, 40, y_ptr=2))             # an odd width: CUDA cores
