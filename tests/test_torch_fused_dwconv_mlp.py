"""The port's K3 (plain version on CPU) against the TPU package's fused
ConvNeXt block kernel.

The JAX side is ``fused_convnext_block`` run through Pallas interpret mode at
the shapes of tests/test_fused_dwconv_mlp.py; inputs come from numpy with a
fixed seed and cross the bridge ``convnext_block_args_from_jax``. Tolerances
are the TPU kernel tests' own: fp32 atol 1e-4; bf16 atol 0.15 with rtol
0.08; gradients 1e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import linnaeus_tpu.ops.fused_dwconv_mlp as jfb
from linnaeus_tpu_torch.ops import fused_dwconv_mlp as tfb
from linnaeus_tpu_torch.utils.convert import convnext_block_args_from_jax


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(
        jfb.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _inputs(B=2, H=16, W=12, C=8, seed=0):
    """The JAX argument tuple as float32 numpy arrays, in the TPU package's
    layouts: taps (7, 7, C), Dense kernels (C, 4C) and (4C, C)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return (n(B, H, W, C), n(7, 7, C) * 0.2, n(C) * 0.1, n(C) * 0.1 + 1.0, n(C) * 0.1,
            n(C, 4 * C) * 0.1, n(4 * C) * 0.1, n(4 * C, C) * 0.1, n(C) * 0.1,
            np.full((C,), 0.5, np.float32))


def _jax_args(args, dtype):
    x, k, kb, ls, lb, w1, b1, w2, b2, g = (jnp.asarray(a) for a in args)
    return (x.astype(dtype), k, kb, ls, lb, w1.astype(dtype), b1, w2.astype(dtype), b2, g)


def _rounded(args, dtype):
    """``args`` with x, w1 and w2 rounded through ``dtype``, as float32 numpy."""
    return tuple(np.asarray(a, np.float32) for a in _jax_args(args, dtype))


@pytest.mark.parametrize("shape,tile_h,approximate", [
    ((2, 16, 12, 8), 4, True),   # four tiles: first, middle and last windows
    ((1, 8, 9, 8), 8, True),     # one tile: both halo slabs are the border
    ((2, 16, 12, 8), 4, False),  # erf GELU
])
def test_plain_k3_matches_pallas_block_kernel(shape, tile_h, approximate):
    args = _inputs(*shape)
    ref = jfb.fused_convnext_block(*_jax_args(args, jnp.float32), tile_h=tile_h,
                                   approximate_gelu=approximate)
    out = tfb.fused_convnext_block(*convnext_block_args_from_jax(*args),
                                   approximate_gelu=approximate)
    assert out.shape == shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    assert tfb.LAUNCHES == 0  # CPU tensors never reach the kernel


def test_plain_k3_matches_pallas_block_kernel_bf16():
    args = _inputs(seed=3)
    ref = jfb.fused_convnext_block(*_jax_args(args, jnp.bfloat16), tile_h=4)
    targs = convnext_block_args_from_jax(*_rounded(args, jnp.bfloat16), dtype=torch.bfloat16)
    out = tfb.fused_convnext_block(*targs)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=0.15, rtol=0.08)
    # the kernel's plain version keeps the convolution in float32; the chain
    # convolves in bf16, so the two differ by bf16 roundings only
    chain = tfb.convnext_block_chain(*targs, 1e-6, True)
    np.testing.assert_allclose(out.float().numpy(), chain.float().numpy(), atol=0.15, rtol=0.08)


def test_k3_gradients_match_jax():
    """x, taps, LN scale and W1 gradients of sum(out**2): the port's Function
    (backward through the plain chain) against jax.grad through the TPU
    package's custom_vjp, at the TPU test's shape and its 1e-3 bar."""
    args = _inputs(B=1, H=8, W=8, C=8, seed=5)

    def loss(*a):
        return jnp.sum(jfb.fused_convnext_block(*a, tile_h=4).astype(jnp.float32) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 3, 5))(*_jax_args(args, jnp.float32))
    targs = [t.requires_grad_() for t in convnext_block_args_from_jax(*args)]
    tfb.fused_convnext_block(*targs).square().sum().backward()
    x, taps, _, ls, _, w1, *_ = targs
    got = (x.grad.numpy(),
           taps.grad.numpy()[:, 0].transpose(1, 2, 0),  # (C, 1, 7, 7) -> (7, 7, C)
           ls.grad.numpy(),
           w1.grad.numpy().T)  # (4C, C) -> (C, 4C)
    for name, a, b in zip(("x", "taps", "ln_scale", "w1"), got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-3, rtol=1e-3, err_msg=name)
    assert all(t.grad is not None for t in targs)


def test_k3_chain_matches_jax_xla_reference():
    args = _inputs(B=1, H=9, W=7, C=8, seed=6)
    x, k, kb, ls, lb, w1, b1, w2, b2, g = _jax_args(args, jnp.float32)
    row = lambda v: v[None, :]  # noqa: E731
    ref = jfb._xla_reference(x, k.reshape(49, 8), row(kb), row(ls), row(lb), w1, row(b1), w2,
                             row(b2), row(g), 1e-6, True)
    out = tfb.convnext_block_chain(*convnext_block_args_from_jax(*args), 1e-6, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_convnext_block_args_from_jax_layouts():
    args = _inputs(B=1, H=7, W=7, C=8, seed=7)
    x, taps, kb, ls, lb, w1, b1, w2, b2, g = convnext_block_args_from_jax(
        *args, dtype=torch.bfloat16)
    assert taps.shape == (8, 1, 7, 7) and taps.dtype == torch.float32
    assert w1.shape == (32, 8) and w2.shape == (8, 32) and w1.is_contiguous()
    assert x.dtype == w1.dtype == w2.dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in (kb, ls, lb, b1, b2, g))
    np.testing.assert_array_equal(taps[3, 0, 2, 5].item(), args[1][2, 5, 3])
    np.testing.assert_array_equal(w1.float().numpy(), _rounded(args, jnp.bfloat16)[5].T)
    hwio = convnext_block_args_from_jax(args[0], args[1][:, :, None, :], *args[2:])[1]
    assert torch.equal(hwio, taps)


def test_k3_takes_any_image_of_at_least_seven_pixels():
    # the TPU kernel's H % tile_h rule is not carried over
    args = convnext_block_args_from_jax(*_inputs(B=1, H=10, W=7, C=8))
    assert tfb.fused_convnext_block(*args).shape == (1, 10, 7, 8)
    small = convnext_block_args_from_jax(*_inputs(B=1, H=6, W=8, C=8))
    with pytest.raises(ValueError, match="at least 7"):
        tfb.fused_convnext_block(*small)


# ------------------------------------------ the tensor-core tail's arithmetic
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("shape", [(1, 8, 9, 32), (2, 9, 11, 96)])
def test_tensor_core_tail_tiling_matches_pallas_block_kernel(dtype, approximate, shape):
    """The bfloat16 kernel on the card keeps the convolution in float32 and
    hands its unrounded output to K2's tensor-core tail: a plain PyTorch
    emulation of that (the convolution as the plain version does it, then
    the tail tile by tile and cast for cast, 64 pixels a tile) against the
    TPU package's kernel in interpret mode, within the TPU kernel tests'
    bars (fp32 1e-4; bf16 atol 0.15 with rtol 0.08) and within K2's bars of
    the wrapper's plain version (1e-5 and 5e-2), to which the card run holds
    the kernel."""
    from tests.test_torch_fused_mlp import emulate_tensor_core_tail

    jdt, dt = getattr(jnp, dtype), getattr(torch, dtype)
    B, H, W, C = shape
    args = _inputs(*shape, seed=C)
    ref = jfb.fused_convnext_block(*_jax_args(args, jdt), tile_h=H if H % 4 else 4,
                                   approximate_gelu=approximate)
    x, dw, kb, ls, lb, w1, b1, w2, b2, g = convnext_block_args_from_jax(
        *_rounded(args, jdt), dtype=dt)
    padded = torch.nn.functional.pad(x.float(), (0, 0, 3, 3, 3, 3))
    taps = tfb._taps(dw)
    y = torch.zeros(B, H, W, C)
    for dh in range(7):
        for dwi in range(7):
            y += padded[:, dh:dh + H, dwi:dwi + W, :] * taps[dh * 7 + dwi]
    y = y + kb
    out = emulate_tensor_core_tail(y.reshape(-1, C), x.reshape(-1, C), ls, lb, w1, b1, w2, b2, g,
                                   1e-6, approximate, dt).reshape(shape)
    bars = {"float32": dict(atol=1e-4), "bfloat16": dict(atol=0.15, rtol=0.08)}[dtype]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **bars)
    plain = tfb.fused_convnext_block_reference(x, dw, kb, ls, lb, w1, b1, w2, b2, g, 1e-6,
                                               approximate)
    np.testing.assert_allclose(out.float().numpy(), plain.float().numpy(),
                               atol={"float32": 1e-5, "bfloat16": 5e-2}[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("C", [16, 32, 40, 64, 96, 128, 160, 192, 224, 256])
def test_k3_forward_kernel_rule(dtype, C):
    """K3's tail runs on the tensor cores where K2's forward does, up to
    K3's own widest C."""
    from linnaeus_tpu_torch.ops import fused_mlp as tfm

    wide = dtype == torch.bfloat16 and C % 32 == 0 and C <= tfb.MAX_WIDTH
    assert tfb.forward_kernel(C, dtype) == ("wgmma" if wide else "cuda_cores")
    assert tfb.forward_kernel(C, dtype, 4 * C + 8) == "cuda_cores"
    if C <= tfb.MAX_WIDTH:
        assert tfb.forward_kernel(C, dtype) == tfm.forward_kernel(C, dtype)
