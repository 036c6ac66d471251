"""The port's K1 forward (plain version on CPU) against the TPU package.

The JAX side is ``flash_attention`` run through Pallas interpret mode, as
tests/test_flash_attention.py runs it, and ``sdpa_bnhd``. Inputs come from
numpy with a fixed seed. Tolerances are the TPU kernel tests' own: fp32
2e-5, bf16 3e-2.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import linnaeus_tpu.ops.flash_attention as jfa
from linnaeus_tpu.ops.attention import sdpa_bnhd as jax_sdpa_bnhd
from linnaeus_tpu_torch.ops import flash_attention as tfa
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
