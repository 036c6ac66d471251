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
