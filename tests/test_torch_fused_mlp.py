"""The port's K2 forward (plain version on CPU) against the TPU package's
``fused_convnext_mlp`` run through Pallas interpret mode, as
tests/test_fused_mlp.py runs it. Inputs come from numpy with a fixed seed.
Tolerances are the TPU kernel tests' own: fp32 1e-5, bf16 5e-2.
"""

import functools

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
