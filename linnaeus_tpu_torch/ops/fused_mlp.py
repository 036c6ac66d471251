"""K2 forward: the fused ConvNeXt MLP tail as one hand-written CUDA kernel.

Port of linnaeus_tpu/ops/fused_mlp.py (``_body`` via ``_pallas_fused``):
LN -> Linear(4C) -> GELU (tanh or erf) -> Linear(C) -> x gamma
[-> + residual], tiled over rows so the (M, 4C) intermediate never reaches
device memory. The kernel is ``csrc/fused_mlp_fwd.cu``.

Weights use the torch Linear layout of the block's ``pwconv1`` (4C, C) and
``pwconv2`` (C, 4C). ``fused_convnext_mlp`` launches the kernel for CUDA
tensors and runs :func:`fused_convnext_mlp_reference` for CPU tensors. There
is no backward yet: asking for gradients through the CUDA path raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from linnaeus_tpu_torch import _kernels

MAX_WIDTH = 256  # widest C the kernel's column split covers

# kernel launches in this process; the serving path's proof of use
LAUNCHES = 0


def fused_convnext_mlp_reference(
    y2: torch.Tensor,
    x2: torch.Tensor | None,
    ln_w: torch.Tensor,
    ln_b: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    gamma: torch.Tensor,
    eps: float,
    approximate: bool,
) -> torch.Tensor:
    """Plain version on (M, C) rows, cast for cast as the TPU package's
    ``_xla_reference``: LN in float32 rounded to y's dtype, both products
    accumulated in float32, GELU in float32 rounded to y's dtype, then bias,
    gamma and the residual in float32 and one cast to y's dtype. The
    vectors are float32."""
    dt = y2.dtype
    yf = y2.float()
    mean = yf.mean(dim=-1, keepdim=True)
    var = (yf - mean).square().mean(dim=-1, keepdim=True)
    h0 = ((yf - mean) * torch.rsqrt(var + eps) * ln_w + ln_b).to(dt)
    h1 = torch.matmul(h0.float(), w1.float().t()) + b1
    h1 = F.gelu(h1, approximate="tanh" if approximate else "none").to(dt)
    out = torch.matmul(h1.float(), w2.float().t())
    out = (out + b2) * gamma
    if x2 is not None:
        out = x2.float() + out
    return out.to(dt)


def fused_convnext_mlp(
    y: torch.Tensor,
    residual: torch.Tensor | None,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    gamma: torch.Tensor | None,
    *,
    eps: float = 1e-6,
    approximate_gelu: bool = True,
) -> torch.Tensor:
    """LN -> Linear(4C) -> GELU -> Linear(C) -> x gamma [-> + residual] over
    ``y`` of shape (..., C); ``residual=None`` skips the add. ``w1`` is
    (4C, C) and ``w2`` (C, 4C) in y's dtype; the vectors are cast to
    float32. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    shape = y.shape
    C = shape[-1]
    y2 = y.reshape(-1, C)
    x2 = None if residual is None else residual.reshape(-1, C)
    if gamma is None:
        gamma = torch.ones(C, dtype=torch.float32, device=y.device)
    ln_w, ln_b, b1f, b2f, g = (t.float() for t in (ln_scale, ln_bias, b1, b2, gamma))
    if y.device.type == "cpu":
        out = fused_convnext_mlp_reference(
            y2, x2, ln_w, ln_b, w1, b1f, w2, b2f, g, eps, approximate_gelu
        )
    else:
        out = _launch(y2, x2, ln_w, ln_b, w1, b1f, w2, b2f, g, eps, approximate_gelu)
    return out.reshape(shape)


def _launch(y2, x2, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, approximate):
    M, C = y2.shape
    Hd = w1.shape[0]
    _check_operands(y2, x2, ln_w, ln_b, w1, b1, w2, b2, gamma)
    out = torch.empty_like(y2)
    lib = _kernels.library()
    err = lib.lt_fused_mlp_fwd(
        y2.data_ptr(), None if x2 is None else x2.data_ptr(),
        ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(), out.data_ptr(),
        M, C, Hd, float(eps), int(approximate),
        _kernels.DTYPE_CODES[y2.dtype], _kernels.stream_handle(y2.device),
    )
    _kernels.check(err, "fused_convnext_mlp")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _check_operands(y2, x2, ln_w, ln_b, w1, b1, w2, b2, gamma) -> None:
    M, C = y2.shape
    Hd = w1.shape[0]
    if y2.device.type != "cuda":
        raise ValueError(f"fused_convnext_mlp: the kernel takes CUDA tensors, y is on {y2.device}")
    if y2.dtype not in _kernels.DTYPE_CODES:
        raise TypeError(f"fused_convnext_mlp: y is {y2.dtype}; expected float32 or bfloat16")
    if not 1 <= C <= MAX_WIDTH:
        raise ValueError(f"fused_convnext_mlp: width C={C} is outside 1..{MAX_WIDTH}")
    if M < 1:
        raise ValueError("fused_convnext_mlp: no rows")
    expected = {
        "y": (y2, (M, C), y2.dtype),
        "w1": (w1, (Hd, C), y2.dtype),
        "w2": (w2, (C, Hd), y2.dtype),
        "ln_scale": (ln_w, (C,), torch.float32),
        "ln_bias": (ln_b, (C,), torch.float32),
        "b1": (b1, (Hd,), torch.float32),
        "b2": (b2, (C,), torch.float32),
        "gamma": (gamma, (C,), torch.float32),
    }
    if x2 is not None:
        expected["residual"] = (x2, (M, C), y2.dtype)
    for name, (t, shape, dtype) in expected.items():
        if t.device != y2.device:
            raise ValueError(f"fused_convnext_mlp: {name} is on {t.device}, y on {y2.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"fused_convnext_mlp: {name} is {tuple(t.shape)} {t.dtype}; "
                f"expected {shape} {dtype}"
            )
        if not t.is_contiguous():
            raise ValueError(f"fused_convnext_mlp: {name} must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "fused_convnext_mlp: the CUDA backward kernel is not ported yet"
            )
