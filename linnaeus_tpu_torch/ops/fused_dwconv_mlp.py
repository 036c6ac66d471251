"""K3: a whole ConvNeXt block as one hand-written CUDA kernel, forward only.

Port of linnaeus_tpu/ops/fused_dwconv_mlp.py: ``_block_kernel`` (via
``_pallas_block`` and ``fused_convnext_block``), 7x7 depthwise conv -> LN ->
Linear(4C) -> GELU (tanh or erf) -> Linear(C) -> x gamma -> + the block's
input, on NHWC activations. Neither the convolution's output nor the
(M, 4C) hidden tensor reaches device memory. The kernel is
``csrc/fused_dwconv_mlp_fwd.cu``; it shares the LN -> MLP body with K2: in
bfloat16 at K2's tensor-core widths the tail after the convolution is K2's
``wgmma`` tail, in float32 and at the other widths its CUDA-core tail
(:func:`forward_kernel`).

Parameters use the torch layouts of the block's modules: the depthwise
weight (C, 1, 7, 7), ``pwconv1`` (4C, C), ``pwconv2`` (C, 4C).
``fused_convnext_block`` is differentiable as in the TPU package: there is
no backward kernel; a ``torch.autograd.Function`` saves the inputs and its
backward differentiates :func:`convnext_block_chain`, the plain chain of
PyTorch operators, recomputing the forward. CUDA tensors launch the kernel
or raise; CPU tensors run :func:`fused_convnext_block_reference`, the plain
PyTorch version with the kernel's casts.

As in the TPU package, no model routes its ConvNeXt blocks here: the only
caller is tools/fused_block_ab.py, which holds this kernel against the
production route (a library depthwise convolution followed by K2).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from linnaeus_tpu_torch import _kernels
from linnaeus_tpu_torch.ops import fused_mlp

MAX_WIDTH = 192  # widest C whose tile and window fit an SM's shared memory
MIN_SIDE = 7  # smallest H and W: one full kernel footprint

# kernel launches in this process: the proof that a path went through K3
LAUNCHES = 0


def forward_kernel(C: int, dtype: torch.dtype, hidden: int | None = None) -> str:
    """"wgmma" or "cuda_cores": where the kernel runs its MLP tail for width
    ``C``, hidden width ``hidden`` (4C if None) and ``dtype``: K2's rule up
    to this kernel's own widest C. The same rule as ``block_takes_wgmma`` in
    ``csrc/fused_dwconv_mlp_fwd.cu``."""
    return fused_mlp.forward_kernel(C, dtype, hidden) if C <= MAX_WIDTH else "cuda_cores"


def _taps(dw_weight: torch.Tensor) -> torch.Tensor:
    """(C, 1, 7, 7) depthwise weight -> (49, C) float32 taps, tap
    dh * 7 + dw of channel c at [dh * 7 + dw, c]."""
    C = dw_weight.shape[0]
    return dw_weight.reshape(C, 49).t().float().contiguous()


def fused_convnext_block_reference(
    x: torch.Tensor,
    dw_weight: torch.Tensor,
    dw_bias: torch.Tensor,
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
    """Plain version of the kernel on (B, H, W, C), cast for cast as the TPU
    package's ``_block_kernel``: the convolution as 49 float32 multiply-adds
    over the zero-padded float32 input with float32 taps and bias, its
    output unrounded into the LN; from there the K2 plain version (LN and
    GELU rounded to x's dtype before their products, float32 accumulation,
    bias, gamma and the residual x in float32, one cast)."""
    B, H, W, C = x.shape
    taps = _taps(dw_weight)
    padded = F.pad(x.float(), (0, 0, 3, 3, 3, 3))
    y = torch.zeros((B, H, W, C), dtype=torch.float32, device=x.device)
    for dh in range(7):
        for dw in range(7):
            y += padded[:, dh:dh + H, dw:dw + W, :] * taps[dh * 7 + dw]
    y = y + dw_bias.float()
    out = fused_mlp.fused_convnext_mlp_reference(
        y.reshape(-1, C), x.reshape(-1, C), ln_w.float(), ln_b.float(), w1, b1.float(),
        w2, b2.float(), gamma.float(), eps, approximate, dtype=x.dtype,
    )
    return out.reshape(B, H, W, C)


def convnext_block_chain(
    x: torch.Tensor,
    dw_weight: torch.Tensor,
    dw_bias: torch.Tensor,
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
    """The block as a chain of PyTorch operators, the port of the TPU
    package's ``_xla_reference``: the depthwise convolution in x's dtype
    (taps cast to it), the bias and the LN in float32, LN and GELU rounded
    to x's dtype before their products, bias, gamma and the residual in
    float32, one cast. The two products run in x's dtype, as the unfused
    ``ConvNeXtBlock`` runs them (the TPU chain keeps their float32 results;
    in bf16 that is one more rounding each). K3's backward differentiates
    this, and tools/fused_block_ab.py times it as the plain contender."""
    dt = x.dtype
    y = F.conv2d(x.permute(0, 3, 1, 2), dw_weight.to(dt), None, padding=3,
                 groups=x.shape[-1]).permute(0, 2, 3, 1)
    y = y.float() + dw_bias.float()
    mean = y.mean(dim=-1, keepdim=True)
    var = (y - mean).square().mean(dim=-1, keepdim=True)
    h0 = ((y - mean) * torch.rsqrt(var + eps) * ln_w.float() + ln_b.float()).to(dt)
    h1 = F.linear(h0, w1).float() + b1.float()
    h1 = F.gelu(h1, approximate="tanh" if approximate else "none").to(dt)
    out = (F.linear(h1, w2).float() + b2.float()) * gamma.float()
    return (x.float() + out).to(dt)


class _FusedConvNeXtBlock(torch.autograd.Function):
    """(x, dw_weight, dw_bias, ln_w, ln_b, w1, b1, w2, b2, gamma, eps,
    approximate) -> out; the backward recomputes through the plain chain."""

    @staticmethod
    def forward(ctx, x, dw_weight, dw_bias, ln_w, ln_b, w1, b1, w2, b2, gamma, eps,
                approximate):
        run = fused_convnext_block_reference if x.device.type == "cpu" else _launch
        out = run(x, dw_weight, dw_bias, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, approximate)
        ctx.save_for_backward(x, dw_weight, dw_bias, ln_w, ln_b, w1, b1, w2, b2, gamma)
        ctx.eps, ctx.approximate = eps, approximate
        return out

    @staticmethod
    def backward(ctx, dout):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
            out = convnext_block_chain(*leaves, ctx.eps, ctx.approximate)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, dout))
        return (*(next(grads) if t.requires_grad else None for t in leaves), None, None)


def fused_convnext_block(
    x: torch.Tensor,
    dw_weight: torch.Tensor,
    dw_bias: torch.Tensor,
    ln_weight: torch.Tensor,
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
    """The whole ConvNeXt block over NHWC ``x`` of shape (B, H, W, C), H and
    W at least 7: 7x7 depthwise conv (``dw_weight`` (C, 1, 7, 7), zero
    padding 3) + ``dw_bias`` -> LN -> Linear ``w1`` (4C, C) -> GELU -> Linear
    ``w2`` (C, 4C) -> x ``gamma`` -> + x. ``w1`` and ``w2`` are in x's dtype;
    the depthwise weight and the vectors may be any float dtype and are read
    as float32. Differentiable in every tensor operand (the backward
    recomputes the plain chain). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if x.dim() != 4:
        raise ValueError(f"fused_convnext_block: x has shape {tuple(x.shape)}; expected (B, H, W, C)")
    B, H, W, C = x.shape
    if H < MIN_SIDE or W < MIN_SIDE:
        raise ValueError(
            f"fused_convnext_block: H and W must be at least {MIN_SIDE}, got ({H}, {W})"
        )
    if gamma is None:
        gamma = torch.ones(C, dtype=torch.float32, device=x.device)
    return _FusedConvNeXtBlock.apply(
        x, dw_weight, dw_bias, ln_weight, ln_bias, w1, b1, w2, b2, gamma,
        float(eps), bool(approximate_gelu),
    )


def _launch(x, dw_weight, dw_bias, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, approximate):
    B, H, W, C = x.shape
    Hd = w1.shape[0]
    _check_operands(x, dw_weight, dw_bias, ln_w, ln_b, w1, b1, w2, b2, gamma)
    taps = _taps(dw_weight)
    vectors = [t.float().contiguous() for t in (dw_bias, ln_w, ln_b, b1, b2, gamma)]
    kb, lw, lb, b1f, b2f, g = vectors
    out = torch.empty_like(x)
    err = _kernels.library().lt_fused_convnext_block_fwd(
        x.data_ptr(), taps.data_ptr(), kb.data_ptr(), lw.data_ptr(), lb.data_ptr(),
        w1.data_ptr(), b1f.data_ptr(), w2.data_ptr(), b2f.data_ptr(), g.data_ptr(),
        out.data_ptr(), B, H, W, C, Hd, float(eps), int(approximate),
        _kernels.DTYPE_CODES[x.dtype], _kernels.stream_handle(x.device),
    )
    _kernels.check(err, "fused_convnext_block")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _check_operands(x, dw_weight, dw_bias, ln_w, ln_b, w1, b1, w2, b2, gamma) -> None:
    B, H, W, C = x.shape
    Hd = w1.shape[0]
    if x.device.type != "cuda":
        raise ValueError(f"fused_convnext_block: the kernel takes CUDA tensors, x is on {x.device}")
    if x.dtype not in _kernels.DTYPE_CODES:
        raise TypeError(f"fused_convnext_block: x is {x.dtype}; expected float32 or bfloat16")
    if not 1 <= C <= MAX_WIDTH:
        raise ValueError(f"fused_convnext_block: width C={C} is outside 1..{MAX_WIDTH}")
    if not 1 <= B <= 65535:
        raise ValueError(f"fused_convnext_block: batch {B} is outside 1..65535")
    if not x.is_contiguous():
        raise ValueError("fused_convnext_block: x must be contiguous (B, H, W, C)")
    expected = {
        "dw_weight": (dw_weight, (C, 1, 7, 7), None),
        "dw_bias": (dw_bias, (C,), None),
        "ln_weight": (ln_w, (C,), None),
        "ln_bias": (ln_b, (C,), None),
        "w1": (w1, (Hd, C), x.dtype),
        "b1": (b1, (Hd,), None),
        "w2": (w2, (C, Hd), x.dtype),
        "b2": (b2, (C,), None),
        "gamma": (gamma, (C,), None),
    }
    for name, (t, shape, dtype) in expected.items():
        if t.device != x.device:
            raise ValueError(f"fused_convnext_block: {name} is on {t.device}, x on {x.device}")
        if tuple(t.shape) != shape or (dtype is not None and t.dtype != dtype):
            raise ValueError(
                f"fused_convnext_block: {name} is {tuple(t.shape)} {t.dtype}; expected "
                f"{shape}" + (f" {dtype}" if dtype is not None else "")
            )
    for name, t in (("w1", w1), ("w2", w2)):
        if not t.is_contiguous():
            raise ValueError(f"fused_convnext_block: {name} must be contiguous")
    if forward_kernel(C, x.dtype, Hd) == "wgmma":
        # the tensor-core tail copies and stores 16 bytes at a time
        for name, t in (("x", x), ("w1", w1), ("w2", w2)):
            if t.data_ptr() % 16:
                raise ValueError(
                    f"fused_convnext_block: {name} is misaligned for the bfloat16 kernel: its "
                    f"first element lies {t.data_ptr() % 16} bytes past a 16-byte boundary"
                )
