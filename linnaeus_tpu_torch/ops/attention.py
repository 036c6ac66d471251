"""Attention dispatch: the plain PyTorch path or the K1 CUDA kernel.

Port of linnaeus_tpu/ops/attention.py. The plain path is softmax attention
written with two einsums; ``fp32_softmax`` chooses where its scores live:
True computes them in float32, False in q's dtype (the softmax itself runs
in float32 either way), which is what the TPU package's configs run by
default (``MODEL.ATTN_FP32_SOFTMAX: False``). ``use_flash`` sends every call
to :func:`linnaeus_tpu_torch.ops.flash_attention.flash_attention` (the CUDA
kernel for CUDA tensors, its plain version for CPU tensors), on which
``fp32_softmax`` has no effect. The TPU package's sequence-length gate is
not carried over: it was measured on a TPU.
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention


def sdpa_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
    fp32_softmax: bool = True,
) -> torch.Tensor:
    """Softmax attention on head-major (B, H, N, D) operands: the softmax in
    float32, probabilities cast to v's dtype, the product with V accumulated
    in float32, the output in v's dtype. ``fp32_softmax=True`` computes the
    scores in float32 from ``q * scale``; False computes them from
    ``q * scale`` in q's dtype (scale rounded to it) with the result in q's
    dtype, so in bf16 the (N, N) score tensor is stored in bf16."""
    return _sdpa(q, k, v, scale, fp32_softmax, "bhqd,bhkd->bhqk", "bhqk,bhkd->bhqd")


def sdpa_bnhd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
    fp32_softmax: bool = True,
) -> torch.Tensor:
    """:func:`sdpa_reference` on token-major (B, N, H, D) operands, as a qkv
    projection emits them; the output is (B, N, H, D)."""
    return _sdpa(q, k, v, scale, fp32_softmax, "bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd")


def _sdpa(q, k, v, scale, fp32_softmax, scores_eq, out_eq):
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if fp32_softmax:
        logits = torch.einsum(scores_eq, q.float() * scale, k.float())
    else:
        # the scale is rounded to q's dtype before the product, as a scalar
        # of that dtype would be
        scale = torch.tensor(scale, dtype=q.dtype).item()
        logits = torch.einsum(scores_eq, q * scale, k).float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum(out_eq, probs, v).to(v.dtype)


def scaled_dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
    use_flash: bool = False,
    layout: str = "bhnd",
    fp32_softmax: bool = True,
) -> torch.Tensor:
    """Dispatch between the plain path and the K1 kernel.

    ``layout``: "bhnd" (head-major) or "bnhd" (token-major, straight out of
    a qkv projection). The kernel reads token-major operands by strides, so
    head-major ones reach it as transposed views.
    """
    if use_flash:
        if layout == "bnhd":
            return flash_attention(q, k, v, scale=scale)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        return flash_attention(qt, kt, vt, scale=scale).transpose(1, 2)
    if layout == "bnhd":
        return sdpa_bnhd(q, k, v, scale=scale, fp32_softmax=fp32_softmax)
    return sdpa_reference(q, k, v, scale=scale, fp32_softmax=fp32_softmax)
