"""K1 forward: fused softmax attention as one hand-written CUDA kernel.

Port of linnaeus_tpu/ops/flash_attention.py (``_flash_fwd_kernel`` via
``_flash_forward_padded`` and ``_flash_fwd_rule``). The kernel is
``csrc/flash_attention_fwd.cu``; it reads token-major (B, N, H, D) operands
through their strides, so the q/k/v views out of a qkv projection need no
transpose, and never writes the (N, N) scores to device memory.

``flash_attention_fwd`` launches the kernel for CUDA tensors and runs
:func:`flash_attention_reference`, the plain PyTorch version of the same
math, for CPU tensors. There is no backward yet: asking for gradients
through the CUDA path raises.
"""

from __future__ import annotations

import torch

from linnaeus_tpu_torch import _kernels

HEAD_DIM = 64  # the only head dim compiled into the kernel

# kernel launches in this process; the serving path's proof of use
LAUNCHES = 0


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel on (B, N, H, D) operands.

    Follows the TPU kernel with its whole padded row in one block (its
    auto block size for N <= 1024): float32 scores times ``scale``, the row
    max m, p = exp(s - m) cast to v's dtype for the product with V, the
    denominator l summed from p in float32 and clamped at 1e-30. Returns
    (O in q's dtype, lse = m + log l of shape (B, H, N) in float32).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf = (t.transpose(1, 2).float() for t in (q, k, v))  # (B, H, N, D)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), vf) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return o.transpose(1, 2).to(q.dtype), lse


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention on token-major (B, N, H, D) operands -> (O, lse).

    O is a new contiguous (B, N, H, D) tensor in the inputs' dtype; lse is
    (B, H, N) float32 (kept for the backward pass). CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    _check_operands(q, k, v)
    B, N, H, D = q.shape
    o = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    lib = _kernels.library()
    err = lib.lt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, N, H, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(scale), _kernels.DTYPE_CODES[q.dtype],
        _kernels.stream_handle(q.device),
    )
    _kernels.check(err, "flash_attention_fwd")
    global LAUNCHES
    LAUNCHES += 1
    return o, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention output only, (B, N, H, D); see :func:`flash_attention_fwd`."""
    return flash_attention_fwd(q, k, v, scale)[0]


def _check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype or t.dtype not in _kernels.DTYPE_CODES:
            raise TypeError(
                f"flash_attention: {name} is {t.dtype}; q, k and v must share "
                "float32 or bfloat16"
            )
        if t.dim() != 4 or t.shape != q.shape:
            raise ValueError(
                f"flash_attention: {name} has shape {tuple(t.shape)}; expected "
                f"(B, N, H, D) equal to q's {tuple(q.shape)}"
            )
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be unit-stride")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "flash_attention: the CUDA backward kernel is not ported yet"
            )
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(
            f"flash_attention: head dim {q.shape[-1]} is not the compiled {HEAD_DIM}"
        )
    if q.shape[1] < 1:
        raise ValueError("flash_attention: empty sequence")
