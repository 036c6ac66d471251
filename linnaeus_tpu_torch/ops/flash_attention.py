"""K1: fused softmax attention, forward and backward as hand-written CUDA
kernels.

Port of linnaeus_tpu/ops/flash_attention.py: ``_flash_fwd_kernel`` (via
``_flash_forward_padded`` and ``_flash_fwd_rule``) and the fused backward
``_flash_bwd_fused_kernel`` with the host part of ``_flash_bwd_rule``. The
kernels are ``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``;
they read token-major (B, N, H, D) operands through their strides, so the
q/k/v views out of a qkv projection need no transpose, and never write the
(N, N) scores to device memory.

``flash_attention_fwd`` and ``flash_attention`` are differentiable: a
``torch.autograd.Function`` saves q, k, v, O and the log-sum-exp, and its
backward produces dq, dk and dv from one recomputed P. CUDA tensors launch
the kernels or raise; CPU tensors run :func:`flash_attention_reference` and
:func:`flash_attention_bwd_reference`, the plain PyTorch versions of the
same math.
"""

from __future__ import annotations

import ctypes

import torch

from linnaeus_tpu_torch import _kernels

HEAD_DIM = 64  # the only head dim compiled into the kernels

# kernel launches in this process (forward, backward): the proof that a path
# went through the kernels
LAUNCHES = 0
BWD_LAUNCHES = 0


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel on (B, N, H, D) operands.

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


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel on (B, N, H, D) operands.

    Follows the TPU package's fused backward cast for cast: delta =
    rowsum(dO * O) in float32, P = exp(S * scale - lse) from the forward's
    lse, P cast to dO's dtype before dV = P^T dO, dP = dO V^T, dS =
    P * (dP - delta) cast to k's dtype before dQ = dS K * scale and
    dK = dS^T Q * scale, products accumulated in float32. Returns
    (dq, dk, dv) as (B, N, H, D) in the operands' dtypes.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, of, dof = (t.transpose(1, 2).float() for t in (q, k, v, o, do))
    delta = (dof * of).sum(dim=-1, keepdim=True)
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse.unsqueeze(-1))
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    ds = (p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)).to(k.dtype).float()
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return (
        dq.transpose(1, 2).to(q.dtype),
        dk.transpose(1, 2).to(k.dtype),
        dv.transpose(1, 2).to(v.dtype),
    )


class _FlashAttention(torch.autograd.Function):
    """(q, k, v, scale) -> (O, lse); lse carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.device.type == "cpu":
            o, lse = flash_attention_reference(q, k, v, scale)
        else:
            o, lse = _launch_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_reference(q, k, v, o, lse, do, ctx.scale)
        else:
            dq, dk, dv = _launch_bwd(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention on token-major (B, N, H, D) operands -> (O, lse).

    O is a new contiguous (B, N, H, D) tensor in the inputs' dtype; lse is
    (B, H, N) float32 (saved for the backward pass; it carries no
    gradient). Differentiable in q, k and v. CPU tensors take the plain
    versions; CUDA tensors launch the kernels or raise.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, float(scale))


def _launch_fwd(q, k, v, scale):
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


def _launch_bwd(q, k, v, o, lse, do, scale):
    """dq, dk, dv from the backward kernel, as the three slices of one
    (B, N, 3, H, D) buffer: the layout of the qkv projection they flow
    back into."""
    B, N, H, D = q.shape
    if do.dtype != q.dtype or do.shape != q.shape or do.device != q.device:
        raise ValueError(
            f"flash_attention backward: dO is {tuple(do.shape)} {do.dtype} on {do.device}; "
            f"expected {tuple(q.shape)} {q.dtype} on {q.device}"
        )
    if do.stride(-1) != 1:
        do = do.contiguous()
    grads = torch.empty((B, N, 3, H, D), dtype=q.dtype, device=q.device)
    dq, dk, dv = grads.unbind(2)
    delta = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    dq_acc = torch.empty((B, N, H, D), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v, do, dq, dk, dv) for s in t.stride()[:3]]
    lib = _kernels.library()
    err = lib.lt_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, N, H, D, (ctypes.c_longlong * len(strides))(*strides),
        float(scale), _kernels.DTYPE_CODES[q.dtype],
        _kernels.stream_handle(q.device),
    )
    _kernels.check(err, "flash_attention_bwd")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return dq, dk, dv


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
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(
            f"flash_attention: head dim {q.shape[-1]} is not the compiled {HEAD_DIM}"
        )
    if q.shape[1] < 1:
        raise ValueError("flash_attention: empty sequence")
