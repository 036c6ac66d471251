"""K1: fused softmax attention, forward and backward as hand-written CUDA
kernels.

Port of linnaeus_tpu/ops/flash_attention.py: ``_flash_fwd_kernel`` (via
``_flash_forward_padded`` and ``_flash_fwd_rule``), the backward kernels
``_flash_bwd_fused_kernel``, ``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel``, with the host part of ``_flash_bwd_rule``. The
kernels are ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd_split.cu``; they read token-major (B, N, H, D)
operands through their strides, so the q/k/v views out of a qkv projection
need no transpose, and never write the (N, N) scores to device memory. Attention at the model's shapes is bound by
arithmetic on the H100 (4 N^2 D operations forward and 10 to 14 N^2 D
backward for a few N D elements moved), and the card's arithmetic is in its
tensor cores: in bfloat16 every kernel of K1 (the forward, the backward's
dQ and dK/dV kernels) runs its matrix products there (``wgmma``
from shared-memory tiles filled by 16-byte asynchronous copies, so pointers
and strides must be 16-byte aligned: :func:`misalignment`), with P and dS
cast in registers as the next product's operand. In float32, where no
tensor-core product keeps the 2e-5 bar, all of K1 runs on the CUDA cores.

``flash_attention_fwd`` and ``flash_attention`` are differentiable: a
``torch.autograd.Function`` saves q, k, v, O and the log-sum-exp, and its
backward produces dq, dk and dv at every length from one pair of kernels:
a dQ kernel that owns query tiles and a dK/dV kernel that owns key tiles,
each recomputing P. The pair stands in for the TPU package's one-pass
kernel as well as for its split pair (csrc/flash_attention_bwd_split.cu
says why: a one-pass kernel's dQ needs atomics, which do not repeat, or a
workspace, which is slower), so the backward gives the same bits from run
to run. CUDA tensors launch the kernels or raise; CPU tensors run the plain
PyTorch versions of the same math: :func:`flash_attention_reference`,
:func:`attention_delta`, :func:`flash_attention_bwd_dq_reference` and
:func:`flash_attention_bwd_dkv_reference`. :func:`flash_attention_bwd_reference`
is the plain version of the TPU package's one-pass kernel; it agrees with
the pair to float32 rounding where q, k, v and dO share a dtype.
"""

from __future__ import annotations

import ctypes

import torch

from linnaeus_tpu_torch import _kernels

HEAD_DIM = 64  # the only head dim compiled into the kernels

# kernel launches in this process (forward; backward calls, each one launch
# of the dQ kernel and one of the dK/dV kernel): the proof that a path went
# through the kernels
LAUNCHES = 0
BWD_LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0


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


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in float32, (B, H, N): the plain version of the
    split backward's prologue kernel."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _p_and_ds(q, k, v, do, lse, delta, scale):
    """Float32 P = exp(S * scale - lse) and dS = P * (dP - delta), unrounded,
    (B, H, N, N), with the head-major float32 q, k and dO they came from."""
    qf, kf, vf, dof = (t.transpose(1, 2).float() for t in (q, k, v, do))
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse.unsqueeze(-1))
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta.unsqueeze(-1))
    return p, ds, qf, kf, dof


def flash_attention_bwd_dq_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain version of the split backward's dQ kernel on (B, N, H, D)
    operands, cast for cast as the TPU package's ``_flash_bwd_dq_kernel``:
    only dS is cast (to k's dtype) before dQ = dS K * scale, accumulated in
    float32. ``lse`` and ``delta`` are (B, H, N) float32. Returns dq in q's
    dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    _, ds, _, kf, _ = _p_and_ds(q, k, v, do, lse, delta, scale)
    dq = torch.matmul(ds.to(k.dtype).float(), kf) * scale
    return dq.transpose(1, 2).to(q.dtype)


def flash_attention_bwd_dkv_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the split backward's dK/dV kernel, cast for cast as
    the TPU package's ``_flash_bwd_dkv_kernel``: P cast to dO's dtype before
    dV = P^T dO, dS cast to q's dtype before dK = dS^T Q * scale, both
    accumulated in float32. Returns (dk, dv) in k's and v's dtypes."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    p, ds, qf, _, dof = _p_and_ds(q, k, v, do, lse, delta, scale)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qf) * scale
    return dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


def plain_attention_bwd(q, k, v, o, lse, do, scale):
    """dq, dk, dv from the plain versions of the backward's kernels: the
    delta prologue, the dQ kernel and the dK/dV kernel."""
    delta = attention_delta(o, do)
    dq = flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, scale)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale)
    return dq, dk, dv


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
        run = plain_attention_bwd if q.device.type == "cpu" else _launch_bwd
        dq, dk, dv = run(q, k, v, o, lse, do, ctx.scale)
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


def _check_dout(q, do):
    """dO as the backward kernels take it: q's shape, dtype and device, the
    head dim unit-stride and, in bfloat16, 16-byte aligned (a contiguous
    copy is made where it is not)."""
    if do.dtype != q.dtype or do.shape != q.shape or do.device != q.device:
        raise ValueError(
            f"flash_attention backward: dO is {tuple(do.shape)} {do.dtype} on {do.device}; "
            f"expected {tuple(q.shape)} {q.dtype} on {q.device}"
        )
    if do.stride(-1) == 1 and misalignment(do) is None:
        return do
    # not .contiguous(): a dense tensor that starts off a 16-byte line is its own
    return do.clone(memory_format=torch.contiguous_format)


def _strides(*tensors):
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _grad_buffer(q):
    """dq, dk, dv as the three slices of one (B, N, 3, H, D) buffer: the
    layout of the qkv projection they flow back into."""
    B, N, H, D = q.shape
    return torch.empty((B, N, 3, H, D), dtype=q.dtype, device=q.device).unbind(2)


def _launch_delta(o, do):
    """delta (B, H, N) float32 from the backward's prologue kernel."""
    B, N, H, D = o.shape
    delta = torch.empty((B, H, N), dtype=torch.float32, device=o.device)
    err = _kernels.library().lt_flash_attention_bwd_delta(
        o.data_ptr(), do.data_ptr(), delta.data_ptr(), B, N, H, D, _strides(do),
        _kernels.DTYPE_CODES[o.dtype], _kernels.stream_handle(o.device),
    )
    _kernels.check(err, "flash_attention_bwd_delta")
    return delta


def _launch_bwd_dq(q, k, v, do, lse, delta, scale, out=None):
    """dq from the backward's dQ kernel, written into ``out`` (any
    (B, N, H, D) view with a unit-stride head dim) or a new tensor."""
    B, N, H, D = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format) if out is None else out
    _check_aligned(q=q, k=k, v=v, dO=do, dq=dq)
    err = _kernels.library().lt_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), B, N, H, D, _strides(q, k, v, do, dq),
        float(scale), _kernels.DTYPE_CODES[q.dtype], _kernels.stream_handle(q.device),
    )
    _kernels.check(err, "flash_attention_bwd_dq")
    global DQ_LAUNCHES
    DQ_LAUNCHES += 1
    return dq


def _launch_bwd_dkv(q, k, v, do, lse, delta, scale, out=None):
    """(dk, dv) from the backward's dK/dV kernel, written into the pair
    ``out`` or new tensors."""
    B, N, H, D = q.shape
    if out is None:
        out = tuple(torch.empty_like(t, memory_format=torch.contiguous_format) for t in (k, v))
    dk, dv = out
    _check_aligned(q=q, k=k, v=v, dO=do, dk=dk, dv=dv)
    err = _kernels.library().lt_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, N, H, D,
        _strides(q, k, v, do, dk, dv),
        float(scale), _kernels.DTYPE_CODES[q.dtype], _kernels.stream_handle(q.device),
    )
    _kernels.check(err, "flash_attention_bwd_dkv")
    global DKV_LAUNCHES
    DKV_LAUNCHES += 1
    return dk, dv


def _launch_bwd(q, k, v, o, lse, do, scale):
    """dq, dk, dv from the backward: the delta prologue, the dQ kernel and
    the dK/dV kernel, three launches and no workspace."""
    do = _check_dout(q, do)
    dq, dk, dv = _grad_buffer(q)
    delta = _launch_delta(o, do)
    _launch_bwd_dq(q, k, v, do, lse, delta, scale, out=dq)
    _launch_bwd_dkv(q, k, v, do, lse, delta, scale, out=(dk, dv))
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


ALIGN_BYTES = 16  # one asynchronous copy of the tensor-core kernels


def misalignment(t: torch.Tensor) -> str | None:
    """What keeps the bfloat16 kernels from reading or writing the
    (B, N, H, D) tensor ``t`` in 16-byte pieces, or None: its first element
    and its batch, token and head strides must all lie on 16-byte
    boundaries. float32 tensors go to kernels that have no such need. Reads
    only the dtype, the strides and the address, so it serves CPU tensors too.
    """
    if t.dtype != torch.bfloat16:
        return None
    size = t.element_size()
    if t.data_ptr() % ALIGN_BYTES:
        return f"first element at byte {t.data_ptr() % ALIGN_BYTES} of a {ALIGN_BYTES}-byte line"
    for name, stride in zip(("batch", "token", "head"), t.stride()[:3]):
        if (stride * size) % ALIGN_BYTES:
            return f"{name} stride of {stride} elements is not a multiple of {ALIGN_BYTES} bytes"
    return None


def _check_aligned(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        fault = misalignment(t)
        if fault is not None:
            raise ValueError(f"flash_attention: {name} is misaligned for the bfloat16 kernels: {fault}")


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
    _check_aligned(q=q, k=k, v=v)
