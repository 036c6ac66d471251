"""Stochastic depth inside the residual add: ``residual + s[b] * branch``
with s[b] = (u[b] < keep) / keep, forward and backward as hand-written CUDA
kernels (``csrc/drop_path_add.cu``).

In training, a DropPath's per-sample scale (:class:`SampleScale`) is applied
inside the pass that writes the residual sum, in place of the eager passes
of ``DropPath.forward`` (a division, a zero tensor, a ``where`` over a
broadcast mask, then the add; backward a ``where`` and a division). K2
takes the scale as an operand of its own residual add (ops/fused_mlp.py);
:func:`scale_add` serves every other residual site (models/blocks/common.py
``drop_path_add``). Both use the uniforms that ``DropPath.forward`` would
draw, from the same generator, in the same order and number, and keep the
same samples.

Replaces no TPU kernel: the TPU package leaves drop path to XLA, which
fuses it into the add. Bound by bytes: for an activation of T bytes the
forward moves 3T (residual and branch read, the sum written) and the
backward 2T (dout read, the branch's gradient written); a dropped sample's
branch and dout are not read. The sum is one float32 FMA, rounded once to
the activations' dtype. :func:`scale_add` is differentiable: the residual's
gradient is dout itself, with no copy, the branch's ``s[b] * dout``. CUDA
tensors launch the kernels or raise; CPU tensors run
:func:`scale_add_reference` and :func:`scale_samples_reference`, the plain
versions.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from linnaeus_tpu_torch import _kernels

MAX_SAMPLES = 65535  # the kernels' grid gives each sample a row of blocks

# kernel launches in this process (forward, backward): the proof that a path
# went through the kernels
LAUNCHES = 0
BWD_LAUNCHES = 0


class SampleScale(NamedTuple):
    """Stochastic depth's per-sample scale s[b] = (u[b] < keep) / keep:
    ``u`` the (B,) float32 uniforms that a DropPath drew, ``keep`` one less
    its rate. The kernels and the plain versions multiply by 1 / keep
    rounded to float32."""

    u: torch.Tensor
    keep: float

    @property
    def inverse(self) -> float:
        return 1.0 / self.keep

    def values(self) -> torch.Tensor:
        """s as a (B,) float32 tensor: 1 / keep for a kept sample, 0 for a
        dropped one."""
        return (self.u < self.keep).to(torch.float32) * self.inverse


def _by_sample(t: torch.Tensor, scale: SampleScale) -> torch.Tensor:
    """``t`` as (B, elements of a sample), its leading rows a sample's."""
    return t.reshape(scale.u.shape[0], -1)


def scale_add_reference(residual: torch.Tensor, branch: torch.Tensor,
                        scale: SampleScale) -> torch.Tensor:
    """Plain version: residual + s[b] * branch in float32, rounded once to
    the residual's dtype; a dropped sample's elements are its residual's.
    The leading elements of both, a B-th of them a sample, may be rows of
    any shape (K2 hands (M, C) rows, the branch unrounded float32)."""
    r = _by_sample(residual, scale).float()
    s = scale.values()[:, None]
    out = torch.where(s != 0, r + _by_sample(branch, scale).float() * s, r)
    return out.to(residual.dtype).reshape(residual.shape)


def scale_samples_reference(t: torch.Tensor, scale: SampleScale) -> torch.Tensor:
    """Plain version of the backward: s[b] * t in float32, rounded once to
    t's dtype; a dropped sample's elements are zeros."""
    s = scale.values()[:, None]
    out = torch.where(s != 0, _by_sample(t, scale).float() * s, 0.0)
    return out.to(t.dtype).reshape(t.shape)


class _ScaleAdd(torch.autograd.Function):
    """(residual, branch, u, keep) -> residual + s[b] * branch, over operands
    that :func:`scale_add` has checked."""

    @staticmethod
    def forward(ctx, residual, branch, u, keep):
        scale = SampleScale(u, keep)
        ctx.save_for_backward(u)
        ctx.keep = keep
        if residual.is_cuda:
            return _launch(residual, branch, scale)
        return scale_add_reference(residual, branch, scale)

    @staticmethod
    def backward(ctx, dout):
        (u,) = ctx.saved_tensors
        d_branch = None
        if ctx.needs_input_grad[1]:
            scale = SampleScale(u, ctx.keep)
            if dout.is_cuda:
                d_branch = _launch_bwd(_contiguous(dout), scale)
            else:
                d_branch = scale_samples_reference(dout, scale)
        return dout, d_branch, None, None


def scale_add(residual: torch.Tensor, branch: torch.Tensor, scale: SampleScale) -> torch.Tensor:
    """``residual + s[b] * branch`` over tensors of one shape, dtype and
    device whose leading dimension is the batch. Differentiable in both
    tensors. The operands are checked here once; the launches trust them."""
    _check(residual, branch, scale)
    return _ScaleAdd.apply(_contiguous(residual), _contiguous(branch), scale.u, scale.keep)


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_contiguous() else t.contiguous()


def _check(residual: torch.Tensor, branch: torch.Tensor, scale: SampleScale) -> None:
    if (residual.shape != branch.shape or residual.dtype != branch.dtype
            or residual.device != branch.device):
        raise ValueError(
            f"scale_add: residual {tuple(residual.shape)} {residual.dtype} on "
            f"{residual.device} and branch {tuple(branch.shape)} {branch.dtype} on "
            f"{branch.device} differ")
    B = residual.shape[0] if residual.dim() else 0
    u = scale.u
    if (u.dtype != torch.float32 or tuple(u.shape) != (B,) or not u.is_contiguous()
            or u.device != residual.device):
        raise ValueError(
            f"scale_add: the draws are {tuple(u.shape)} {u.dtype} on {u.device}; expected "
            f"({B},) float32 on {residual.device}, contiguous")
    if residual.is_cuda:
        if residual.dtype not in _kernels.DTYPE_CODES:
            raise TypeError(
                f"scale_add: the tensors are {residual.dtype}; expected float32 or bfloat16")
        if not 1 <= B <= MAX_SAMPLES:
            raise ValueError(f"scale_add: a batch of {B} samples is outside 1..{MAX_SAMPLES}")


@functools.cache
def _entries() -> tuple:
    """The library's (forward, backward) entry points, bound once."""
    lib = _kernels.library()
    return lib.lt_drop_path_add_fwd, lib.lt_drop_path_add_bwd


def _scalars(t: torch.Tensor, scale: SampleScale) -> tuple:
    B = t.shape[0]
    return (scale.u.data_ptr(), float(scale.keep), scale.inverse, B, t.numel() // B,
            _kernels.DTYPE_CODES[t.dtype], _kernels.stream_handle(t.device))


def _launch(residual: torch.Tensor, branch: torch.Tensor, scale: SampleScale) -> torch.Tensor:
    """The forward kernel over contiguous CUDA operands that :func:`_check`
    has passed."""
    out = torch.empty_like(residual)
    err = _entries()[0](residual.data_ptr(), branch.data_ptr(), out.data_ptr(),
                        *_scalars(residual, scale))
    _kernels.check(err, "scale_add")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _launch_bwd(dout: torch.Tensor, scale: SampleScale) -> torch.Tensor:
    """The backward kernel: s[b] * dout, over the forward's checked shape."""
    d_branch = torch.empty_like(dout)
    err = _entries()[1](dout.data_ptr(), d_branch.data_ptr(), *_scalars(dout, scale))
    _kernels.check(err, "scale_add backward")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return d_branch
