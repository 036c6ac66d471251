"""K2: the fused ConvNeXt MLP tail, forward and backward as hand-written CUDA
kernels.

Port of linnaeus_tpu/ops/fused_mlp.py: the forward ``_body`` (via
``_pallas_fused``), LN -> Linear(4C) -> GELU (tanh or erf) -> Linear(C) ->
x gamma [-> + residual], and the backward ``_bwd_kernel`` (via
``_pallas_bwd``), which recomputes the forward in the tile. Both are tiled
over rows so the (M, 4C) intermediates never reach device memory. The
kernels are ``csrc/fused_mlp_fwd.cu``, ``csrc/fused_mlp_fwd_wgmma.cu``,
``csrc/fused_mlp_bwd.cu`` and ``csrc/fused_mlp_bwd_wgmma.cu``.

Both directions are bound by arithmetic on the H100 (16 M C^2 operations
forward and 48 M C^2 backward for a few M C elements moved), and both run on
the tensor cores where they can: in bfloat16 with C a multiple of 32 every
product is a ``wgmma`` from swizzled shared-memory tiles filled by
asynchronous copies. The forward is one persistent kernel (LN by the block,
the weight chunks through a ring, GELU in registers between the two
products); the backward is a prologue that writes LN(y) and dout * gamma
once as bfloat16 (M, C) into the workspace, then a pass over row tiles
(dh0, dy and the vector sums) and a pass over hidden chunks (dW1, db1 and
G = dout^T h1, from which dW2 and dgamma follow), both warp-specialised
behind rings of TMA loads, five products of M C 4C a tile and chunk where
the forward recomputed in the tile has six. float32 (no tensor-core product
keeps its 1e-5 and 2e-5 bars) and the other widths run float32 FMAs on the
CUDA cores. :func:`forward_kernel` and :func:`backward_kernel` hold those
rules, and :func:`kernel_takes` says which widths the kernels take at all;
every route sums in a fixed order, so outputs and gradients are the same
from run to run.

Weights use the torch Linear layout of the block's ``pwconv1`` (4C, C) and
``pwconv2`` (C, 4C). ``fused_convnext_mlp`` is differentiable: a
``torch.autograd.Function`` saves y and the parameters, and its backward
returns dy, the residual's gradient (dout itself) and the seven parameter
gradients. CUDA tensors launch the kernels or raise; CPU tensors run
:func:`fused_convnext_mlp_reference` and
:func:`fused_convnext_mlp_bwd_reference`, the plain PyTorch versions.

In training under drop path the block hands its per-sample ``scale``
(ops/drop_path.py): every route then computes residual + s[b] (branch) in
the same epilogue, rounded once, and a backward that starts from
ds = round(s[b] dout), which the tensor-core route's prologue writes beside
its other workspace rows; the residual's gradient stays dout.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from linnaeus_tpu_torch import _kernels
from linnaeus_tpu_torch.ops.drop_path import (
    MAX_SAMPLES,
    SampleScale,
    scale_add_reference,
    scale_samples_reference,
)

MAX_WIDTH = 256  # widest C of both forward kernels (the column split; the tiles)
MAX_WIDTH_BWD = 192  # widest C whose backward tiles fit an SM's shared memory

# kernel launches in this process (forward, backward): the proof that a path
# went through the kernels
LAUNCHES = 0
BWD_LAUNCHES = 0


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
    dtype: torch.dtype | None = None,
    scale: SampleScale | None = None,
) -> torch.Tensor:
    """Plain version on (M, C) rows, cast for cast as the TPU package's
    ``_xla_reference``: LN in float32 rounded to y's dtype, both products
    accumulated in float32, GELU in float32 rounded to y's dtype, then bias,
    gamma and the residual in float32 and one cast to y's dtype. The
    vectors are float32. ``dtype`` takes the place of y's dtype where y is
    an unrounded float32 intermediate of a wider fusion (K3). With
    ``scale`` (the residual then required) the sum is residual + s[b]
    (bias and gamma applied), a sample's rows a B-th of M."""
    dt = y2.dtype if dtype is None else dtype
    yf = y2.float()
    mean = yf.mean(dim=-1, keepdim=True)
    var = (yf - mean).square().mean(dim=-1, keepdim=True)
    h0 = ((yf - mean) * torch.rsqrt(var + eps) * ln_w + ln_b).to(dt)
    h1 = torch.matmul(h0.float(), w1.float().t()) + b1
    h1 = F.gelu(h1, approximate="tanh" if approximate else "none").to(dt)
    out = torch.matmul(h1.float(), w2.float().t())
    out = (out + b2) * gamma
    if scale is not None:
        return scale_add_reference(x2, out, scale).to(dt)
    if x2 is not None:
        out = x2.float() + out
    return out.to(dt)


KERNELS = BWD_KERNELS = ("wgmma", "cuda_cores")
WGMMA_WIDTH_STEP = 32  # the tensor-core kernels take C = 32, 64, .. their widest


def _fills_wgmma_tiles(C: int, dtype: torch.dtype, hidden: int | None, widest: int) -> bool:
    """bfloat16 at widths that fill whole 32-column half atoms, up to
    ``widest``, and whole 64-column hidden chunks."""
    hidden = 4 * C if hidden is None else hidden
    return (dtype == torch.bfloat16 and WGMMA_WIDTH_STEP <= C <= widest
            and C % WGMMA_WIDTH_STEP == 0 and hidden >= 64 and hidden % 64 == 0)


def forward_kernel(C: int, dtype: torch.dtype, hidden: int | None = None) -> str:
    """"wgmma" or "cuda_cores": the kernel that the forward launches for
    width ``C``, hidden width ``hidden`` (4C if None) and ``dtype``. The
    tensor-core kernel takes bfloat16 at C = 32, 64, .. MAX_WIDTH with whole
    64-column hidden chunks; everything else keeps the CUDA-core kernel. A
    rule on dtype and shape alone, the same as ``lt::mlp_fwd_takes_wgmma``
    in ``csrc/fused_mlp_body_wgmma.cuh``."""
    return "wgmma" if _fills_wgmma_tiles(C, dtype, hidden, MAX_WIDTH) else "cuda_cores"


def backward_kernel(C: int, dtype: torch.dtype, hidden: int | None = None) -> str:
    """"wgmma" or "cuda_cores": the kernels that the backward launches for
    width ``C``, hidden width ``hidden`` (4C if None) and ``dtype``. The
    tensor-core kernels take bfloat16 at widths that fill whole 32-column
    half atoms and whole 64-column hidden chunks; everything else keeps the
    CUDA-core kernels. A rule on dtype and shape alone, the same as
    ``lt::mlp_bwd_takes_wgmma`` in ``csrc/fused_mlp_bwd.cuh``."""
    return "wgmma" if _fills_wgmma_tiles(C, dtype, hidden, MAX_WIDTH_BWD) else "cuda_cores"


def kernel_takes(C: int, dtype: torch.dtype, needs_grad: bool) -> bool:
    """Whether the kernels take width ``C`` in ``dtype``: float32 or
    bfloat16 up to the forward kernels' MAX_WIDTH and, where a gradient is
    wanted, up to the backward kernels' MAX_WIDTH_BWD. The shape rule by
    which a ConvNeXt block chooses, before any launch, between K2 and its
    plain modules."""
    return dtype in _kernels.DTYPE_CODES and 1 <= C <= (MAX_WIDTH_BWD if needs_grad else MAX_WIDTH)


def _gelu_grad(a: torch.Tensor, approximate: bool) -> torch.Tensor:
    """d gelu(a) / d a, elementwise in float32: the tanh and the erf form."""
    if approximate:
        c = 0.7978845608028654  # sqrt(2 / pi)
        k = 0.044715
        t = torch.tanh(c * (a + k * a * a * a))
        return 0.5 * (1.0 + t) + 0.5 * a * (1.0 - t * t) * c * (1.0 + 3.0 * k * a * a)
    phi = torch.exp(-0.5 * a * a) * 0.3989422804014327  # N(0, 1) density
    return 0.5 * (1.0 + torch.erf(a * 0.7071067811865476)) + a * phi


def fused_convnext_mlp_bwd_reference(
    y2: torch.Tensor,
    dout: torch.Tensor,
    ln_w: torch.Tensor,
    ln_b: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    gamma: torch.Tensor,
    eps: float,
    approximate: bool,
    scale: SampleScale | None = None,
) -> tuple[torch.Tensor, ...]:
    """Plain version of the backward kernel on (M, C) rows, cast for cast as
    the TPU package's ``_bwd_kernel``: the forward recomputed with h0 and h1
    rounded to y's dtype, da2 = dout * gamma and da1 = dh1 * gelu'(a1)
    rounded to y's dtype before the products they enter, every product
    accumulated in float32, the vector gradients summed from the unrounded
    values. Returns (dy in y's dtype, then float32 d ln_w, d ln_b,
    dw1 (4C, C), db1, dw2 (C, 4C), db2, dgamma). The residual's gradient is
    dout itself and is not computed here. With ``scale`` the gradients are
    those of the scaled branch: dout is first ds = s[b] dout, rounded to y's
    dtype, as the kernels round it."""
    dt = y2.dtype
    if scale is not None:
        dout = scale_samples_reference(dout.to(dt), scale)
    yf = y2.float()
    mean = yf.mean(dim=-1, keepdim=True)
    var = (yf - mean).square().mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    n = (yf - mean) * r
    h0b = (n * ln_w + ln_b).to(dt).float()
    w1f, w2f = w1.float(), w2.float()
    a1 = torch.matmul(h0b, w1f.t()) + b1
    h1b = F.gelu(a1, approximate="tanh" if approximate else "none").to(dt).float()
    a2 = torch.matmul(h1b, w2f.t()) + b2

    do = dout.float()
    dg = (do * a2).sum(dim=0)
    da2 = do * gamma
    da2b = da2.to(dt).float()
    db2 = da2.sum(dim=0)
    dw2 = torch.matmul(da2b.t(), h1b)
    da1 = torch.matmul(da2b, w2f) * _gelu_grad(a1, approximate)
    da1b = da1.to(dt).float()
    db1 = da1.sum(dim=0)
    dw1 = torch.matmul(da1b.t(), h0b)
    dh0 = torch.matmul(da1b, w1f)
    dls = (dh0 * n).sum(dim=0)
    dlb = dh0.sum(dim=0)
    dn = dh0 * ln_w
    dy = r * (dn - dn.mean(dim=-1, keepdim=True) - n * (dn * n).mean(dim=-1, keepdim=True))
    return dy.to(dt), dls, dlb, dw1, db1, dw2, db2, dg


class _FusedConvNeXtMlp(torch.autograd.Function):
    """(y2, x2 or None, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, approximate,
    u or None, keep) -> out, on (M, C) rows with float32 vectors; u and keep
    make drop path's per-sample scale."""

    @staticmethod
    def forward(ctx, y2, x2, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, approximate, u, keep):
        scale = None if u is None else SampleScale(u, keep)
        run = fused_convnext_mlp_reference if y2.device.type == "cpu" else _launch
        out = run(y2, x2, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, approximate, scale=scale)
        ctx.save_for_backward(y2, ln_w, ln_b, w1, b1, w2, b2, gamma, u)
        ctx.eps, ctx.approximate, ctx.has_residual = eps, approximate, x2 is not None
        ctx.keep = keep
        return out

    @staticmethod
    def backward(ctx, dout):
        y2, ln_w, ln_b, w1, b1, w2, b2, gamma, u = ctx.saved_tensors
        scale = None if u is None else SampleScale(u, ctx.keep)
        run = fused_convnext_mlp_bwd_reference if y2.device.type == "cpu" else _launch_bwd
        dout = dout.contiguous()
        dy, dls, dlb, dw1, db1, dw2, db2, dg = run(
            y2, dout, ln_w, ln_b, w1, b1, w2, b2, gamma, ctx.eps, ctx.approximate, scale=scale
        )
        dx = dout if ctx.has_residual else None
        return (dy, dx, dls, dlb, dw1.to(w1.dtype), db1, dw2.to(w2.dtype), db2, dg,
                None, None, None, None)


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
    scale: SampleScale | None = None,
) -> torch.Tensor:
    """LN -> Linear(4C) -> GELU -> Linear(C) -> x gamma [-> + residual] over
    ``y`` of shape (..., C); ``residual=None`` skips the add. ``w1`` is
    (4C, C) and ``w2`` (C, 4C) in y's dtype; the vectors are cast to
    float32. ``scale``: drop path's per-sample scale of a training block
    (y's leading dimension the batch), residual + s[b] (branch); it needs
    the residual. Differentiable in every tensor operand; the weight
    gradients are computed in float32 and returned in the weights' dtype.
    CPU tensors take the plain versions; CUDA tensors launch the kernels or
    raise."""
    shape = y.shape
    C = shape[-1]
    y2 = y.reshape(-1, C)
    x2 = None if residual is None else residual.reshape(-1, C)
    if scale is not None and (x2 is None or y2.shape[0] % scale.u.shape[0]):
        raise ValueError("fused_convnext_mlp: a drop-path scale needs the residual and "
                         "whole samples of rows")
    if gamma is None:
        gamma = torch.ones(C, dtype=torch.float32, device=y.device)
    ln_w, ln_b, b1f, b2f, g = (t.float() for t in (ln_scale, ln_bias, b1, b2, gamma))
    u, keep = (None, 1.0) if scale is None else (scale.u, float(scale.keep))
    out = _FusedConvNeXtMlp.apply(
        y2, x2, ln_w, ln_b, w1, b1f, w2, b2f, g, float(eps), bool(approximate_gelu), u, keep
    )
    return out.reshape(shape)


def _scale_operands(scale: SampleScale | None, M: int) -> tuple:
    """(u's pointer or None, keep, 1 / keep, rows a sample) for the C side."""
    if scale is None:
        return None, 1.0, 1.0, 1
    return scale.u.data_ptr(), float(scale.keep), scale.inverse, M // scale.u.shape[0]


def _launch(y2, x2, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, approximate, scale=None):
    M, C = y2.shape
    Hd = w1.shape[0]
    _check_operands(y2, x2, ln_w, ln_b, w1, b1, w2, b2, gamma, scale)
    out = torch.empty_like(y2)
    u, keep, inverse, rows_per_sample = _scale_operands(scale, M)
    lib = _kernels.library()
    err = lib.lt_fused_mlp_fwd(
        y2.data_ptr(), None if x2 is None else x2.data_ptr(),
        ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(), out.data_ptr(), u,
        M, C, Hd, float(eps), int(approximate),
        _kernels.DTYPE_CODES[y2.dtype], keep, inverse, rows_per_sample,
        _kernels.stream_handle(y2.device),
    )
    _kernels.check(err, "fused_convnext_mlp")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _launch_bwd(y2, dout, ln_w, ln_b, w1, b1, w2, b2, gamma, eps, approximate, scale=None):
    M, C = y2.shape
    Hd = w1.shape[0]
    if C > MAX_WIDTH_BWD:
        raise ValueError(
            f"fused_convnext_mlp backward: width C={C} is outside 1..{MAX_WIDTH_BWD}"
        )
    _check_operands(y2, dout, ln_w, ln_b, w1, b1, w2, b2, gamma, scale)
    dev = y2.device
    f32 = {"dtype": torch.float32, "device": dev}
    dy = torch.empty_like(y2)
    dls, dlb, db2, dg = (torch.empty(C, **f32) for _ in range(4))
    dw1, db1, dw2 = torch.empty((Hd, C), **f32), torch.empty(Hd, **f32), torch.empty((C, Hd), **f32)
    row_blocks, slabs, floats = _bwd_geometry(
        M, C, Hd, backward_kernel(C, y2.dtype, Hd),
        torch.cuda.get_device_properties(dev).multi_processor_count)
    u, keep, inverse, rows_per_sample = _scale_operands(scale, M)
    if scale is not None:  # ds = round(s dout), ahead of the rest
        floats += scaled_dout_floats(M, C, y2.dtype)
    workspace = torch.empty(floats, **f32)
    pointers = lambda ts: (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))  # noqa: E731
    lib = _kernels.library()
    err = lib.lt_fused_mlp_bwd(
        pointers((y2, dout, ln_w, ln_b, w1, b1, w2, b2, gamma)),
        pointers((dy, dls, dlb, dw1, db1, dw2, db2, dg)),
        workspace.data_ptr(), M, C, Hd, float(eps), int(approximate),
        row_blocks, slabs, _kernels.DTYPE_CODES[y2.dtype], u, keep, inverse, rows_per_sample,
        _kernels.stream_handle(dev),
    )
    _kernels.check(err, "fused_convnext_mlp_bwd")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return dy, dls, dlb, dw1, db1, dw2, db2, dg


def _bwd_geometry(M: int, C: int, Hd: int, route: str, sms: int) -> tuple[int, int, int]:
    """(row_blocks, slabs, workspace floats) of the backward on ``sms`` SMs.
    Every block fits one to an SM. The row pass is persistent: one block per
    SM, over row tiles of 64 rows a consumer (two consumers a block on the
    tensor cores). In the weight pass the SMs are shared out among the
    64-column hidden chunks, a block of a chunk taking a slab of the row
    tiles. The workspace holds the row blocks' column sums and each slab's
    weight gradients; on the tensor cores also LN(y) and dout * gamma in
    bfloat16 and the rows' mean and rstd."""
    tiles = (M + 63) // 64
    slabs = max(1, min(tiles, sms // ((Hd + 63) // 64)))
    if route == "wgmma":
        row_blocks = min((M + 127) // 128, sms)
        floats = M * C + 2 * M + row_blocks * 3 * C
    else:
        row_blocks = min(tiles, sms)
        floats = row_blocks * 4 * C
    return row_blocks, slabs, floats + slabs * (2 * Hd * C + Hd)


def scaled_dout_floats(M: int, C: int, dtype: torch.dtype) -> int:
    """float32 elements of the backward's workspace that ds takes, whole
    16-byte pieces (``lt::scaled_dout_floats``)."""
    return (M * C * (torch.finfo(dtype).bits // 8) + 15) // 16 * 4


def _check_operands(y2, x2, ln_w, ln_b, w1, b1, w2, b2, gamma, scale=None) -> None:
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
    wide = forward_kernel(C, y2.dtype, Hd) == "wgmma"
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
        # the tensor-core kernels copy and store 16 bytes at a time
        if wide and t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(
                f"fused_convnext_mlp: {name} is misaligned for the bfloat16 kernels: its "
                f"first element lies {t.data_ptr() % 16} bytes past a 16-byte boundary"
            )
    if scale is not None:
        u = scale.u
        B = u.shape[0] if u.dim() == 1 else 0
        if (u.dtype != torch.float32 or not 1 <= B <= MAX_SAMPLES or M % B
                or not u.is_contiguous() or u.device != y2.device):
            raise ValueError(
                f"fused_convnext_mlp: the drop-path draws are {tuple(u.shape)} {u.dtype} on "
                f"{u.device}; expected (B,) float32 on {y2.device}, contiguous, B in "
                f"1..{MAX_SAMPLES} dividing the {M} rows")
