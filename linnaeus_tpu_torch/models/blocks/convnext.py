"""ConvNeXt stem, block and downsample on NHWC activations.

Port of linnaeus_tpu/models/blocks/convnext.py. Activations stay
(B, H, W, C) as in the TPU package, so LayerNorm is a last-axis norm and the
block's MLP tail reads contiguous (B*H*W, C) rows; each convolution sees an
NCHW view of the same memory (channels-last strides) and its output is
viewed back. Block = 7x7 depthwise conv -> LN -> Linear(4C) -> GELU ->
Linear(C) -> layer scale -> drop-path residual; the tail from LN on can run
as the K2 kernel (ops/fused_mlp.py).
"""

from __future__ import annotations

import torch
from torch import nn

from linnaeus_tpu_torch.ops.fused_mlp import fused_convnext_mlp, kernel_takes

from .common import Conv2d, DropPath, LayerNorm, Linear, gelu


def _conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ConvNeXtBlock(nn.Module):
    """``fused_mlp``: True sends the LN -> MLP -> layer-scale tail through
    K2, False through plain modules. None (the default) chooses by shape
    before anything is launched: K2 for a CUDA tensor at a width its kernels
    take (``ops.fused_mlp.kernel_takes``: float32 or bfloat16, ``dim`` up to
    256, and up to 192 where a gradient is wanted, the widest backward whose
    tiles fit an SM's shared memory), plain modules for a CPU tensor and
    past those widths (the lg and xl presets' later stages). True at a
    width the kernels do not take raises a ValueError that names the width.
    The parameters are the same either way. ``forward``'s ``training``
    says whether a gradient is wanted; None reads it from the grad mode and
    the operands. The model passes it, so a recomputed block under
    checkpointing takes the route its first forward took."""

    def __init__(self, dim: int, drop_path: float = 0.0,
                 layer_scale_init_value: float = 1e-6, act_exact: bool = False,
                 fused_mlp: bool | None = None):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, kernel_size=7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = Linear(dim, 4 * dim)
        self.pwconv2 = Linear(4 * dim, dim)
        self.gamma = (
            nn.Parameter(torch.full((dim,), layer_scale_init_value))
            if layer_scale_init_value > 0 else None
        )
        self.drop_path = DropPath(drop_path)
        self.act_exact = act_exact
        self.fused_mlp = fused_mlp

    def forward(self, x: torch.Tensor, training: bool | None = None) -> torch.Tensor:
        residual = x
        y = _conv_nhwc(self.dwconv, x)
        use_fused = self.fused_mlp
        if use_fused is None:
            needs_grad = training if training is not None else torch.is_grad_enabled() and (
                y.requires_grad or any(p.requires_grad for p in self.parameters()))
            use_fused = y.is_cuda and kernel_takes(y.shape[-1], y.dtype, needs_grad)
        if use_fused:
            return self._fused_tail(y, residual)
        y = self.norm(y)
        y = self.pwconv2(gelu(self.pwconv1(y), self.act_exact))
        if self.gamma is not None:
            y = y * self.gamma.to(y.dtype)
        return residual + self.drop_path(y)

    def _fused_tail(self, y: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        dt = y.dtype
        # an active drop-path scales the branch before the residual add, so
        # the kernel then skips its own add
        plain_residual = not self.training or self.drop_path.rate == 0.0
        out = fused_convnext_mlp(
            y, residual if plain_residual else None,
            self.norm.weight, self.norm.bias,
            self.pwconv1.weight.to(dt), self.pwconv1.bias,
            self.pwconv2.weight.to(dt), self.pwconv2.bias,
            self.gamma,
            eps=self.norm.eps, approximate_gelu=not self.act_exact,
        )
        if plain_residual:
            return out
        return residual + self.drop_path(out)


class ConvNeXtDownsampleLayer(nn.Module):
    """LN -> 2x2 stride-2 conv: halves H and W and changes the width."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.norm = LayerNorm(in_dim, eps=1e-6)
        self.conv = Conv2d(in_dim, out_dim, kernel_size=2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_nhwc(self.conv, self.norm(x))


class ConvNeXtStem(nn.Sequential):
    """4x4 stride-4 patchify conv (index 0) + LN (index 1)."""

    def __init__(self, in_chans: int, out_dim: int):
        super().__init__(
            Conv2d(in_chans, out_dim, kernel_size=4, stride=4),
            LayerNorm(out_dim, eps=1e-6),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self[1](_conv_nhwc(self[0], x))
