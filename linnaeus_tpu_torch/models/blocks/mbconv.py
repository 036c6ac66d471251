"""MBConv block (EfficientNet-style inverted residual with squeeze-excite)
on NHWC activations.

Port of linnaeus_tpu/models/blocks/mbconv.py (reference:
models/blocks/mb_conv.py:131-300): 1x1 expansion -> BN -> swish ->
depthwise k x k (stride) -> BN -> swish -> squeeze-excite -> 1x1
projection -> BN -> drop-connect residual when the shapes match. The
BatchNorms are Flax's (``common.BatchNorm``: momentum 0.9 as Flax counts it,
eps 0.01). The block keeps MetaFG's ``state_dict`` names (``_expand_conv``,
``_bn0``, ``_depthwise_conv``, ``_bn1``, ``_se_reduce``, ``_se_expand``,
``_project_conv``, ``_bn2``).

The depthwise convolution pads as Flax's ``"SAME"`` does (:func:`same_padding`):
for a 3x3 kernel at stride 2 on an even grid that is (0, 1), one row and
column after the image and none before, not torch's symmetric (1, 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm, Conv2d, DropPath, drop_path_add


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of Flax/XLA's ``"SAME"`` along one axis: the
    output has ceil(size / stride) positions, and the odd pixel of an odd
    total goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv1x1(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 Conv2d on NHWC activations, as the product over channels that
    it is."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.linear(x, conv.weight[:, :, 0, 0].to(x.dtype), bias)


def squeeze_excite(x: torch.Tensor, reduce: nn.Module, expand: nn.Module) -> torch.Tensor:
    """x * sigmoid(expand(swish(reduce(mean over H, W of x))))."""
    s = x.mean(dim=(1, 2), keepdim=True)
    s = conv1x1(expand, F.silu(conv1x1(reduce, s)))
    return x * torch.sigmoid(s)


class SqueezeExcite(nn.Module):
    """Squeeze-excitation to ``int(squeeze_base * se_ratio)`` channels: the
    reference squeezes to a quarter of the block's **input** width, not of
    the expanded width (mb_conv.py:182, :216). The JAX package's ``se``
    submodule layout (``reduce``, ``expand``); MBConvBlock holds the same two
    convolutions under MetaFG's names."""

    def __init__(self, channels: int, squeeze_base: int | None = None, se_ratio: float = 0.25):
        super().__init__()
        base = channels if squeeze_base is None else squeeze_base
        reduced = max(1, int(base * se_ratio))
        self.reduce = Conv2d(channels, reduced, 1)
        self.expand = Conv2d(reduced, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return squeeze_excite(x, self.reduce, self.expand)


class MBConvBlock(nn.Module):
    """``drop_connect_rate`` is the model's DROP_RATE (the reference's
    drop-connect), drawn per sample from the generator that
    ``create_train_state`` hands every DropPath."""

    def __init__(self, input_filters: int, output_filters: int, ksize: int = 3,
                 expand_ratio: int = 4, stride: int = 1, drop_connect_rate: float = 0.0,
                 se_ratio: float = 0.25):
        super().__init__()
        self.input_filters, self.output_filters = input_filters, output_filters
        self.ksize, self.stride, self.expand_ratio = ksize, stride, expand_ratio
        oup = input_filters * expand_ratio
        if expand_ratio != 1:
            self._expand_conv = Conv2d(input_filters, oup, 1, bias=False)
            self._bn0 = BatchNorm(oup, eps=0.01)
        self._depthwise_conv = Conv2d(oup, oup, ksize, stride=stride, groups=oup, bias=False)
        self._bn1 = BatchNorm(oup, eps=0.01)
        self.has_se = se_ratio > 0
        if self.has_se:
            reduced = max(1, int(input_filters * se_ratio))
            self._se_reduce = Conv2d(oup, reduced, 1)
            self._se_expand = Conv2d(reduced, oup, 1)
        self._project_conv = Conv2d(oup, output_filters, 1, bias=False)
        self._bn2 = BatchNorm(output_filters, eps=0.01)
        self.drop_connect = DropPath(drop_connect_rate)

    def _depthwise(self, x: torch.Tensor) -> torch.Tensor:
        (top, bottom), (left, right) = (same_padding(n, self.ksize, self.stride)
                                        for n in x.shape[1:3])
        x = x.permute(0, 3, 1, 2)
        if (top, left) == (bottom, right):
            y = F.conv2d(x, self._depthwise_conv.weight.to(x.dtype), None, self.stride,
                         (top, left), 1, x.shape[1])
        else:
            y = F.conv2d(F.pad(x, (left, right, top, bottom)),
                         self._depthwise_conv.weight.to(x.dtype), None, self.stride, 0, 1,
                         x.shape[1])
        return y.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs = x
        if self.expand_ratio != 1:
            x = F.silu(self._bn0(conv1x1(self._expand_conv, x)))
        x = F.silu(self._bn1(self._depthwise(x)))
        if self.has_se:
            x = squeeze_excite(x, self._se_reduce, self._se_expand)
        x = self._bn2(conv1x1(self._project_conv, x))
        if self.stride == 1 and self.input_filters == self.output_filters:
            x = drop_path_add(inputs, x, self.drop_connect)
        return x
