"""Misc blocks: DiffTransformerBlock and ProgressivePatchEmbed.

Port of linnaeus_tpu/models/blocks/misc.py (reference:
models/blocks/diff_transformer.py:19 and
models/blocks/progressive_patch_embed.py:21). LayerNorms keep Flax's default
eps of 1e-6 and GELU its default tanh approximation, as the JAX modules do.
"""

from __future__ import annotations

import torch
from torch import nn

from linnaeus_tpu_torch.models.attention.zoo import DifferentialAttention

from .common import Conv2d, DropPath, LayerNorm, Mlp, conv_nhwc, drop_path_add, gelu


class DiffTransformerBlock(nn.Module):
    """Pre-LN transformer block over DifferentialAttention."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, drop: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = DifferentialAttention(dim, num_heads=num_heads)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop=drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = drop_path_add(x, self.attn(self.norm1(x)), self.drop_path)
        return drop_path_add(x, self.mlp(self.norm2(x)), self.drop_path)


class ProgressivePatchEmbed(nn.Module):
    """A stack of ``num_stages`` stride-2 3x3 convolutions, each followed by
    a LayerNorm (and a GELU but the last), reaching a stride of
    2**num_stages gradually: (B, H, W, C) -> (B, H'W', embed_dim), H', W'."""

    def __init__(self, in_chans: int, embed_dim: int, num_stages: int = 2):
        super().__init__()
        dims = [max(embed_dim // (2 ** (num_stages - 1 - i)), 8) for i in range(num_stages)]
        dims[-1] = embed_dim
        self.num_stages = num_stages
        for i, d in enumerate(dims):
            setattr(self, f"conv{i}", Conv2d(in_chans if i == 0 else dims[i - 1], d, 3,
                                             stride=2, padding=1))
            setattr(self, f"norm{i}", LayerNorm(d, eps=1e-6))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, int, int]:
        for i in range(self.num_stages):
            x = getattr(self, f"norm{i}")(conv_nhwc(getattr(self, f"conv{i}"), x))
            if i < self.num_stages - 1:
                x = gelu(x, exact=False)
        B, H, W, C = x.shape
        return x.reshape(B, H * W, C), H, W
