"""2D-RoPE multi-head self-attention block.

Port of linnaeus_tpu/models/blocks/rope_mhsa.py. Image-grid tokens get 2D
rotary embeddings (learnable mixed or fixed axial frequencies); the leading
extra tokens (CLS and metadata) pass through unrotated; the block is pre-LN
attention plus a pre-LN MLP, each with a drop-path residual. q, k and v
stay token-major (B, N, H, D) views of the qkv projection, which is the
layout the K1 kernel reads.
"""

from __future__ import annotations

import torch
from torch import nn

from linnaeus_tpu_torch.ops import rope
from linnaeus_tpu_torch.ops.attention import scaled_dot_product_attention

from .common import Dropout, DropPath, LayerNorm, Linear, Mlp

ROPE_FIDELITIES = ("rotate", "reference_cos")


class RoPE2DAttention(nn.Module):
    """``rope_fidelity``: 'rotate' is true 2D RoPE; 'reference_cos' zeroes
    sin, reproducing the upstream implementation's complex-to-real cast
    (checkpoints trained with it). ``use_flash_attn`` sends the attention
    through K1; ``attn_fp32_softmax`` False lets the plain path compute its
    scores in the compute dtype (ops/attention.py). The qkv projection has a bias and the scale is
    head_dim**-0.5, as in every mFormerV1. ``attn_drop`` acts, as in the TPU
    package, on the attention output (the probabilities are never formed on
    the kernel route) and not at all on the K1 route; ``proj_drop`` follows
    the output projection."""

    def __init__(self, dim: int, img_grid_size: tuple[int, int],
                 extra_token_num: int = 1, num_heads: int = 8,
                 rope_theta: float = 10000.0, rope_mixed: bool = True,
                 rope_fidelity: str = "rotate", use_flash_attn: bool = False,
                 attn_fp32_softmax: bool = True, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, generator: torch.Generator | None = None):
        super().__init__()
        if rope_fidelity not in ROPE_FIDELITIES:
            raise ValueError(f"rope_fidelity {rope_fidelity!r} not in {ROPE_FIDELITIES}")
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.grid = tuple(img_grid_size)
        self.extra_token_num = extra_token_num
        self.scale = self.head_dim**-0.5
        self.rope_fidelity = rope_fidelity
        self.use_flash_attn = use_flash_attn
        self.attn_fp32_softmax = attn_fp32_softmax
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.attn_drop = Dropout(0.0 if use_flash_attn else attn_drop)
        self.proj_drop = Dropout(proj_drop)
        H_grid, W_grid = self.grid
        if rope_mixed:
            self.freqs = nn.Parameter(rope.init_random_2d_freqs(
                self.head_dim, num_heads, rope_theta, generator=generator))
            t_x, t_y = rope.init_t_xy(W_grid, H_grid)
            self.register_buffer("t_x", torch.from_numpy(t_x), persistent=False)
            self.register_buffer("t_y", torch.from_numpy(t_y), persistent=False)
        else:
            self.freqs = None
            angles = rope.compute_axial_angles(
                self.head_dim, num_heads, self.grid, rope_theta)
            self.register_buffer("axial_angles", torch.from_numpy(angles), persistent=False)

    def _cos_sin(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self.freqs is not None:
            angles = rope.compute_mixed_angles(self.freqs, self.t_x, self.t_y)
        else:
            angles = self.axial_angles
        cos, sin = torch.cos(angles), torch.sin(angles)
        if self.rope_fidelity == "reference_cos":
            sin = torch.zeros_like(sin)
        return cos, sin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        n_img = self.grid[0] * self.grid[1]
        if N != n_img + self.extra_token_num:
            raise ValueError(f"seq len {N} != {n_img} + {self.extra_token_num}")
        q, k, v = self.qkv(x).view(B, N, 3, self.num_heads, self.head_dim).unbind(2)
        cos, sin = self._cos_sin()
        q, k = rope.apply_rotary_emb_bnhd(q, k, cos, sin, n_extra=self.extra_token_num)
        out = scaled_dot_product_attention(
            q, k, v, scale=self.scale, use_flash=self.use_flash_attn, layout="bnhd",
            fp32_softmax=self.attn_fp32_softmax,
        )
        out = self.attn_drop(out)
        return self.proj_drop(self.proj(out.reshape(B, N, C)))


class RoPE2DMHSABlock(nn.Module):
    """Pre-LN transformer block with 2D-RoPE attention (LN eps 1e-5)."""

    def __init__(self, dim: int, img_grid_size: tuple[int, int],
                 extra_token_num: int = 1, num_heads: int = 8,
                 mlp_ratio: float = 4.0, rope_theta: float = 10000.0,
                 rope_mixed: bool = True, drop_path: float = 0.0,
                 use_flash_attn: bool = False, rope_fidelity: str = "rotate",
                 act_exact: bool = False, attn_fp32_softmax: bool = True,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = RoPE2DAttention(
            dim, img_grid_size, extra_token_num=extra_token_num,
            num_heads=num_heads, rope_theta=rope_theta, rope_mixed=rope_mixed,
            rope_fidelity=rope_fidelity, use_flash_attn=use_flash_attn,
            attn_fp32_softmax=attn_fp32_softmax, attn_drop=attn_drop, proj_drop=drop,
            generator=generator,
        )
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, act_exact=act_exact, drop=drop)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x)))
        return x + self.drop_path(self.mlp(self.norm2(x)))
