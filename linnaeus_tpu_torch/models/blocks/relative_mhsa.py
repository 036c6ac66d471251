"""Relative-position-bias MHSA (mFormerV0's attention) and OverlapPatchEmbed.

Port of linnaeus_tpu/models/blocks/relative_mhsa.py (reference:
models/blocks/relative_mhsa.py:40-453). The bias table has
((2H-1)(2W-1) + 1) rows per head: image-token pairs index it by their
relative offset, and every pair that involves an extra token (CLS, metadata)
shares the last row. The index is a constant of the grid, kept as a
non-persistent buffer (``relative_position_index``), so the ``state_dict``
holds the table alone, as the JAX package's params do.

The attention is plain PyTorch, cast for cast with the JAX einsums: scores in
float32 when ``attn_fp32_softmax`` is set (else in the compute dtype), the
softmax in float32 either way, dropout on the **probabilities** (mFormerV1's
RoPE blocks apply it to the output instead), the probabilities times V
rounded once to the compute dtype. The JAX package runs it outside any
Pallas kernel: relative attention has no flash variant there.
``head_split`` (MODEL.ATTN_HEAD_SPLIT) is the JAX package's weight-level
split of the same parameters into heads; it computes the same function, so
it is accepted and changes nothing here.

OverlapPatchEmbed is a 3x3 stride-2 convolution with an **explicit**
symmetric padding of 1 (unlike the MBConv's "SAME"), then LayerNorm. Module
names follow MetaFG (``patch_embed.proj``, ``patch_embed.norm``,
``attn.qkv``, ``attn.proj``, ``attn.relative_position_bias_table``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .common import Conv2d, Dropout, DropPath, LayerNorm, Linear, Mlp, conv_nhwc, drop_path_add


def build_relative_position_index(h: int, w: int, extra: int) -> np.ndarray:
    """(N, N) int32 index into the bias table, N = extra + h*w."""
    coords = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)  # (2, h*w)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, hw, hw)
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += h - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    idx = rel.sum(-1)  # (hw, hw)
    num_rel = (2 * h - 1) * (2 * w - 1) + 1
    pad_val = num_rel - 1
    n = extra + h * w
    out = np.full((n, n), pad_val, dtype=np.int32)
    out[extra:, extra:] = idx
    return out


class OverlapPatchEmbed(nn.Module):
    """k x k stride-s conv patch embed + LN: (B, H, W, C) -> (B, H'W', D), H', W'."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size: int = 3, stride: int = 2):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, stride=stride,
                           padding=patch_size // 2)
        self.norm = LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, int, int]:
        x = conv_nhwc(self.proj, x)
        B, H, W, C = x.shape
        return self.norm(x.reshape(B, H * W, C)), H, W


class RelativeAttention(nn.Module):
    def __init__(self, dim: int, img_size: tuple[int, int], extra_token_num: int = 1,
                 num_heads: int = 8, qkv_bias: bool = False, qk_scale: float | None = None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 attn_fp32_softmax: bool = True, head_split: bool = False):
        super().__init__()
        h, w = img_size
        self.dim, self.num_heads, self.img_size = dim, num_heads, (h, w)
        self.extra_token_num = extra_token_num
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.attn_fp32_softmax = attn_fp32_softmax
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * h - 1) * (2 * w - 1) + 1, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(build_relative_position_index(h, w, extra_token_num)).long(),
            persistent=False)
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.attn_drop = Dropout(attn_drop)
        self.proj = Linear(dim, dim)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        h, w = self.img_size
        if N != h * w + self.extra_token_num:
            raise ValueError(f"RelativeAttention: {N} tokens for a {h}x{w} grid and "
                             f"{self.extra_token_num} extra tokens")
        H = self.num_heads
        q, k, v = (t.reshape(B, N, H, C // H) for t in self.qkv(x).split(C, dim=-1))
        score_dtype = torch.float32 if self.attn_fp32_softmax else q.dtype
        scale = torch.tensor(self.scale, dtype=score_dtype)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.to(score_dtype) * scale, k.to(score_dtype))
        bias = self.relative_position_bias_table[self.relative_position_index]  # (N, N, H)
        logits = logits + bias.permute(2, 0, 1)[None].to(score_dtype)
        probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        probs = self.attn_drop(probs)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).to(x.dtype)
        return self.proj_drop(self.proj(out.reshape(B, N, C)))


class RelativeMHSABlock(nn.Module):
    """Transformer block with an optional stride-2 OverlapPatchEmbed.

    stride 2: the input is (B, H, W, C_in); it is patch-embedded to
    ``output_dim``, ``extra_tokens`` (B, E, D) are put in front, and the
    attention grid is the embedded one. stride 1: the input is (B, N, C)
    tokens and the width stays ``input_dim``. ``image_size`` is the grid
    before this block's embed."""

    def __init__(self, input_dim: int, output_dim: int, image_size: tuple[int, int],
                 stride: int, num_heads: int = 8, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, extra_token_num: int = 1, qkv_bias: bool = False,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, act_exact: bool = False,
                 attn_fp32_softmax: bool = True, head_split: bool = False):
        super().__init__()
        self.stride = stride
        if stride == 2:
            dim = output_dim
            self.patch_embed = OverlapPatchEmbed(input_dim, dim, stride=2)
            grid = (-(-image_size[0] // 2), -(-image_size[1] // 2))
        else:
            dim, grid = input_dim, tuple(image_size)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = RelativeAttention(
            dim, grid, extra_token_num=extra_token_num, num_heads=num_heads,
            qkv_bias=qkv_bias, attn_drop=attn_drop, proj_drop=proj_drop,
            attn_fp32_softmax=attn_fp32_softmax, head_split=head_split)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, act_exact=act_exact, drop=proj_drop)

    def forward(self, x: torch.Tensor, extra_tokens: torch.Tensor | None = None) -> torch.Tensor:
        if self.stride == 2:
            x, _, _ = self.patch_embed(x)
            if extra_tokens is not None:
                x = torch.cat([extra_tokens, x], dim=1)
        x = drop_path_add(x, self.attn(self.norm1(x)), self.drop_path)
        return drop_path_add(x, self.mlp(self.norm2(x)), self.drop_path)
