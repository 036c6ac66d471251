"""The registered attention zoo.

Port of linnaeus_tpu/models/attention/zoo.py (reference: models/attention/*.py):
CBAM, ECA, Linformer, EfficientSelfAttention, DifferentialAttention,
TaskSpecificAttention and HierarchicalAttention, registered under the JAX
package's names. No mFormer uses them; they are reached through
MODEL.ATTENTION_MECHANISM configs. Feature maps are NHWC, token stacks
(B, N, C); softmaxes run in float32. A Flax ``Dense`` or ``Conv`` learns its
input width on first call, a torch layer needs it up front, so the modules
that hold one take ``channels`` / ``dim`` (and Linformer its sequence
length, the rows of its projection ``E``). LayerNorms keep Flax's default
eps of 1e-6.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from linnaeus_tpu_torch.models.blocks.common import (
    INIT_STD,
    Conv1d,
    Conv2d,
    LayerNorm,
    Linear,
    conv_nhwc,
)
from linnaeus_tpu_torch.models.blocks.mbconv import same_padding
from linnaeus_tpu_torch.models.factory import register_attention


def _trunc_normal(*shape: int) -> nn.Parameter:
    """A parameter drawn as the JAX package's trunc_normal(0.02) init."""
    return nn.Parameter(nn.init.trunc_normal_(torch.empty(shape), std=INIT_STD,
                                              a=-2 * INIT_STD, b=2 * INIT_STD))


def _softmax_f32(logits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=-1).to(dtype)


@register_attention("CBAM")
class CBAM(nn.Module):
    """Convolutional Block Attention Module: a channel gate from a shared MLP
    over the average- and max-pooled features, then a 7x7 spatial gate."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.mlp = nn.Sequential(Linear(channels, hidden), nn.ReLU(), Linear(hidden, channels))
        self.spatial = Conv2d(2, 1, 7, padding=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = self.mlp(x.mean(dim=(1, 2))) + self.mlp(x.amax(dim=(1, 2)))
        x = x * torch.sigmoid(gate)[:, None, None, :]
        pooled = torch.cat([x.mean(-1, keepdim=True), x.amax(-1, keepdim=True)], dim=-1)
        return x * torch.sigmoid(conv_nhwc(self.spatial, pooled))


@register_attention("ECA")
class ECA(nn.Module):
    """Efficient Channel Attention: a 1D convolution across the channel
    descriptors."""

    def __init__(self, kernel_size: int = 3):
        super().__init__()
        self.conv = Conv1d(1, 1, kernel_size, padding=kernel_size // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x.mean(dim=(1, 2))[:, None, :])[:, 0, :]
        return x * torch.sigmoid(y)[:, None, None, :]


@register_attention("Linformer")
class LinformerAttention(nn.Module):
    """Linear-complexity attention: K and V projected along the sequence to
    ``proj_k`` rows by one ``E`` shared across heads."""

    def __init__(self, dim: int, seq_len: int, num_heads: int = 8, proj_k: int = 64):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.E = _trunc_normal(seq_len, proj_k)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        hd = C // self.num_heads
        q, k, v = self.qkv(x).reshape(B, N, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        E = self.E.to(k.dtype)
        k = torch.einsum("bhnd,nk->bhkd", k, E)
        v = torch.einsum("bhnd,nk->bhkd", v, E)
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * hd ** -0.5
        out = torch.einsum("bhqk,bhkd->bhqd", _softmax_f32(logits, v.dtype), v)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


@register_attention("EfficientSelfAttention")
class EfficientSelfAttention(nn.Module):
    """SegFormer-style attention whose keys and values come from the token
    grid reduced ``sr_ratio`` times by a strided convolution."""

    def __init__(self, dim: int, num_heads: int = 8, sr_ratio: int = 2):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.q = Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = LayerNorm(dim, eps=1e-6)
        self.kv = Linear(dim, 2 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, N, C = x.shape
        hd = C // self.num_heads
        q = self.q(x).reshape(B, N, self.num_heads, hd).transpose(1, 2)
        kv_in = x
        if self.sr_ratio > 1:
            grid = x.reshape(B, H, W, C).permute(0, 3, 1, 2)
            (top, bottom), (left, right) = (same_padding(n, self.sr_ratio, self.sr_ratio)
                                            for n in (H, W))
            grid = F.pad(grid, (left, right, top, bottom))
            kv_in = self.norm(self.sr(grid).permute(0, 2, 3, 1).reshape(B, -1, C))
        kv = self.kv(kv_in)
        k, v = kv.reshape(B, kv.shape[1], 2, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * hd ** -0.5
        out = torch.einsum("bhqk,bhkd->bhqd", _softmax_f32(logits, v.dtype), v)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


@register_attention("DifferentialAttention")
class DifferentialAttention(nn.Module):
    """Diff Transformer attention: the difference of two softmax maps, the
    second weighted by a learned ``lam``."""

    def __init__(self, dim: int, num_heads: int = 8, lambda_init: float = 0.8):
        super().__init__()
        if dim // num_heads // 2 == 0:
            raise ValueError("dim too small for differential attention")
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.lam = nn.Parameter(torch.tensor(float(lambda_init)))
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        hd = C // H // 2
        qkv = self.qkv(x).reshape(B, N, 3, H, 2, hd).permute(2, 0, 3, 4, 1, 5)
        q, k, v = qkv  # (B, H, 2, N, hd)

        def attn(qi, ki):
            logits = torch.einsum("bhnd,bhmd->bhnm", qi.float(), ki.float()) * hd ** -0.5
            return torch.softmax(logits, dim=-1)

        diff = attn(q[:, :, 0], k[:, :, 0]) - self.lam.float() * attn(q[:, :, 1], k[:, :, 1])
        v_full = v.permute(0, 1, 3, 2, 4).reshape(B, H, N, 2 * hd)
        out = torch.einsum("bhnm,bhmd->bhnd", diff.to(v_full.dtype), v_full)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


@register_attention("TaskSpecificAttention")
class TaskSpecificAttention(nn.Module):
    """Per-task learned attention pooling: (B, N, C) -> (B, num_tasks, C)."""

    def __init__(self, dim: int, num_tasks: int):
        super().__init__()
        self.dim = dim
        self.task_queries = _trunc_normal(num_tasks, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logits = torch.einsum("td,bnd->btn", self.task_queries.float(), x.float()) \
            * self.dim ** -0.5
        return torch.einsum("btn,bnd->btd", _softmax_f32(logits, x.dtype), x)


@register_attention("HierarchicalAttention")
class HierarchicalAttention(nn.Module):
    """Coarse-to-fine task attention: each task's query is conditioned on the
    pooled feature of the task before it. (B, N, C) -> (B, num_tasks, C)."""

    def __init__(self, dim: int, num_tasks: int):
        super().__init__()
        self.dim, self.num_tasks = dim, num_tasks
        self.task_queries = _trunc_normal(num_tasks, dim)
        self.cond = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        outs = []
        prev = torch.zeros(B, self.dim, dtype=x.dtype, device=x.device)
        for t in range(self.num_tasks):
            q = self.task_queries[t][None, :] + self.cond(prev)
            logits = torch.einsum("bd,bnd->bn", q.float(), x.float()) * self.dim ** -0.5
            pooled = torch.einsum("bn,bnd->bd", _softmax_f32(logits, x.dtype), x)
            outs.append(pooled)
            prev = pooled
        return torch.stack(outs, dim=1)
