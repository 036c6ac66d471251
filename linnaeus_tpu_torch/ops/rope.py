"""2D rotary position embedding math.

Port of linnaeus_tpu/ops/rope.py. Mixed mode uses learnable per-head 2D
frequencies; axial mode uses fixed per-axis frequency ladders. The rotation
acts on interleaved (even, odd) feature pairs of token-major (B, N, H, D)
q and k directly; the TPU package's weight-level de-interleave is a layout
trick with the same math and is not carried over. Angles are float32; the
rotation runs in the input dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def init_t_xy(end_x: int, end_y: int) -> tuple[np.ndarray, np.ndarray]:
    """Flattened (x, y) coordinates of an ``end_y`` x ``end_x`` grid, row-major."""
    t = np.arange(end_x * end_y, dtype=np.float32)
    t_x = t % end_x
    t_y = np.floor(t / end_x)
    return t_x, t_y


def init_random_2d_freqs(
    head_dim: int,
    num_heads: int,
    theta: float = 10000.0,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Learnable mixed-frequency init, shape (2, num_heads, head_dim // 2):
    the inverse-frequency ladder 1/theta^(2k/D) projected onto a random
    planar direction per head."""
    half = head_dim // 2
    freq_seq = torch.arange(0, head_dim, 2, dtype=torch.float32)[:half] / head_dim
    inv_freq = 1.0 / (theta**freq_seq)
    angles = torch.rand(num_heads, 1, generator=generator) * (2 * np.pi)
    return torch.stack([inv_freq * torch.cos(angles), inv_freq * torch.sin(angles)])


def compute_mixed_angles(
    freqs: torch.Tensor, t_x: torch.Tensor, t_y: torch.Tensor
) -> torch.Tensor:
    """(N_img, num_heads, head_dim // 2) float32 angles from learnable
    ``freqs`` (2, num_heads, head_dim // 2) and patch coordinates."""
    freqs = freqs.float()
    ax = torch.einsum("n,hd->nhd", t_x.float(), freqs[0])
    ay = torch.einsum("n,hd->nhd", t_y.float(), freqs[1])
    return ax + ay


def compute_axial_angles(
    head_dim: int,
    num_heads: int,
    grid_hw: tuple[int, int],
    theta: float = 10000.0,
) -> np.ndarray:
    """Fixed axial angles, shape (N_img, num_heads, head_dim // 2): the first
    ``head_dim // 4`` pair dims rotate with x, the next with y, any
    remainder is unrotated."""
    H, W = grid_hw
    half = head_dim // 2
    freq_dim = max(half // 2, 1)
    base = 1.0 / (
        theta ** (np.arange(0, half, 2, dtype=np.float32)[:freq_dim] / half)
    )
    t_x, t_y = init_t_xy(W, H)
    angles = np.concatenate(
        [np.einsum("n,d->nd", t_x, base), np.einsum("n,d->nd", t_y, base)], axis=-1
    )
    if angles.shape[-1] < half:
        pad = np.zeros((angles.shape[0], half - angles.shape[-1]), np.float32)
        angles = np.concatenate([angles, pad], axis=-1)
    angles = angles[:, :half]
    return np.broadcast_to(
        angles[:, None, :], (angles.shape[0], num_heads, half)
    ).astype(np.float32)


def apply_rotary_emb_bnhd(
    query: torch.Tensor,
    key: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    n_extra: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate token-major (B, N, H, D) q and k by per-position angles, with
    the leading ``n_extra`` tokens (CLS and metadata) passed through.

    ``cos``/``sin`` are (N_img, H, D // 2) with N = n_extra + N_img. The
    extra tokens get identity rows (cos 1, sin 0), an exact pass-through,
    and the rotation runs in the input dtype.
    """
    dtype = query.dtype
    if n_extra:
        cos = torch.cat([cos.new_ones((n_extra,) + cos.shape[1:]), cos])
        sin = torch.cat([sin.new_zeros((n_extra,) + sin.shape[1:]), sin])
    cos = cos.to(dtype)
    sin = sin.to(dtype)

    def rot(x: torch.Tensor) -> torch.Tensor:
        b, n, h, d = x.shape
        pairs = x.reshape(b, n, h, d // 2, 2)
        xe, xo = pairs[..., 0], pairs[..., 1]
        re = xe * cos - xo * sin
        im = xe * sin + xo * cos
        return torch.stack([re, im], dim=-1).reshape(b, n, h, d)

    return rot(query), rot(key)
