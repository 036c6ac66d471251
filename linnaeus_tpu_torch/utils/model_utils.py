"""Model surgery helpers.

Copy of linnaeus_tpu/utils/model_utils.py (reference: utils/model_utils.py:7),
held against the original by tests/test_torch_mformer_v0.py: the
relative-position-bias table of mFormerV0's RelativeAttention resampled to
another grid when the image size changes. mFormerV1 needs no such helper:
its mixed-RoPE angles are recomputed from learnable frequencies for any grid.
"""

from __future__ import annotations

import numpy as np


def interpolate_rel_pos_bias(
    table: np.ndarray,
    src_grid: tuple[int, int],
    dst_grid: tuple[int, int],
) -> np.ndarray:
    """Resample a relative-position-bias table between grid sizes,
    bilinearly, on the (2H-1) x (2W-1) offset grid.

    ``table``: ((2H-1)(2W-1) + 1, num_heads); the final row (the offset
    that every extra token shares) is kept as it is.
    """
    sh, sw = src_grid
    dh, dw = dst_grid
    if (sh, sw) == (dh, dw):
        return table
    num_heads = table.shape[1]
    src_rows = (2 * sh - 1) * (2 * sw - 1)
    if table.shape[0] != src_rows + 1:
        raise ValueError(
            f"table has {table.shape[0]} rows; expected {src_rows + 1} for grid "
            f"{src_grid}"
        )
    body = table[:-1].reshape(2 * sh - 1, 2 * sw - 1, num_heads)
    ys = np.linspace(0, 2 * sh - 2, 2 * dh - 1)
    xs = np.linspace(0, 2 * sw - 2, 2 * dw - 1)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.clip(y0 + 1, 0, 2 * sh - 2)
    x1 = np.clip(x0 + 1, 0, 2 * sw - 2)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    out = (
        body[y0][:, x0] * (1 - wy) * (1 - wx)
        + body[y0][:, x1] * (1 - wy) * wx
        + body[y1][:, x0] * wy * (1 - wx)
        + body[y1][:, x1] * wy * wx
    )
    out = out.reshape((2 * dh - 1) * (2 * dw - 1), num_heads)
    return np.concatenate([out, table[-1:]], axis=0).astype(table.dtype)
