"""The yardstick's arithmetic: the card's peaks, the kernels' least times,
the model's products.

``bound``, ``k1_bound``, ``k2_bound``, ``k3_bound``, ``PEAK_FLOPS`` and
``PEAK_BYTES_PER_S`` are copied from the repository's ``chip_smoke.py``
(published H100 SXM peaks, dense; each input byte read once, each output
byte written once). ``k2_bound`` takes one argument more, ``residual``: a
call without the residual operand (the training route under stochastic
depth) reads one activation less; its default is the copied function.

``forward_flops`` counts the products of one forward of the model
(2 operations a multiply-add; convolutions, projections, the attention's
two products): the count ``evaluation/complexity.py`` makes with ``FlopCounterMode`` for a dense
model (26.77 GFLOP an image for mFormerV1_sm at 384 px).
"""

from __future__ import annotations

import torch

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float, dtype: torch.dtype) -> dict:
    """The least time the card could take: the larger of the operations over
    its peak rate for ``dtype`` and the bytes (each input read once, each
    output written once) over its memory rate."""
    by_ops = 1e3 * flops / PEAK_FLOPS[dtype]
    by_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    return {"bound_ms": max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes"}


def k1_bound(shape, dtype, kind) -> dict:
    """``kind``: False/"fwd", True/"bwd" (the whole backward: its least work
    is the one-pass kernel's five products), "dq" or "dkv"."""
    B, N, H, D = shape
    elems, size = B * N * H * D, torch.finfo(dtype).bits // 8
    product = 2 * B * H * N * N * D  # one N x N x D matrix product per head
    stats = B * H * N * 4
    if kind in (True, "bwd"):  # S, dP, dV, dQ, dK; reads q k v o dO lse, writes dq dk dv
        return bound(5 * product, 8 * elems * size + stats, dtype)
    if kind == "dq":  # S, dP, dQ; reads q k v dO lse delta, writes dq
        return bound(3 * product, 5 * elems * size + 2 * stats, dtype)
    if kind == "dkv":  # S, dP, dV, dK; reads q k v dO lse delta, writes dk dv
        return bound(4 * product, 6 * elems * size + 2 * stats, dtype)
    return bound(2 * product, 4 * elems * size + stats, dtype)


def k2_bound(shape, dtype, backward: bool, residual: bool = True) -> dict:
    M, C = shape
    size = torch.finfo(dtype).bits // 8
    weights = 2 * 4 * C * C
    vectors = (4 * C + 4 * C) * 4
    if backward:  # the forward's two products again and four for the gradients;
        # reads y dout and the parameters, writes dy and float32 gradients
        return bound(6 * 2 * M * C * 4 * C,
                     3 * M * C * size + weights * size + vectors + weights * 4 + vectors, dtype)
    acts = 3 if residual else 2
    return bound(2 * 2 * M * C * 4 * C, acts * M * C * size + weights * size + vectors, dtype)


def k3_bound(shape, dtype) -> dict:
    """The two products and the 49 taps; x read once, out written once, the
    parameters once."""
    B, H, W, C = shape
    M, size = B * H * W, torch.finfo(dtype).bits // 8
    params = 2 * 4 * C * C * size + (49 * C + 5 * C + 4 * C) * 4
    return bound(2 * 2 * M * C * 4 * C + 2 * 49 * M * C, 2 * M * C * size + params, dtype)


# ---------------------------------------------------------------------------
# the model's geometry (``spec``: benchmark/reference/model.py::spec_from_config)


def attention_shapes(spec: dict, batch: int) -> list[tuple[int, int, int, int]]:
    """(B, N, H, head_dim) of every attention call of one forward."""
    out = []
    n_extra = 1 + len(spec["meta"])
    for s, div in ((0, 16), (1, 32)):
        g = spec["img"] // div
        D, H = spec["rdims"][s], spec["heads"][s]
        out += [(batch, g * g + n_extra, H, D // H)] * spec["rdepths"][s]
    return out


def mlp_shapes(spec: dict, batch: int) -> list[tuple[int, int]]:
    """(rows, C) of every ConvNeXt MLP tail of one forward."""
    out = []
    for s, div in ((0, 4), (1, 8)):
        g = spec["img"] // div
        out += [(batch * g * g, spec["cdims"][s])] * spec["cdepths"][s]
    return out


def forward_flops(spec: dict) -> float:
    """Operations of the products of one image's forward."""
    img, c, r = spec["img"], spec["cdims"], spec["rdims"]
    total = 0.0
    hw = (img // 4) ** 2
    total += 2 * hw * c[0] * 3 * 16  # stem
    for s in (0, 1):
        hw = (img // (4 * 2 ** s)) ** 2
        C = c[s]
        total += spec["cdepths"][s] * (2 * hw * C * 49 + 2 * 2 * hw * C * 4 * C)
    for i in range(3):
        hw_out = (img // (8 * 2 ** i)) ** 2
        total += 2 * hw_out * c[i + 1] * c[i] * 4
    n_extra = 1 + len(spec["meta"])
    meta_in = sum(d for _, d in spec["meta"])
    for s, div in ((0, 16), (1, 32)):
        N = (img // div) ** 2 + n_extra
        D = r[s]
        hidden = int(D * spec["mlp_ratio"][s])
        total += 2 * meta_in * D + len(spec["meta"]) * 2 * 2 * D * D  # metadata heads
        total += spec["rdepths"][s] * (2 * N * D * 3 * D + 2 * 2 * N * N * D + 2 * N * D * D
                                       + 2 * 2 * N * D * hidden)
    total += 2 * (r[0] * r[0] + r[0] * r[1])  # the first CLS token's MLP
    total += 2 * 2 * r[1]  # the CLS aggregation
    total += 2 * r[1] * sum(n for _, n in spec["tasks"])
    return float(total)


# ---------------------------------------------------------------------------
# the per-layer readers' shared arithmetic (benchmark/metrics/)

BF16 = torch.bfloat16


def k1_ms(spec: dict, batch: int, backward: bool) -> float:
    """K1's least time for one forward (and its backward) of a batch."""
    return sum(k1_bound(s, BF16, False)["bound_ms"]
               + (k1_bound(s, BF16, True)["bound_ms"] if backward else 0.0)
               for s in attention_shapes(spec, batch))


def k2_ms(spec: dict, batch: int, backward: bool) -> float:
    """K2's least time for one forward (and its backward) of a batch. In
    training a block under stochastic depth (rate above 0) calls the
    forward without its residual operand."""
    from benchmark.reference.model import drop_path_rates

    rates = drop_path_rates(spec)
    total = 0.0
    for i, shape in enumerate(mlp_shapes(spec, batch)):
        residual = not backward or rates[i] <= 0.0
        total += k2_bound(shape, BF16, False, residual=residual)["bound_ms"]
        if backward:
            total += k2_bound(shape, BF16, True)["bound_ms"]
    return total


def share(bound_ms: float, kernel_ms: float) -> float | None:
    """A roofline share in percent; None where no kernel ran."""
    return None if kernel_ms <= 0.0 else 100.0 * bound_ms / kernel_ms


def train_mfu(ctx: dict) -> float:
    w = ctx["window"]
    flops = 3.0 * forward_flops(ctx["spec"]) * w["images"]
    return 100.0 * flops / w["seconds"] / PEAK_FLOPS[BF16]
