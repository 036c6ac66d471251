"""The yardstick's arithmetic for a model with expert layers (``spec``:
``reference/model_moe.py::spec_from_config``): the expert products' least
time, the model's products, and what the expert layers' readers share.

An expert layer's products, with S = B C slot rows (C the capacity of
``model_moe.capacity``), bf16: forward ``xe (E, S, D) @ wi (E, D, F)`` and
``h (E, S, F) @ wo (E, F, D)``, 2 E S D F operations each; backward four
of the same size (``dh = dy wo^T``, ``dwo = h^T dy``, ``dx = dh wi^T``,
``dwi = xe^T dh``). Each operand of a product is read once and its result
written once; the biases, the GELU and the casts are left out.

``forward_flops`` is ``roofline.forward_flops`` with each expert layer in
place of its block's dense MLP: k experts a token and the router's product,
the capacity's padding left out (``padded`` counts the E C slot rows the
program multiplies, as ``evaluation/complexity.py``'s ``FlopCounterMode``
counts them).
"""

from __future__ import annotations

import statistics

from benchmark import roofline
from benchmark.reference.model_moe import capacity, is_expert_block

BF16 = roofline.BF16


def expert_layers(spec: dict) -> list[tuple[int, int, int]]:
    """(N tokens an image, D, F) of every expert layer of one forward."""
    out = []
    n_extra = 1 + len(spec["meta"])
    for s, div in ((0, 16), (1, 32)):
        N = (spec["img"] // div) ** 2 + n_extra
        D = spec["rdims"][s]
        for j in range(spec["rdepths"][s]):
            if is_expert_block(spec, j):
                out.append((N, D, int(D * spec["mlp_ratio"][s])))
    return out


def experts_bound(shape, backward: bool) -> dict:
    """The least time of one expert layer's products, forward or backward,
    ``shape`` (E, S, D, F)."""
    E, S, D, F = shape
    x, h, wi, wo = E * S * D, E * S * F, E * D * F, E * F * D
    product = 2 * E * S * D * F
    if backward:
        nbytes = (x + wo + h) + (h + x + wo) + (h + wi + x) + (x + h + wi)
        return roofline.bound(4 * product, 2 * nbytes, BF16)
    return roofline.bound(2 * product, 2 * ((x + wi + h) + (h + wo + x)), BF16)


def experts_ms(spec: dict, batch: int) -> float:
    """The expert products' least time for one training step of a batch."""
    E = spec["moe"]["experts"]
    total = 0.0
    for N, D, F in expert_layers(spec):
        shape = (E, batch * capacity(N, spec), D, F)
        total += experts_bound(shape, False)["bound_ms"] + experts_bound(shape, True)["bound_ms"]
    return total


def forward_flops(spec: dict, padded: bool = False) -> float:
    """Operations of the products of one image's forward."""
    E, K = spec["moe"]["experts"], spec["moe"]["top_k"]
    total = roofline.forward_flops(spec)
    for N, D, F in expert_layers(spec):
        rows = E * capacity(N, spec) if padded else K * N
        total += (rows - N) * 2 * 2 * D * F + 2 * N * D * E
    return float(total)


def train_mfu(ctx: dict) -> float:
    w = ctx["window"]
    flops = 3.0 * forward_flops(ctx["spec"]) * w["images"]
    return 100.0 * flops / w["seconds"] / roofline.PEAK_FLOPS[BF16]


# ---------------------------------------------------------------------------
# the program's spans and counters (linnaeus_tpu_torch/utils/tracing.py)


def span_ms_a_step(names: tuple[str, ...]) -> float | None:
    """Device ms a step of the spans named ``names``: each traced
    ``train_step``'s sum of those that started inside it, the median over
    the steps (a step traced on the host too, slower, is one of many).
    None where the program has no such recorder or no step ran them on a
    card."""
    try:
        from linnaeus_tpu_torch.utils import tracing
    except ImportError:
        return None
    if not hasattr(tracing, "records"):
        return None
    rows = tracing.records()
    per_step = []
    for step in (r for r in rows if r.name == "train_step"):
        inside = [r.device_ms for r in rows
                  if r.name in names and step.start <= r.start <= step.end]
        if inside and all(ms is not None for ms in inside):
            per_step.append(sum(inside))
    return statistics.median(per_step) if per_step else None


def drop_share() -> float | None:
    """Dropped choices over all choices of the expert layers' counters,
    in percent; None where the program keeps no such counters."""
    try:
        from linnaeus_tpu_torch.utils import tracing
    except ImportError:
        return None
    if not hasattr(tracing, "counters"):
        return None
    counts = [v for name, v in tracing.counters().items() if name.startswith("MoEMlp.counts/")]
    routed = sum(float(v[:, 0].sum()) for v in counts)
    if routed <= 0.0:
        return None
    return 100.0 * sum(float(v[:, 2].sum()) for v in counts) / routed
