"""mFormerV1 with V-MoE expert layers as plain float32 PyTorch functions.

``model.py``'s reference with a bank of E expert MLPs in place of the dense
MLP on every ``every_n``-th RoPE block of each stage (blocks n-1, 2n-1, ...
within a stage; Riquelme et al., "Scaling Vision with Sparse Mixture of
Experts", arXiv:2106.05974). Written from the description, independent of
the program: it imports nothing of it and builds no ``nn.Module``; it takes
``model.py``'s functions for every other part. The weights follow the
state_dict names (``<block>.mlp.router`` (D, E), ``wi`` (E, D, F), ``bi``
(E, F), ``wo`` (E, F, D), ``bo`` (E, D)).

An expert layer on the block's tokens after its second LN, h (B, N, D):

- router logits h W_r in float32, probabilities by a softmax;
- each token's k experts: the k largest probabilities, in a stable
  descending order (the lower index first on ties);
- gates: those k probabilities over their sum, the sum floored at 1e-9;
- capacity C = ceil(k N f / E) slots per expert in each image; an image's
  choices queue rank-major (every token's first choice in token order, then
  every second choice) and a choice past its expert's C slots is dropped:
  it adds nothing, so the block's residual passes the token on;
- each kept choice adds gate * (GELU(h W_i[e] + b_i[e]) W_o[e] + b_o[e]);
- statistics: aux = E sum_e f_e P_e (f_e the share of tokens whose first
  choice is e, before capacity; P_e the mean probability of e) and
  z = mean(logsumexp(logits)^2). The training loss adds their means over
  the layers at the configuration's weights.

A **routing operand** (``routing``: per expert layer in forward order, the
``experts`` (B, N, k) another run chose) replaces the layer's own choices.
The layer queues them for its own capacity as it queues its own choices,
so the drops are the reference's, never taken from the operand. Its gates
are then its own probabilities at those experts, renormalised, so the
router's gradient still flows through the gates, aux and z; aux's f counts
the operand's first choices. Each layer reports its own top k (``own``),
its drops under the experts it used (``keep``) and its probabilities at
them (``probs``), detached, for the routing's own comparison.

``quant`` (the control) rounds the router's and the experts' products to
float8 as ``model.py`` rounds every other product.
"""

from __future__ import annotations

import copy
import math

import torch
import torch.nn.functional as F

from . import model as M


def spec_from_config(cfg: dict, num_classes: dict) -> dict:
    """``model.py``'s geometry, and the expert layers' settings under
    ``moe`` (None without them)."""
    m = cfg["MODEL"].get("MOE", {})
    dense = copy.deepcopy(cfg)
    dense["MODEL"]["MOE"] = dict(m, ENABLED=False)
    spec = M.spec_from_config(dense, num_classes)
    spec["moe"] = None if not m.get("ENABLED", False) else {
        "experts": int(m["NUM_EXPERTS"]),
        "top_k": min(int(m["TOP_K"]), int(m["NUM_EXPERTS"])),
        "capacity_factor": float(m["CAPACITY_FACTOR"]),
        "every_n": max(int(m["EVERY_N"]), 1),
        "aux_weight": float(m["AUX_LOSS_WEIGHT"]),
        "z_weight": float(m["ROUTER_Z_LOSS_WEIGHT"]),
    }
    if spec["moe"] is not None and float(m.get("NOISE_STD", 0.0)) != 0.0:
        raise NotImplementedError("router noise: the reference routes without noise")
    return spec


def is_expert_block(spec: dict, j: int) -> bool:
    """Whether block ``j`` of a RoPE stage holds an expert layer."""
    moe = spec["moe"]
    return moe is not None and j % moe["every_n"] == moe["every_n"] - 1


def param_shapes(spec: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter by its state_dict name: ``model.py``'s layout with
    each expert block's MLP an expert bank."""
    out: dict[str, tuple[int, ...]] = {}
    for name, shape in M.param_shapes(spec).items():
        parts = name.split(".")
        if parts[0] == "stages" and parts[3] == "mlp" and is_expert_block(spec, int(parts[2])):
            if parts[4] == "fc1" and parts[5] == "weight":
                F_, D = shape
                E, p = spec["moe"]["experts"], ".".join(parts[:4])
                out.update({f"{p}.router": (D, E), f"{p}.wi": (E, D, F_), f"{p}.bi": (E, F_),
                            f"{p}.wo": (E, F_, D), f"{p}.bo": (E, D)})
            continue
        out[name] = shape
    return out


def capacity(tokens: int, spec: dict) -> int:
    moe = spec["moe"]
    return max(1, math.ceil(moe["top_k"] * tokens * moe["capacity_factor"] / moe["experts"]))


def queue_keep(experts: torch.Tensor, num_experts: int, cap: int) -> torch.Tensor:
    """(B, N, k) whether each choice finds a slot: its place in its
    expert's rank-major queue of its image is below ``cap``."""
    B, N, K = experts.shape
    queue = F.one_hot(experts.transpose(1, 2).reshape(B, K * N), num_experts)
    place = (queue.cumsum(dim=1) * queue).sum(dim=-1) - 1
    return (place < cap).view(B, K, N).transpose(1, 2)


def expert_layer(ops, W, p, h, spec, held=None) -> tuple[torch.Tensor, dict]:
    """The layer's output (B, N, D) and its record: ``aux``, ``z`` and,
    detached, ``own`` (its own top k), ``keep`` and ``probs`` (at the
    experts used). ``held``: the experts of a routing operand, or None."""
    B, N, D = h.shape
    E, K = spec["moe"]["experts"], spec["moe"]["top_k"]
    logits = ops.bmm(h, W[f"{p}.router"])  # (B, N, E)
    probs = torch.softmax(logits, dim=-1)
    own = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :K]
    experts = own if held is None else held
    keep = queue_keep(experts, E, capacity(N, spec))
    chosen = probs.gather(-1, experts)
    gates = torch.where(keep, chosen / chosen.sum(dim=-1, keepdim=True).clamp_min(1e-9),
                        torch.zeros_like(chosen))
    flat, g = h.reshape(B * N, D), gates.reshape(B * N, K)
    y = torch.zeros_like(flat)
    for e in range(E):
        token, rank = ((experts == e) & keep).reshape(B * N, K).nonzero(as_tuple=True)
        if token.numel() == 0:
            continue
        hidden = M.gelu(ops.bmm(flat[token], W[f"{p}.wi"][e]) + W[f"{p}.bi"][e])
        out = ops.bmm(hidden, W[f"{p}.wo"][e]) + W[f"{p}.bo"][e]
        y = y.index_add(0, token, g[token, rank][:, None] * out)
    first = F.one_hot(experts[..., 0], E).float().mean(dim=(0, 1))
    record = {"aux": E * (first * probs.mean(dim=(0, 1))).sum(),
              "z": torch.logsumexp(logits, dim=-1).square().mean(),
              "own": own.detach(), "keep": keep, "probs": chosen.detach()}
    return y.view(B, N, D), record


def moe_rope_block(ops, W, p, x, heads, grid, n_extra, drop, spec, held, layers):
    x = x + drop(M.attention(ops, W, p, M.layer_norm(x, W, f"{p}.norm1", 1e-5), heads, grid,
                             n_extra))
    y, record = expert_layer(ops, W, f"{p}.mlp", M.layer_norm(x, W, f"{p}.norm2", 1e-5), spec,
                             held)
    layers.append(record)
    return x + drop(y)


def forward(W: dict, images: torch.Tensor, meta: torch.Tensor, spec: dict,
            draw=None, quant: bool = False, routing=None):
    """``model.forward``'s logits by task and the expert layers' records in
    forward order (``expert_layer``). ``routing``: the operand of the
    module docstring, one ``experts`` tensor a layer, or None."""
    ops = M.Ops(quant)
    rates = iter(M.drop_path_rates(spec))
    B = images.shape[0]
    held = iter(routing) if routing is not None else None
    layers: list[dict] = []

    def dropper(rate):
        def drop(y):
            if draw is None or rate <= 0.0:
                return y
            keep = 1.0 - rate
            mask = draw((B,) + (1,) * (y.dim() - 1)) < keep
            return torch.where(mask, y / keep, torch.zeros_like(y))
        return drop

    def rope_stage(s, x, grid, stage_rates):
        for j in range(spec["rdepths"][s]):
            p, drop = f"stages.{s + 2}.{j}", dropper(stage_rates[j])
            if is_expert_block(spec, j):
                x = moe_rope_block(ops, W, p, x, spec["heads"][s], grid, n_extra, drop, spec,
                                   None if held is None else next(held), layers)
            else:
                x = M.rope_block(ops, W, p, x, spec["heads"][s], grid, n_extra, drop)
        return x

    c, r = spec["cdims"], spec["rdims"]
    x = ops.conv(images, W["stem.0.weight"], W["stem.0.bias"], stride=4)
    x = M.layer_norm(x, W, "stem.1", 1e-6)
    for s in (0, 1):
        if s:
            x = ops.conv(M.layer_norm(x, W, "downsample_layers.0.norm", 1e-6),
                         W["downsample_layers.0.conv.weight"],
                         W["downsample_layers.0.conv.bias"], stride=2)
        for j in range(spec["cdepths"][s]):
            x = M.convnext_block(ops, W, f"stages.{s}.{j}", x, dropper(next(rates)))
    x = ops.conv(M.layer_norm(x, W, "downsample_layers.1.norm", 1e-6),
                 W["downsample_layers.1.conv.weight"], W["downsample_layers.1.conv.bias"],
                 stride=2)
    n_extra = 1 + len(spec["meta"])
    g3 = (spec["img"] // 16, spec["img"] // 16)
    g4 = (spec["img"] // 32, spec["img"] // 32)
    dp_rates = [next(rates) for _ in range(sum(spec["rdepths"]))]
    x = torch.cat([M.extras(ops, W, spec, 1, meta, B), x.reshape(B, g3[0] * g3[1], r[0])], dim=1)
    x = rope_stage(0, x, g3, dp_rates[:spec["rdepths"][0]])
    x = M.layer_norm(x, W, "norm_1", 1e-5)
    cls_1 = ops.linear(M.gelu(ops.linear(x[:, 0:1], W, "cl_1_fc.0.fc1")), W, "cl_1_fc.0.fc2")
    cls_1 = M.layer_norm(cls_1, W, "cl_1_fc.1", 1e-5)
    x = x[:, n_extra:].reshape(B, g3[0], g3[1], r[0])
    x = ops.conv(M.layer_norm(x, W, "downsample_layers.2.norm", 1e-6),
                 W["downsample_layers.2.conv.weight"], W["downsample_layers.2.conv.bias"],
                 stride=2)
    x = torch.cat([M.extras(ops, W, spec, 2, meta, B), x.reshape(B, g4[0] * g4[1], r[1])], dim=1)
    x = rope_stage(1, x, g4, dp_rates[spec["rdepths"][0]:])
    x = M.layer_norm(x, W, "norm_2", 1e-5)
    pair = torch.cat([cls_1, x[:, 0:1]], dim=1)  # (B, 2, D)
    feats = (pair * W["aggregate.weight"][0, :, 0][None, :, None]).sum(dim=1) + W["aggregate.bias"]
    feats = M.layer_norm(feats, W, "final_norm", 1e-5)
    return {t: ops.linear(feats, W, f"head.{t}.fc") for t, _ in spec["tasks"]}, layers
