"""The port's mFormerV1 with expert layers against the benchmark's plain
float32 reference (benchmark/reference/model_moe.py), on the CPU at a tiny
geometry (64 px, RoPE depths [2, 2]: an expert layer at each stage, 8
experts, top-2), seeded random weights, both sides in float32.

Routing free, and under a routing operand that differs from the
reference's own choice (the program made to route to each token's two
least likely experts, the reference handed those experts and queuing them
for its own capacity, to the program's drops): the
logits, the loss with the aux and z terms and every parameter's gradient
agree to float32 rounding (a leaf's gradient to 2e-4 of its largest entry,
or of the median leaf's where its own is nought but for rounding). With a capacity of one slot most choices drop,
and a token whose choices all drop leaves its expert layer as zero on
both sides, so the block's residual passes it on.
"""

from __future__ import annotations

import pytest
import torch

from benchmark import common
from benchmark.drivers.train import program_config
from benchmark.reference import model_moe
from benchmark.tests.tiny import tiny_float32
from linnaeus_tpu_torch.models.blocks import moe
from linnaeus_tpu_torch.models.build import build_model

B = 3


def setup(capacity_factor: float = 1.25):
    doc = common.config_file("mFormerV1_sm_moe")
    tiny_float32(doc, {"kind": "train"})
    doc["config"]["MODEL"]["MOE"]["CAPACITY_FACTOR"] = capacity_factor
    spec = model_moe.spec_from_config(doc["config"], doc["num_classes"])
    model = build_model(program_config(doc), doc["num_classes"], device="cpu", seed=3)
    model.eval()  # no stochastic depth: the reference's forward without draws
    weights = common.make_weights(model_moe.param_shapes(spec), 11, torch.device("cpu"))
    model.load_state_dict(weights, strict=True)
    g = torch.Generator().manual_seed(5)
    x = torch.rand(B, spec["img"], spec["img"], 3, generator=g)
    aux = torch.randn(B, sum(d for _, d in spec["meta"]), generator=g)
    probes = {t: torch.randn(B, n, generator=g) for t, n in spec["tasks"]}
    return spec, model, weights, x, aux, probes


def objective(logits: dict, probes: dict, aux, z, spec) -> torch.Tensor:
    """A scalar of every logit, with the configuration's MoE terms."""
    task = sum((logits[t].float() * probes[t]).sum() for t in probes)
    return task + spec["moe"]["aux_weight"] * aux + spec["moe"]["z_weight"] * z


def both_sides(spec, model, weights, x, aux, probes, routing=None):
    logits, stats = model(x, aux, moe_stats=True)
    got_loss = objective(logits, probes, stats["moe_aux"], stats["moe_z"], spec)
    got_loss.backward()
    W = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    want, layers = model_moe.forward(W, x, aux, spec, routing=routing)
    n = len(layers)
    want_loss = objective(want, probes, sum(r["aux"] for r in layers) / n,
                          sum(r["z"] for r in layers) / n, spec)
    grads = dict(zip(W, torch.autograd.grad(want_loss, list(W.values()))))
    for t in want:
        torch.testing.assert_close(logits[t], want[t], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got_loss, want_loss, rtol=1e-5, atol=1e-5)
    # each leaf's gap over its largest gradient; over the median leaf's where
    # its own is under a thousandth of that, nought but for rounding (the
    # bias of the CLS aggregation, under the final LayerNorm)
    sizes = {n: float(g.abs().max()) for n, g in grads.items()}
    median = float(torch.tensor(list(sizes.values())).median())
    for name, p in model.named_parameters():
        gap = float((p.grad - grads[name]).abs().max())
        scale = sizes[name] if sizes[name] >= 1e-3 * median else median
        assert gap <= 2e-4 * scale, (name, gap, sizes[name])
    return layers


def test_the_layout_has_the_expert_banks_of_the_programs_state_dict():
    spec, model, *_ = setup()
    banks = [k for k in model_moe.param_shapes(spec) if k.endswith(".mlp.router")]
    assert banks == ["stages.2.1.mlp.router", "stages.3.1.mlp.router"]
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        model_moe.param_shapes(spec)


def test_routing_free_the_logits_loss_and_every_gradient_agree():
    spec, model, weights, x, aux, probes = setup()
    layers = both_sides(spec, model, weights, x, aux, probes)
    assert len(layers) == 2
    for name in ("stages.2.1.mlp.router", "stages.2.1.mlp.wi", "stages.3.1.mlp.bo"):
        assert model.get_parameter(name).grad.abs().max() > 0, name


def test_under_a_routing_operand_other_than_its_own_the_reference_follows_it(monkeypatch):
    spec, model, weights, x, aux, probes = setup()
    real, held, kept = moe.route, [], []

    def least_likely(logits, top_k, cap):
        _, _, experts, slots, keep = real(-logits, top_k, cap)
        probs = torch.softmax(logits, dim=-1)
        chosen = probs.gather(-1, experts)
        held.append(experts)
        kept.append(keep)
        return probs, chosen / chosen.sum(dim=-1, keepdim=True).clamp_min(1e-9), experts, \
            slots, keep

    monkeypatch.setattr(moe, "route", least_likely)
    layers = both_sides(spec, model, weights, x, aux, probes, routing=held)
    assert len(held) == len(layers) == 2
    for experts, keep, record in zip(held, kept, layers):
        assert not torch.equal(experts, record["own"])
        assert torch.equal(keep, record["keep"]) and not keep.all()


@pytest.mark.parametrize("where", ["program", "reference"])
def test_a_choice_past_capacity_drops_and_the_token_passes_through(where):
    spec, model, weights, x, aux, probes = setup(capacity_factor=0.05)
    layer = model.stages[2][1].mlp
    h = torch.randn(B, 20, layer.router.shape[0], generator=torch.Generator().manual_seed(7))
    C = moe.capacity(20, layer.num_experts, layer.top_k, layer.capacity_factor)
    assert C == model_moe.capacity(20, spec) == 1
    _, _, experts, _, keep = moe.route(h @ layer.router, layer.top_k, C)
    if where == "program":
        with torch.no_grad():
            y, stats = layer(h)
        assert float(stats.drop_frac) > 0.5
    else:
        y, _ = model_moe.expert_layer(model_moe.M.Ops(), weights, "stages.2.1.mlp", h, spec)
        torch.testing.assert_close(
            model_moe.queue_keep(experts, layer.num_experts, C), keep)
    gone = ~keep.any(dim=-1)
    assert gone.any() and (~gone).any()
    assert torch.count_nonzero(y[gone]) == 0
    assert (y[~gone].abs().sum(dim=-1) > 0).all()


def test_capacity_drops_agree_through_the_whole_model():
    spec, model, weights, x, aux, probes = setup(capacity_factor=0.3)
    with torch.no_grad():
        _, stats = model(x, aux, moe_stats=True)
    assert float(stats["moe_drop_frac"]) > 0.2
    both_sides(spec, model, weights, x, aux, probes)
