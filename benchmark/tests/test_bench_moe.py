"""The cell ``v1_sm_moe.train384`` and what it adds to the harness, on the
CPU: the cell driven whole at a tiny geometry with its routing compared,
and not correct with the program's capacity halved; the routing hook's
choices equal to the program's own ``route``; the
expert layers' readers on a recorder filled by hand (None without their
spans or counters, and from a program that has neither); the expert
products' device time counted once an operation; the count of the model's
products against the program's ``FlopCounterMode`` count."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import calibrate_moe, common, roofline, roofline_moe, run
from benchmark.drivers import train_moe
from benchmark.drivers.train import program_config
from benchmark.reference import model_moe
from benchmark.tests.test_bench_span_readers import FakeEvent
from benchmark.tests.tiny import BENCH, SEED, tiny, tiny_float32
from linnaeus_tpu_torch.utils import tracing

CELL = "v1_sm_moe.train384"
ROUTING = ("route_flip_share", "keep_mismatch_share", "router_prob_gap")


def tiny_doc(adjust=tiny) -> dict:
    doc = common.config_file("mFormerV1_sm_moe")
    adjust(doc, {"kind": "train_moe"})
    return doc


def test_the_cell_runs_whole_and_compares_the_routing():
    result = run.run_cell(BENCH, CELL, SEED, 0.5, False, torch.device("cpu"), adjust=tiny)
    assert result["correct"] is True, result["checks"]
    assert set(ROUTING) <= set(result["checks"])
    assert result["metrics"] == {} and result["attempted"] > 0


def test_in_float32_the_reference_under_the_held_routing_makes_the_programs_choices():
    result = run.run_cell(BENCH, CELL, SEED, 0.5, False, torch.device("cpu"),
                          adjust=tiny_float32)
    checks = {k: v["value"] for k, v in result["checks"].items()}
    assert result["correct"] is True
    assert checks["route_flip_share"] == checks["keep_mismatch_share"] == 0.0
    assert checks["router_prob_gap"] < 1e-5
    assert all(v <= 1e-4 for v in checks.values()), checks


def test_with_the_programs_capacity_halved_the_cell_is_not_correct():
    with calibrate_moe.planted_capacity(0.5):
        result = run.run_cell(BENCH, CELL, SEED, 0.5, False, torch.device("cpu"),
                              adjust=tiny_float32)
    checks = {k: v["value"] for k, v in result["checks"].items()}
    assert result["correct"] is False
    # the reference queues the program's experts for the full capacity, and
    # the drops it keeps move the change ten times past float32's 1e-4
    assert checks["keep_mismatch_share"] > 0.1, checks
    assert checks["change_median_gap"] > 1e-3, checks


def test_the_routing_hook_records_the_programs_own_route(monkeypatch):
    from linnaeus_tpu_torch.models.blocks import moe
    from linnaeus_tpu_torch.models.build import build_model

    doc = tiny_doc()
    spec = model_moe.spec_from_config(doc["config"], doc["num_classes"])
    model = build_model(program_config(doc), doc["num_classes"], device="cpu", seed=3)
    real, inside = moe.route, []

    def kept(*args):
        out = real(*args)
        inside.append(out)
        return out

    handles, seen = train_moe.watch_routing(model)
    monkeypatch.setattr(moe, "route", kept)
    x = torch.rand(2, spec["img"], spec["img"], 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        model(x, torch.randn(2, sum(d for _, d in spec["meta"])))
    for h in handles:
        h.remove()
    program = inside[0::2]  # the layer's own call, then the hook's
    assert len(seen) == len(program) == 2
    for (experts, keep, probs), (p_probs, _, p_experts, _, p_keep) in zip(seen, program):
        assert torch.equal(experts, p_experts) and torch.equal(keep, p_keep)
        assert torch.equal(probs, p_probs.gather(-1, p_experts))
        assert experts.dtype == torch.int64 and model.dtype == torch.bfloat16


# ---------------------------------------------------------------- the readers


@pytest.fixture
def recorder(monkeypatch):
    """``fill(steps)``: each step a ``train_step`` span holding the given
    (name, device ms) spans, a step's spans starting inside it."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    tracing.reset()

    def fill(steps):
        at = 100.0
        for inner in steps:
            tracing._records.append(("train_step", None, at, at + 0.5,
                                     (FakeEvent(0.0), FakeEvent(100.0))))
            for i, (name, ms) in enumerate(inner):
                events = None if ms is None else (FakeEvent(0.0), FakeEvent(ms))
                tracing._records.append((name, "MoEMlp.forward", at + 0.01 * (i + 1),
                                         at + 0.01 * (i + 1.5), events))
            at += 1.0

    yield fill
    tracing.reset()


def moe_step(scale: float):
    """Two layers' spans of one step, ``scale`` times the first step's."""
    return [(name, ms * scale) for _ in range(2)
            for name, ms in (("MoEMlp.forward", 3.0), ("MoEMlp.forward/route", 1.0),
                             ("MoEMlp.forward/dispatch", 0.25),
                             ("MoEMlp.forward/experts", 1.25), ("MoEMlp.forward/combine", 0.5))]


def test_the_span_readers_give_the_median_steps_sum(recorder):
    recorder([moe_step(1.0), moe_step(1.2), moe_step(3.0)])  # the last traced on the host too
    assert common.metric_reader("moe_ms.train_moe")({}) == pytest.approx(2 * 3.0 * 1.2)
    assert common.metric_reader("moe_route_ms.train_moe")({}) == pytest.approx(2 * 1.75 * 1.2)


def test_the_span_readers_give_none_without_their_spans_or_off_the_card(recorder):
    recorder([[("MoEMlp.forward", 3.0)]] * 2)
    assert common.metric_reader("moe_route_ms.train_moe")({}) is None
    tracing.reset()
    recorder([[(name, None) for name, _ in moe_step(1.0)]] * 2)
    assert common.metric_reader("moe_ms.train_moe")({}) is None


def test_the_drop_share_is_dropped_over_routed_choices(recorder):
    counts = torch.tensor([[10, 6, 4, 12], [8, 6, 4, 12], [2, 0, 0, 0]])  # routed, kept, dropped
    for layer in ("stages.2.1.mlp", "stages.3.1.mlp"):
        for _ in range(2):
            tracing.count(f"MoEMlp.counts/{layer}", counts)  # off: nothing kept
    assert tracing.counters() == {}
    assert common.metric_reader("moe_drop_share.train_moe")({}) is None
    with tracing.enabled():
        tracing.count("MoEMlp.counts/stages.2.1.mlp", counts)
        tracing.count("MoEMlp.counts/stages.3.1.mlp", counts * 3)
        tracing.count("other", torch.ones(2))
    assert common.metric_reader("moe_drop_share.train_moe")({}) == pytest.approx(100 * 8 / 128)


@pytest.mark.parametrize("name", ["moe_ms.train_moe", "moe_route_ms.train_moe",
                                  "moe_drop_share.train_moe"])
def test_a_program_without_records_or_counters_gives_none(name, recorder, monkeypatch):
    import linnaeus_tpu_torch.utils

    recorder([moe_step(1.0)])
    with tracing.enabled():
        tracing.count("MoEMlp.counts/stages.2.1.mlp", torch.ones(3, 8))
    for attr in ("records", "counters"):  # the recorder as it was before them
        monkeypatch.delattr(tracing, attr)
    assert common.metric_reader(name)({}) is None
    monkeypatch.setitem(sys.modules, "linnaeus_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(linnaeus_tpu_torch.utils, "tracing")
    assert common.metric_reader(name)({}) is None


def test_the_expert_products_device_time_counts_each_operation_once():
    def ev(name, ms, parent=None):
        return SimpleNamespace(name=name, device_time_total=ms * 1e3, cpu_parent=parent)

    outer = ev("autograd::engine::evaluate_function: BaddbmmBackward0", 5.0)
    events = [ev("aten::baddbmm", 1.5), ev("aten::addmm", 9.0), outer,
              ev("BaddbmmBackward0", 4.5, outer), ev("aten::bmm", 2.0, outer)]
    assert train_moe.expert_device_ms(events) == pytest.approx(6.5)
    assert train_moe.expert_device_ms(events[1:2]) is None


def test_the_roofline_reader_is_the_bound_over_the_device_time():
    doc = common.config_file("mFormerV1_sm_moe")
    spec = model_moe.spec_from_config(doc["config"], doc["num_classes"])
    bound = roofline_moe.experts_ms(spec, 128)
    # stage 3: two layers, E=8, S=128*182, D=384, F=1536; stage 4: S=128*47, 768, 3072
    ops = 3 * 2 * 2 * 8 * 128 * (2 * 182 * 384 * 1536 + 47 * 768 * 3072)
    assert bound == pytest.approx(1e3 * ops / roofline.PEAK_FLOPS[torch.bfloat16])
    read = common.metric_reader("moe_experts_roofline.train_moe")
    assert read({"experts_ms": 2 * bound, "spec": spec, "batch": 128}) == pytest.approx(50.0)
    assert read({"experts_ms": None, "spec": spec, "batch": 128}) is None


def test_the_experts_backward_reads_and_writes_each_operand_once():
    E, S, D, F = 2, 8, 4, 16  # bound by its bytes
    fwd, bwd = roofline_moe.experts_bound((E, S, D, F), False), \
        roofline_moe.experts_bound((E, S, D, F), True)
    assert fwd["bound_by"] == bwd["bound_by"] == "bytes"
    per_product = 2 * (E * S * D + E * D * F + E * S * F)
    assert fwd["bound_ms"] == pytest.approx(1e3 * 2 * per_product / roofline.PEAK_BYTES_PER_S)
    assert bwd["bound_ms"] == pytest.approx(2 * fwd["bound_ms"])


@pytest.mark.parametrize("full_size", [False, True])
def test_the_padded_forward_products_are_the_programs_flop_count(full_size):
    from linnaeus_tpu_torch.evaluation.complexity import estimate_model_complexity
    from linnaeus_tpu_torch.models.build import build_model

    doc = common.config_file("mFormerV1_sm_moe")
    if not full_size:
        tiny(doc, {"kind": "train_moe"})
    doc["config"]["MODEL"].update(USE_FLASH_ATTN=False, FUSED_CONVNEXT_MLP="off")
    spec = model_moe.spec_from_config(doc["config"], doc["num_classes"])
    model = build_model(program_config(doc), doc["num_classes"], device="cpu")
    counted = estimate_model_complexity(model, spec["img"], sum(d for _, d in spec["meta"]))
    padded = roofline_moe.forward_flops(spec, padded=True)
    assert padded == pytest.approx(counted["flops_per_sample"], rel=1e-9)
    # without the padding: k experts a token and the router in place of each dense MLP
    dense = roofline.forward_flops(spec)
    extra = sum(4 * N * D * F + 2 * N * D * 8 for N, D, F in roofline_moe.expert_layers(spec))
    assert roofline_moe.forward_flops(spec) == pytest.approx(dense + extra)
    assert roofline_moe.forward_flops(spec) < padded


def test_the_mfu_reader_counts_three_forwards_of_the_window():
    doc = common.config_file("mFormerV1_sm_moe")
    spec = model_moe.spec_from_config(doc["config"], doc["num_classes"])
    ctx = {"spec": spec, "window": {"images": 1280, "seconds": 1.0}}
    want = 100 * 3 * roofline_moe.forward_flops(spec) * 1280 / roofline.PEAK_FLOPS[torch.bfloat16]
    assert common.metric_reader("mfu.train_moe")(ctx) == pytest.approx(want)
