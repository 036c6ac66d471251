"""The port's spans (utils/tracing.py) on the CPU, at the tiny geometry of
tests/test_torch_train_step.py: off, a span touches neither the profiler
nor CUDA; under a profiler the train step's phases nest inside it in order
and are counted once a step (once a microbatch where they repeat); tracing
changes no number of the step; set-up spans are recorded with tracing off;
an MoE layer's four sub-spans nest in its span, and its per-expert counters
cover every choice on, and launch nothing off.
Also the device's busy time as the union of its operations
(utils/device.py) and the Trainer's profiled-window summary, on fake
events."""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from linnaeus_tpu_torch.tools import train_bench
from linnaeus_tpu_torch.utils import tracing
from linnaeus_tpu_torch.utils.device import (
    busy_window,
    device_intervals,
    idle_by_span,
    profile_events,
)

TASKS = ("taxa_L10", "taxa_L20")
NC = {"taxa_L10": 7, "taxa_L20": 3}
META = (("TEMPORAL", 2), ("SPATIAL", 3))
SPEC = {
    "CONVNEXT": {"DEPTHS": [2, 1, 2, 1], "DIMS": [8, 16, 32, 64]},
    "ROPE": {"DEPTHS": [2, 1], "DIMS": [32, 64], "NUM_HEADS": [2, 2]},
    "DROP_PATH_RATE": 0.0,
}
B, IMG = 8, 64
PHASES = ("collate", "forward", "loss", "backward", "clip", "update")


@pytest.fixture(autouse=True)
def empty_recorder():
    tracing.reset()
    yield
    tracing.reset()


def tiny_step(accum: int = 1, seed: int = 0):
    return train_bench.build_step(B, IMG, arch=SPEC, num_classes=NC, meta_components=META,
                                  dtype=torch.float32, device="cpu", seed=seed,
                                  accumulation_steps=accum)


def test_off_spans_open_no_range_and_record_no_event(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("called with tracing off")

    run, state = tiny_step()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    for _ in range(2):
        metrics = run()
    assert state.step == 2 and torch.isfinite(metrics["loss"])
    assert tracing.summary() == {}


def test_the_phases_nest_inside_the_step_in_order_in_the_profilers_trace():
    run, _ = tiny_step()
    run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    events = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in profile_events(prof) if e.name().startswith("train_step")]
    (lo, hi, _), = [e for e in events if e[2] == "train_step"]
    inside = sorted(e for e in events if e[2] != "train_step")
    assert [name for _, _, name in inside] == [f"train_step/{p}" for p in PHASES]
    assert all(lo <= s <= e <= hi for s, e, _ in inside)
    assert all(a[1] <= b[0] for a, b in zip(inside, inside[1:]))  # one after another


@pytest.mark.parametrize("accum", [1, 2])
def test_the_recorder_counts_each_step_and_each_microbatch(accum):
    run, _ = tiny_step(accum)
    run()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            run()
    spans = tracing.summary()
    calls = {name: s["calls"] for name, s in spans.items()}
    per_micro = {f"train_step/{p}": 3 * accum for p in PHASES[:4]}
    assert calls == {"train_step": 3, **per_micro, "train_step/clip": 3, "train_step/update": 3}
    assert spans["train_step/forward"]["parent"] == "train_step"
    assert spans["train_step"]["parent"] is None
    assert all(s["device_ms"] is None for s in spans.values())  # no CUDA here
    step = spans["train_step"]
    assert 0 < step["host_ms_median"] <= step["host_ms"]
    assert sum(spans[f"train_step/{p}"]["host_ms"] for p in PHASES) <= step["host_ms"]


def test_tracing_changes_no_number_of_the_step():
    runs = []
    for on in (False, True):
        run, state = tiny_step(seed=3)
        with tracing.enabled() if on else contextlib.nullcontext():
            history = [run() for _ in range(2)]
        runs.append((history, {n: p.detach().clone() for n, p in state.model.named_parameters()}))
    (off, w_off), (on, w_on) = runs
    for a, b in zip(off, on):
        for key in ("loss", "grad_norm_pre_clip", "grad_norm_post_clip"):
            assert torch.equal(a[key], b[key]), key
    assert all(torch.equal(w_off[n], w_on[n]) for n in w_off)
    assert tracing.summary()["train_step"]["calls"] == 2


def _tiny_config(moe: bool = False):
    from linnaeus_tpu_torch.configuration import get_default_config

    cfg = get_default_config()
    cfg.defrost()
    cfg.MODEL.TYPE = "mFormerV1"
    cfg.MODEL.IMG_SIZE = IMG
    cfg.MODEL.CONVNEXT_STAGES.DEPTHS = [1, 1, 1, 1]
    cfg.MODEL.CONVNEXT_STAGES.DIMS = [8, 16, 32, 64]
    cfg.MODEL.ROPE_STAGES.DEPTHS = [2, 2]
    cfg.MODEL.ROPE_STAGES.DIMS = [32, 64]
    cfg.MODEL.ROPE_STAGES.NUM_HEADS = [2, 2]
    cfg.MODEL.ROPE_STAGES.MLP_RATIO = [4.0, 4.0]
    cfg.DATA.TASK_KEYS_H5 = list(TASKS)
    cfg.TRAIN.MIXED_PRECISION.ENABLED = False
    cfg.TRAIN.AMP_OPT_LEVEL = "O0"
    if moe:
        cfg.MODEL.MOE.ENABLED = True
        cfg.MODEL.MOE.NUM_EXPERTS = 4
        cfg.MODEL.MOE.EVERY_N = 1
    return cfg


def test_build_training_is_recorded_with_tracing_off():
    from linnaeus_tpu_torch.train.build import build_training

    assert not torch._C._autograd._profiler_enabled()
    build_training(_tiny_config(), NC, device="cpu", seed=0, total_steps=10)
    spans = tracing.summary()
    assert list(spans) == ["setup/build_training"]
    assert spans["setup/build_training"]["calls"] == 1
    assert spans["setup/build_training"]["host_ms"] > 0


def test_each_moe_layer_forward_is_a_span_in_the_profilers_trace():
    from linnaeus_tpu_torch.models.blocks.moe import MoEMlp
    from linnaeus_tpu_torch.models.build import build_model

    model = build_model(_tiny_config(moe=True), NC, device="cpu", seed=0)
    layers = sum(isinstance(m, MoEMlp) for m in model.modules())
    x, aux = torch.rand(2, IMG, IMG, 3), torch.randn(2, sum(d for _, d in model.meta_components))
    with torch.no_grad():
        model(x, aux)
        assert tracing.summary() == {}
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            model(x, aux)
    ranges = [e for e in profile_events(prof) if e.name() == "MoEMlp.forward"]
    assert layers >= 2 and len(ranges) == layers
    assert tracing.summary()["MoEMlp.forward"]["calls"] == layers


def test_nested_spans_keep_their_parent_and_take_hands_over_one_name():
    with tracing.span("outer", always=True):
        with tracing.span("inner"):  # off: not recorded
            pass
        with tracing.enabled(), tracing.span("inner"):
            pass
    with tracing.span("outer", always=True):
        pass
    spans = tracing.summary()
    assert {n: (s["calls"], s["parent"]) for n, s in spans.items()} == {
        "outer": (2, None), "inner": (1, "outer")}
    taken = tracing.take("outer")
    assert [r.name for r in taken] == ["outer", "outer"]
    assert taken[0].start <= taken[0].end <= taken[1].start
    assert list(tracing.summary()) == ["inner"]
    assert tracing.summary(since=taken[1].end + 1.0) == {}


# ---------------------------------------------------------------- fake events


def event(name, start, end, device="DeviceType.CUDA", annotation=False):
    return SimpleNamespace(name=lambda: name, start_ns=lambda: start,
                           duration_ns=lambda: end - start, device_type=lambda: device,
                           is_user_annotation=lambda: annotation)


def test_overlapping_device_operations_count_once_and_a_gap_counts_as_idle():
    ms = 1_000_000
    events = [
        event("gemm_a", 0, 4 * ms), event("elementwise_b", 2 * ms, 6 * ms),  # overlap: 6 ms
        event("gemm_c", 8 * ms, 10 * ms),  # after a 2 ms gap
        event("Optimizer.step#AdamW.step", 0, 10 * ms),  # a range on the device's timeline
        event("my_range", 0, 10 * ms, annotation=True),
        event("Event Sync", 6 * ms, 8 * ms), event("Stream Wait Event", 6 * ms, 8 * ms),
        event("aten::mm", 0, 12 * ms, device="DeviceType.CPU"),
    ]
    assert device_intervals(events) == [(0, 4 * ms), (2 * ms, 6 * ms), (8 * ms, 10 * ms)]
    busy, window = busy_window(events)
    assert (busy, window) == (8.0, 10.0)
    assert 1.0 - busy / window == pytest.approx(0.2)
    assert busy_window([]) == (0.0, 0.0)


def test_idle_gaps_go_to_the_innermost_span_over_their_middle():
    from linnaeus_tpu_torch.train.loop import profile_window_summary

    ms = 1_000_000
    host = "DeviceType.CPU"
    events = [
        event("k1", 0, 2 * ms), event("k2", 3 * ms, 5 * ms), event("k3", 9 * ms, 10 * ms),
        event("k4", 12 * ms, 13 * ms),
        event("train_step", 0, 10 * ms, host, True),
        event("train_step/loss", 2 * ms, 3 * ms, host, True),  # the 1 ms gap's middle
        event("aten::mm", 5 * ms, 9 * ms, host),  # not a span
    ]
    spans = {"train_step": {"calls": 2, "host_ms": 8.0, "device_ms": 12.0},
             "train_step/loss": {"calls": 2, "host_ms": 1.0, "device_ms": None}}
    assert idle_by_span(events, set(spans)) == {
        "train_step": 4.0, "between spans": 2.0, "train_step/loss": 1.0}
    out = profile_window_summary(events, spans, steps=2, wall_ms=7.0)
    assert out["device_busy_ms_per_step"] == 3.0
    assert out["idle_share"] == pytest.approx(1.0 - 6.0 / 13.0)
    assert out["spans"]["train_step"] == {"calls": 2, "host_ms_per_step": 4.0,
                                          "device_ms_per_step": 6.0}
    assert out["spans"]["train_step/loss"]["device_ms_per_step"] is None
    assert out["idle_ms_by_span"]["between spans"] == 2.0


class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    """The aten operations run inside it, in order (the profiler's own
    range operations left out)."""

    def __init__(self):
        super().__init__()
        self.names: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not str(func).startswith("profiler."):
            self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _moe_layer_and_tokens():
    from linnaeus_tpu_torch.models.blocks.moe import MoEMlp
    from linnaeus_tpu_torch.models.build import build_model

    model = build_model(_tiny_config(moe=True), NC, device="cpu", seed=0)
    layers = [m for m in model.modules() if isinstance(m, MoEMlp)]
    x = torch.randn(2, 20, layers[0].router.shape[0], generator=torch.Generator().manual_seed(1))
    return model, layers, x


def test_moe_layer_off_records_nothing_and_launches_no_counting_work(monkeypatch):
    _, layers, x = _moe_layer_and_tokens()
    with torch.no_grad():
        with _Ops() as off:
            y_off, _ = layers[0](x)
        with tracing.enabled(), _Ops() as on:
            y_on, _ = layers[0](x)
    assert torch.equal(y_off, y_on)
    # on, one block of counting operations more, the rest the same and in order
    extra = len(on.names) - len(off.names)
    at = next(i for i, (a, b) in enumerate(zip(off.names, on.names)) if a != b)
    assert extra > 0 and on.names[:at] + on.names[at + extra:] == off.names
    assert "aten.eq.Tensor" in on.names[at:at + extra] and "aten.eq.Tensor" not in off.names
    tracing.reset()

    def refuse(*args, **kwargs):
        raise AssertionError("called with tracing off")

    monkeypatch.setattr(tracing, "count", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with torch.no_grad():
        layers[0](x)
    assert tracing.summary() == {} and tracing.counters() == {}


def test_moe_sub_spans_nest_in_the_layer_and_its_counters_cover_every_choice():
    from linnaeus_tpu_torch.models.blocks.moe import capacity, route

    model, layers, _ = _moe_layer_and_tokens()
    x, aux = torch.rand(2, IMG, IMG, 3), torch.randn(2, sum(d for _, d in model.meta_components))
    with torch.no_grad(), tracing.enabled():
        model(x, aux)
    spans = tracing.summary()
    assert spans["MoEMlp.forward"]["calls"] == len(layers) >= 2
    for part in ("route", "dispatch", "experts", "combine"):
        name = f"MoEMlp.forward/{part}"
        assert (spans[name]["calls"], spans[name]["parent"]) == (len(layers), "MoEMlp.forward")
    counts = tracing.counters()
    names = [n for n, m in model.named_modules() if m in layers]
    assert sorted(counts) == sorted(f"MoEMlp.counts/{n}" for n in names)
    for name, layer in zip(names, layers):
        c = counts[f"MoEMlp.counts/{name}"]  # (calls, [routed, kept, dropped], experts)
        assert c.shape == (1, 3, layer.num_experts)
        N = model.extra_token_num + (IMG // (16 if name.startswith("stages.2") else 32)) ** 2
        assert float(c[0, 0].sum()) == 2 * N * layer.top_k
        assert torch.equal(c[0, 1] + c[0, 2], c[0, 0])
    # the counts are the routing's own: the first layer's, recomputed
    first = layers[0]
    seen = []
    hook = first.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    with torch.no_grad():
        model(x, aux)
    hook.remove()
    cap = capacity(seen[0].shape[1], first.num_experts, first.top_k, first.capacity_factor)
    _, _, experts, _, keep = route(seen[0] @ first.router, first.top_k, cap)
    kept = torch.bincount(experts[keep], minlength=first.num_experts).double()
    assert torch.equal(counts[f"MoEMlp.counts/{names[0]}"][0, 1], kept)
