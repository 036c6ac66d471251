"""The readers of the program's spans (``linnaeus_tpu_torch/utils/tracing.py``)
on a recorder filled by hand: each returns its per-step or set-up value
(a step traced on the host too, its phases longer, left out of the
phases' medians), None without its span, and None from a program that has
no recorder."""

from __future__ import annotations

import sys

import pytest
import torch

from benchmark import common
from linnaeus_tpu_torch.utils import tracing


class FakeEvent:
    """A timed CUDA event at ``ms`` on the stream's clock."""

    def __init__(self, ms: float):
        self.ms = ms

    def elapsed_time(self, end: "FakeEvent") -> float:
        return end.ms - self.ms


@pytest.fixture
def recorder(monkeypatch):
    """``fill(rows)`` puts (name, parent, host ms, device ms or None) rows in
    the recorder, one call each."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    tracing.reset()

    def fill(rows):
        at = 100.0
        for name, parent, host_ms, device_ms in rows:
            events = None if device_ms is None else (FakeEvent(0.0), FakeEvent(device_ms))
            tracing._records.append((name, parent, at, at + host_ms / 1000.0, events))
            at += 1.0

    yield fill
    tracing.reset()


# three steps of two microbatches: the per-microbatch phases twice a step;
# the last step's calls as a step traced on the host too reads them, longer
STEPS = [("train_step", None, host, 120.0) for host in (100.0, 140.0, 300.0)]
PHASES = [(f"train_step/{p}", "train_step", 1.0, ms * (1 + 2 * (i >= 4)))
          for p, ms in (("collate", 0.75), ("forward", 15.0), ("backward", 35.0))
          for i in range(6)] + [("train_step/clip", "train_step", 0.5, 2.5)] * 2 + [
    ("train_step/clip", "train_step", 0.5, 9.0)]
SETUP = [("setup/build_training", None, 3250.0, 3000.0), ("setup/kernels", None, 500.0, None),
         ("setup/kernels/build", "setup/kernels", 400.0, None)]
WANT = {
    "collate_ms.train": 1.5,  # the median call, 0.75 ms, twice a step
    "forward_ms.train": 30.0,
    "backward_ms.train": 70.0,
    "clip_ms.train": 2.5,
    "step_host_ms.train": 140.0,  # the median of 100, 140 and 300 ms
    "build_training_s.setup": 3.25,
    "kernels_load_s.setup": 0.5,
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_gives_its_value(name, recorder):
    recorder(STEPS + PHASES + SETUP)
    assert common.metric_reader(name)({}) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_gives_none_without_its_span(name, recorder):
    span = {"collate_ms.train": "train_step/collate", "forward_ms.train": "train_step/forward",
            "backward_ms.train": "train_step/backward", "clip_ms.train": "train_step/clip",
            "step_host_ms.train": "train_step", "build_training_s.setup": "setup/build_training",
            "kernels_load_s.setup": "setup/kernels"}[name]
    recorder([r for r in STEPS + PHASES + SETUP if r[0] != span])
    assert common.metric_reader(name)({}) is None
    tracing.reset()
    assert common.metric_reader(name)({}) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_gives_none_from_a_program_without_the_recorder(name, recorder,
                                                                     monkeypatch):
    import linnaeus_tpu_torch.utils

    recorder(STEPS + PHASES + SETUP)
    monkeypatch.setitem(sys.modules, "linnaeus_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(linnaeus_tpu_torch.utils, "tracing")
    assert common.metric_reader(name)({}) is None


def test_the_device_readers_give_none_where_the_spans_ran_off_the_card(recorder):
    recorder([(name, parent, host, None) for name, parent, host, _ in STEPS + PHASES])
    for name in ("collate_ms.train", "forward_ms.train", "backward_ms.train", "clip_ms.train"):
        assert common.metric_reader(name)({}) is None
    assert common.metric_reader("step_host_ms.train")({}) == pytest.approx(140.0)
