"""The check comes out false when the timed path is broken underneath the
harness: each fault the cells can have, planted in the program at a tiny
geometry on the CPU, the rest of a run driven as it is (the harness's look
for a card is the only part left out). The cells run on one card, so no
exchange between cards can be left out."""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate, run
from benchmark.tests.tiny import BENCH, SEED, tiny

TRAIN = [w["name"] for w in BENCH["workloads"]]


def run_tiny(cell):
    return run.run_cell(BENCH, cell, SEED, 0.5, False, torch.device("cpu"), adjust=tiny)


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(cell, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    result = run_tiny(cell)
    assert result["correct"] is False
    assert result["checks"]["change_leaf_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_left_out_is_not_correct(cell, monkeypatch):
    import linnaeus_tpu_torch.train.build as build

    real = build.make_train_step

    def halving(*args, **kwargs):
        step = real(*args, **kwargs)

        def half(v):
            return {k: half(x) for k, x in v.items()} if isinstance(v, dict) \
                else v[:v.shape[0] // 2]

        def broken(state, batch, scalars, draws=None):
            return step(state, half(batch), scalars, draws)

        broken.collated = step.collated
        return broken

    monkeypatch.setattr(build, "make_train_step", halving)
    result = run_tiny(cell)
    assert result["correct"] is False
    assert result["checks"]["change_median_gap"]["value"] > \
        result["checks"]["change_median_gap"]["limit"]


@pytest.mark.parametrize("factor", [0.0, 0.5])
@pytest.mark.parametrize("cell", TRAIN)
def test_a_clip_removed_or_mis_scaled_is_not_correct(cell, factor):
    """The tiny geometry's gradients exceed the clip's limit, as the cell's do."""
    sound = run_tiny(cell)
    assert sound["correct"] is True, sound["checks"]
    assert sound["checks"]["clip_norm_gap"]["value"] <= sound["checks"]["clip_norm_gap"]["limit"]
    with calibrate.planted_clip(factor):
        result = run_tiny(cell)
    assert result["correct"] is False
    assert result["checks"]["clip_norm_gap"]["value"] > \
        result["checks"]["clip_norm_gap"]["limit"]
