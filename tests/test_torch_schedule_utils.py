"""The port's copies of utils/schedule_utils.py and
utils/training_consistency.py against the TPU package's originals.

The cases of tests/test_schedule_utils.py run on both packages' default
configs with the same settings: the resolved fractions, the conflicts, the
LR scaling (through a frozen config too), the summary text and the schedule
plot must be the same (exactly: the same arithmetic), and so must the
pre-flight consistency problems and the runtime checker's violations.
"""

import os

import pytest

import linnaeus_tpu.utils.schedule_utils as jsu
import linnaeus_tpu.utils.training_consistency as jtc
import linnaeus_tpu_torch.utils.schedule_utils as tsu
import linnaeus_tpu_torch.utils.training_consistency as ttc
from linnaeus_tpu.configuration import get_default_config as j_default
from linnaeus_tpu_torch.configuration import get_default_config as t_default

SIDES = {"jax": (j_default, jsu, jtc), "torch": (t_default, tsu, ttc)}


def _config(side, **overrides):
    cfg = SIDES[side][0]()
    for dotted, value in overrides.items():
        node = cfg
        parts = dotted.split(".")
        for p in parts[:-1]:
            node = node[p]
        node[parts[-1]] = value
    return cfg


def fractions_resolve(side):
    cfg = _config(side, **{"SCHEDULE.META_MASKING.END_STEPS": 0,
                           "SCHEDULE.META_MASKING.END_FRACTION": 0.25,
                           "SCHEDULE.NULL_MASKING.END_STEPS": 0,
                           "SCHEDULE.NULL_MASKING.END_FRACTION": 0.5,
                           "SCHEDULE.CHECKPOINT.INTERVAL_FRACTION": 0.1,
                           "LR_SCHEDULER.WARMUP_STEPS": 0,
                           "LR_SCHEDULER.WARMUP_FRACTION": 0.1})
    cfg.freeze()
    SIDES[side][1].resolve_all_schedule_params(cfg, total_steps=1000)
    assert cfg.is_frozen()
    return (cfg.SCHEDULE.META_MASKING.END_STEPS, cfg.SCHEDULE.META_MASKING.END_FRACTION,
            cfg.SCHEDULE.NULL_MASKING.END_STEPS, cfg.SCHEDULE.CHECKPOINT.INTERVAL_STEPS,
            cfg.LR_SCHEDULER.WARMUP_STEPS, cfg.LR_SCHEDULER.TOTAL_STEPS)


def conflicts(side):
    cfg = _config(side, **{"SCHEDULE.MIX.PROB.END_STEPS": 100,
                           "SCHEDULE.MIX.PROB.END_FRACTION": 0.5,
                           "LR_SCHEDULER.WARMUP_STEPS": 10,
                           "LR_SCHEDULER.WARMUP_FRACTION": 0.1})
    return SIDES[side][1].validate_schedule_config(cfg), SIDES[side][1].validate_schedule_config(
        _config(side))


@pytest.mark.parametrize("frozen", [False, True])
def test_lr_scaling_writes_base_lr(frozen):
    out = {}
    for side in SIDES:
        cfg = _config(side)
        if frozen:
            cfg.freeze()
        scaled = SIDES[side][1].apply_lr_scaling(cfg, effective_batch_size=1024)
        assert cfg.is_frozen() is frozen
        out[side] = (scaled, cfg.LR_SCHEDULER.BASE_LR, cfg.LR_SCHEDULER.LR_SCALING_FACTOR)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == pytest.approx(1e-4 * 2)


def summary(side):
    cfg = _config(side, **{"SCHEDULE.META_MASKING.PARTIAL.ENABLED": True,
                           "SCHEDULE.NULL_MASKING.ENABLED": True})
    SIDES[side][1].resolve_all_schedule_params(cfg, 1000)
    return SIDES[side][1].schedule_summary(cfg, 1000, 100)


def consistency(side):
    cfg = _config(side, **{"LR_SCHEDULER.WARMUP_STEPS": 50, "LR_SCHEDULER.MIN_LR": 1.0,
                           "SCHEDULE.META_MASKING.END_STEPS": 500,
                           "LOSS.GRAD_WEIGHTING.TASK.UPDATE_INTERVAL": 200,
                           "TRAIN.ACCUMULATION_STEPS": 3, "DATA.SAMPLER.TYPE": "standard"})
    tc = SIDES[side][2]
    problems = tc.validate_training_schedule(cfg, total_steps=40, steps_per_epoch=0)
    checker = tc.TrainingConsistencyChecker(cfg, 40)
    checker.check_step(1, loss=1.0)
    checker.check_step(1, loss=float("nan"))
    checker.check_epoch_boundary(0, 0, 10)
    checker.check_epoch_boundary(1, 5, 10)
    checker.check_epoch_boundary(2, 10, 10)
    return problems, checker.violations


@pytest.mark.parametrize("case", [fractions_resolve, conflicts, summary, consistency],
                         ids=lambda f: f.__name__)
def test_copy_matches_the_original(case):
    assert case("torch") == case("jax")


def test_generate_schedule_plot(tmp_path):
    cfg = t_default()
    tsu.resolve_all_schedule_params(cfg, 1000)
    out = tsu.generate_schedule_plot(cfg, 1000, str(tmp_path / "sched.png"))
    assert out is not None and os.path.getsize(out) > 1000
