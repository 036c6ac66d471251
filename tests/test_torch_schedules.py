"""The port's learning-rate schedules against the TPU package's optax ones.

Every schedule (cosine, linear, step, wsd with cosine and linear decay),
each with and without a linear warm-up, the warm-up forms (WARMUP_FRACTION
over WARMUP_EPOCHS over WARMUP_STEPS), the step schedule's DECAY_FRACTION,
and the per-group schedules (LR_SCHEDULER.PARAMETER_GROUPS, a group
BASE_LR scaled by LR_SCALING_FACTOR) are evaluated at every step of the run
and 20 past its end, to 1e-6 relative (optax computes in float32, the port
in Python floats) plus one float32 step of the base rate (2**-23 x 1e-3)
absolute, which an early warm-up value loses to cancellation in optax.
"""

import numpy as np
import pytest

from linnaeus_tpu import configuration as jconf
from linnaeus_tpu.optim import schedules as j_sched
from linnaeus_tpu_torch import configuration as tconf
from linnaeus_tpu_torch.optim import schedules as t_sched

TOTAL = 120
RTOL, ATOL = 1e-6, 1e-3 * 2**-23


def _close(got, want, total=TOTAL):
    for step in range(total + 20):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=RTOL, atol=ATOL,
                                   err_msg=f"step {step}")


def _configs(**lr):
    out = []
    for conf in (tconf, jconf):
        cfg = conf.get_default_config()
        cfg.defrost()
        cfg.LR_SCHEDULER.BASE_LR, cfg.LR_SCHEDULER.MIN_LR = 1e-3, 1e-5
        cfg.LR_SCHEDULER.WARMUP_LR = 1e-6
        for k, v in lr.items():
            cfg.LR_SCHEDULER[k] = v
        out.append(cfg)
    return out


@pytest.mark.parametrize("warmup", [0, 15])
@pytest.mark.parametrize("name", ["cosine", "linear"])
def test_cosine_and_linear(name, warmup):
    fn = {"cosine": "cosine_schedule", "linear": "linear_schedule"}[name]
    _close(getattr(t_sched, fn)(1e-3, 1e-5, TOTAL, warmup, 1e-6),
           getattr(j_sched, fn)(1e-3, 1e-5, TOTAL, warmup, 1e-6))


@pytest.mark.parametrize("warmup", [0, 10])
@pytest.mark.parametrize("decay_steps", [1, 25, 1000])
def test_step(decay_steps, warmup):
    _close(t_sched.step_schedule(1e-3, decay_steps, 0.5, TOTAL, warmup, 1e-6),
           j_sched.step_schedule(1e-3, decay_steps, 0.5, TOTAL, warmup, 1e-6))


@pytest.mark.parametrize("warmup", [0, 12])
@pytest.mark.parametrize("decay_type", ["cosine", "linear"])
@pytest.mark.parametrize("fractions", [(0.8, 0.1), (0.5, 0.5), (0.0, 0.3)])
def test_wsd(fractions, decay_type, warmup):
    kw = dict(stable_fraction=fractions[0], decay_fraction=fractions[1], decay_type=decay_type)
    _close(t_sched.wsd_schedule(1e-3, 1e-5, TOTAL, warmup, 1e-6, **kw),
           j_sched.wsd_schedule(1e-3, 1e-5, TOTAL, warmup, 1e-6, **kw))


@pytest.mark.parametrize("lr", [
    {"NAME": "cosine", "WARMUP_FRACTION": 0.1, "WARMUP_EPOCHS": 3, "WARMUP_STEPS": 7},
    {"NAME": "linear", "WARMUP_FRACTION": None, "WARMUP_EPOCHS": 0.5, "WARMUP_STEPS": 7},
    {"NAME": "step", "WARMUP_STEPS": 9, "DECAY_STEPS": 30, "DECAY_RATE": 0.3},
    {"NAME": "step", "DECAY_FRACTION": 0.25, "DECAY_RATE": 0.1},
    {"NAME": "wsd", "WARMUP_FRACTION": 0.05, "STABLE_DURATION_FRACTION": 0.6,
     "DECAY_DURATION_FRACTION": 0.3, "DECAY_TYPE": "linear"},
], ids=["cosine_fraction", "linear_epochs", "step_steps", "step_fraction", "wsd"])
def test_build_schedule_from_config(lr):
    tcfg, jcfg = _configs(**lr)
    assert (t_sched.resolve_warmup_steps(tcfg, TOTAL, 20)
            == j_sched.resolve_warmup_steps(jcfg, TOTAL, 20))
    _close(t_sched.build_schedule(tcfg, TOTAL, 20), j_sched.build_schedule(jcfg, TOTAL, 20))


def test_group_schedules():
    tcfg, jcfg = _configs(NAME="cosine", WARMUP_STEPS=10, LR_SCALING_FACTOR=2.0)
    for cfg in (tcfg, jcfg):
        cfg.OPTIMIZER.PARAMETER_GROUPS.ENABLED = True
        cfg.OPTIMIZER.PARAMETER_GROUPS.HEADS = {
            "FILTER": {"TYPE": "name", "PATTERNS": ["head_"]}, "LR_MULTIPLIER": 10.0}
        cfg.OPTIMIZER.PARAMETER_GROUPS.NORMS = {
            "FILTER": {"TYPE": "dimension", "MAX_NDIM": 1}}
        cfg.LR_SCHEDULER.PARAMETER_GROUPS.ENABLED = True
        cfg.LR_SCHEDULER.PARAMETER_GROUPS.HEADS = {"NAME": "wsd", "BASE_LR": 3e-4,
                                                   "WARMUP_STEPS": 0}
        cfg.LR_SCHEDULER.PARAMETER_GROUPS.NORMS = {"NAME": "step", "DECAY_STEPS": 40}
    got = t_sched.build_group_schedules(tcfg, TOTAL)
    want = j_sched.build_group_schedules(jcfg, TOTAL)
    assert set(got) == set(want) == {"default", "HEADS", "NORMS"}
    for g in got:
        _close(got[g], want[g])
    assert got["HEADS"](0) == pytest.approx(6e-4)  # the group BASE_LR, scaled by 2


def test_unknown_schedule_raises():
    tcfg, _ = _configs(NAME="triangle")
    with pytest.raises(ValueError, match="triangle"):
        t_sched.build_schedule(tcfg, TOTAL)
