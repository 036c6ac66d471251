"""The port's metrics/ against the TPU package's.

``MetricsTracker`` and ``StepMetricsLogger`` are copies and
``chain_accuracy_counts`` a torch port: the cases of tests/test_metrics.py
run on both and must observe the same (exactly: counts are integers, the
meters the same float arithmetic), chain accuracy on seeded logits with
null labels, integer and one-hot targets, with and without ``ignore_null``.
"""

import json
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linnaeus_tpu.metrics as jm
import linnaeus_tpu.metrics.step_logger as jsl
import linnaeus_tpu.ops_schedule as jos
import linnaeus_tpu_torch.metrics as tm
import linnaeus_tpu_torch.metrics.step_logger as tsl
import linnaeus_tpu_torch.ops_schedule as tos
from linnaeus_tpu.configuration import get_default_config as j_default
from linnaeus_tpu_torch.configuration import get_default_config as t_default

SIDES = {"jax": (jm, jsl, jos, j_default), "torch": (tm, tsl, tos, t_default)}


def meters(side):
    m = SIDES[side][0].AverageMeter()
    m.update(1.0, n=2)
    m.update(4.0, n=1)
    return m.val, m.sum, m.count, m.avg


def tracker_best(side):
    tr = SIDES[side][0].MetricsTracker(["t1"], primary_metric="loss")
    seen = []
    for epoch, loss in enumerate((1.0, 0.5, 0.9)):
        tr.reset_phase("val")
        tr.update("val", {"loss": loss, "skip": "text"})
        seen.append(tr.check_best("val", epoch=epoch))
    tr.update_counts("val", 3.0, 4.0, "acc")
    return seen, tr.best, tr.phase_summary("val"), tr.partial_mask_phase(["temporal", "SPATIAL"])


def tracker_roundtrip(side):
    mod = SIDES[side][0]
    tr = mod.MetricsTracker(["t1"])
    tr.update("train", {"loss": 2.0}, n=3)
    tr.log_lr(10, 1e-4)
    tr.log_schedule_value("mix_prob", 10, 0.5)
    tr.log_gradnorm(10, {"gradnorm/avg_norm": np.float32(1.5),
                         "gradnorm/weights": np.array([0.5, 1.5], np.float32)})
    state = json.loads(json.dumps(tr.state_dict()))
    tr2 = mod.MetricsTracker(["t1"])
    tr2.load_state_dict(state)
    return tr2.state_dict(), tr2.get("train", "loss")


def step_logger(side, tmp_path):
    mod, sl, os_mod, default = SIDES[side]
    cfg = default()
    cfg.SCHEDULE.METRICS.PIPELINE_INTERVAL = 100
    sched = os_mod.OpsSchedule(cfg, os_mod.TrainingProgress(expected_total_steps=100))
    tracker = mod.MetricsTracker(["t1"])
    path = str(tmp_path / f"{side}.jsonl")
    logger = mod.StepMetricsLogger(cfg, sched, tracker, wandb_run=None, jsonl_path=path)
    logger.start_epoch(10)
    for step in (50, 99, 100):
        logger.log_step_metrics(step, epoch=0, metrics={"loss": 1.25 + step,
                                                        "acc1/t1": 0.5}, lr=1e-4)
        logger.log_schedule_values(step, {"mix_prob": 0.5})
        logger.log_pipeline_metrics(step, {"throughput_samples_per_sec": 100.0,
                                           "cache": {"hits": 3, "hit_rate": 0.5}})
    logger.log_validation(100, "val", {"loss": 0.9, "acc1/t1": 0.5})
    lines = [json.loads(line) for line in open(path)]
    return lines, tracker.state_dict()


def test_tracker_and_logger_copies_match(tmp_path):
    for case in (meters, tracker_best, tracker_roundtrip):
        assert case("torch") == case("jax"), case.__name__
    assert step_logger("torch", tmp_path) == step_logger("jax", tmp_path)


@pytest.mark.parametrize("ignore_null", [True, False])
@pytest.mark.parametrize("one_hot", [False, True])
def test_chain_accuracy_matches_jax(ignore_null, one_hot):
    rng = np.random.default_rng(3)
    widths = {"t1": 5, "t2": 3, "t3": 2}
    outputs = {t: rng.normal(size=(64, n)).astype(np.float32) for t, n in widths.items()}
    labels = {t: rng.integers(0, n, 64) for t, n in widths.items()}
    # make a third of the samples right everywhere so the count is not 0
    for t in widths:
        labels[t][:20] = outputs[t][:20].argmax(-1)
    labels["t1"][60:] = labels["t2"][60:] = labels["t3"][60:] = 0
    targets = {t: (np.eye(widths[t], dtype=np.float32)[v] if one_hot else v)
               for t, v in labels.items()}
    keys = tuple(widths)
    jc, jt = jm.chain_accuracy_counts({t: jnp.asarray(v) for t, v in outputs.items()},
                                      {t: jnp.asarray(v) for t, v in targets.items()}, keys,
                                      ignore_null=ignore_null)
    tc, tt = tm.chain_accuracy_counts({t: torch.tensor(v) for t, v in outputs.items()},
                                      {t: torch.tensor(v) for t, v in targets.items()}, keys,
                                      ignore_null=ignore_null)
    assert (int(tc), int(tt)) == (int(jc), int(jt))
    assert int(tc) >= 20


def test_initialize_wandb_resume_policy(monkeypatch):
    """The copied wandb start: an explicit EXPERIMENT.WANDB.RESUME wins over
    the 'allow' a detected run id picks; both packages pass wandb.init the
    same arguments but for the config dump."""
    calls = {"jax": [], "torch": []}
    for side, (_, sl, _, default) in SIDES.items():
        fake = types.ModuleType("wandb")
        fake.init = lambda **kw: calls[side].append(
            {k: v for k, v in kw.items() if k != "config"}) or object()
        monkeypatch.setitem(sys.modules, "wandb", fake)
        cfg = default()
        assert sl.initialize_wandb(cfg) is None  # off by default
        cfg.EXPERIMENT.WANDB.ENABLED = True
        sl.initialize_wandb(cfg, resume_run_id="abc")
        cfg.EXPERIMENT.WANDB.RESUME = "must"
        cfg.TRAIN.ALLOW_WANDB_VAL_CHANGE = False
        sl.initialize_wandb(cfg, resume_run_id="abc")
    assert calls["torch"] == calls["jax"]
    assert calls["torch"][0]["resume"] == "allow" and calls["torch"][1]["resume"] == "must"
