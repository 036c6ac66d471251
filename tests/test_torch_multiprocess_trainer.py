"""The port's Trainer on two ranks against the same Trainer on one.

Two epochs of tests/test_trainer_e2e.py's config (B = 8, GradNorm every 2
steps, mixing and metadata masking on, float32) through the Trainer in one
process, and in two gloo processes (each reads and decodes
its 4 rows of every host batch, tests/test_torch_ranks.py::run_ranks):
every step's loss, per-task losses and gradient norms, the validation
summaries and the parameters agree within tests/test_torch_train_step.py's bars (loss 1e-4, norms
1e-3 relative, parameters 2e-5 where the gradient is no float noise; the
validation metrics 1e-4).
The one-process Trainer is held against the JAX Trainer by
tests/test_torch_trainer.py, so this holds the ranks to JAX's global-batch
semantics.

Checkpoints cross world sizes, as tests/test_parallel.py has JAX's do: the
two-rank run's epoch-1 checkpoint resumes in one process, and the one-process
run's in two processes under 'fsdp' (the whole state sharded on load) and
under 'tp' on a (data 1, model 2) mesh (each rank cuts its share of the
split leaves, and gathers them whole into its last checkpoint); each
resumed epoch 2 equals the one-process run resumed from its own checkpoint
within the same bars.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest
import torch

from linnaeus_tpu_torch.configuration import get_default_config as t_default
from linnaeus_tpu_torch.configuration.utils import setup_output_dirs
from linnaeus_tpu_torch.train.loop import Trainer
from tests.test_torch_ranks import run_ranks
from tests.test_trainer_e2e import data_dir, make_config  # noqa: F401  (data_dir: a fixture)

LOSS_ATOL, NORM_RTOL, PARAM_ATOL = 1e-4, 1e-3, 2e-5


def _config(data_dir, out, epochs):  # noqa: F811
    cfg = t_default()
    cfg.merge_from_other_cfg(make_config(data_dir, out, epochs=epochs))
    cfg.TRAIN.AMP_OPT_LEVEL = "O0"
    cfg.SCHEDULE.METRICS.CONSOLE_INTERVAL = 1
    cfg.SCHEDULE.METRICS.WANDB_INTERVAL = 1
    cfg.SCHEDULE.CHECKPOINT.KEEP_LAST_N = 3
    return setup_output_dirs(cfg)


def _rows(cfg):
    rows = {}
    with open(os.path.join(cfg.ENV.OUTPUT.DIRS.LOGS, "metrics.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            if "train/loss" in row:
                rows[row["step"]] = row
    return rows


def _whole(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().clone()


def _train(cfg):
    trainer = Trainer(cfg, device="cpu")
    try:
        trainer.train()
    finally:
        trainer.close()
    from linnaeus_tpu_torch.parallel.model import whole, whole_state_dict

    params = whole_state_dict(trainer.model)
    mu = {}
    for n, p in trainer.model.named_parameters():
        m = trainer.state.optimizer.state[p]["exp_avg"]
        mu[n] = whole(m, p.share) if getattr(p, "share", None) is not None else _whole(m)
    return {"rows": _rows(cfg) if trainer.is_main else None, "params": params, "mu": mu,
            "val": trainer.metrics.phase_summary("val"), "step": trainer.state.step}


def trainer_body(rank, world, out):
    """Three Trainers in turn: two epochs from scratch, then epoch 2 resumed
    from the one-rank run's epoch-1 checkpoint under 'fsdp', and on a
    (data 1, model 2) mesh under 'tp'."""
    torch.set_num_threads(1)
    res = {}
    for name in ("fresh", "resume_fsdp", "resume_tp"):
        cfg = t_default()
        cfg.merge_from_file(os.path.join(out, "..", f"{name}.yaml"))
        res[name] = _train(cfg)
    return res


def _dump(cfg, path):
    with open(path, "w") as f:
        f.write(cfg.dump())


def _close(got, want):
    for step, w in want.items():
        g = got[step]
        for key in [k for k in w if k.startswith("train/loss")]:
            assert abs(g[key] - w[key]) <= LOSS_ATOL, (step, key, g[key], w[key])
        for key in ("train/grad_norm_pre_clip", "train/grad_norm_post_clip"):
            assert abs(g[key] - w[key]) <= NORM_RTOL * abs(w[key]), (step, key, g[key], w[key])


def _params_close(got, want):
    """The parameters within 2e-5 where the gradient is no float noise (Adam's
    first moment at least 1e-7, as in tests/test_torch_train_step.py: the
    bias before a LayerNorm gets a gradient of rounding alone, which AdamW
    normalises to a full step of either sign)."""
    for key, value in want["params"].items():
        real = want["mu"][key].abs() >= 1e-7 if key in want["mu"] else torch.ones_like(
            value, dtype=torch.bool)
        np.testing.assert_allclose(got["params"][key][real].numpy(), value[real].numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=key)


def test_two_rank_epochs_and_checkpoints_across_world_sizes(data_dir, tmp_path):  # noqa: F811
    # one process, two epochs straight; its epoch-1 checkpoint kept aside
    one = _config(data_dir, tmp_path / "one", epochs=2)
    straight = _train(one)
    ckpts = sorted(os.listdir(one.ENV.OUTPUT.DIRS.CHECKPOINTS))
    epoch1 = [c for c in ckpts if c.startswith("checkpoint_step")][0]
    steps_per_epoch = straight["step"] // 2
    assert epoch1 == f"checkpoint_step_{steps_per_epoch:010d}"

    fresh = _config(data_dir, tmp_path / "two", epochs=2)
    resume = _config(data_dir, tmp_path / "two_resume", epochs=2)
    resume.PARALLEL.PARAM_SHARDING = "fsdp"
    os.makedirs(resume.ENV.OUTPUT.DIRS.CHECKPOINTS, exist_ok=True)
    shutil.copytree(os.path.join(one.ENV.OUTPUT.DIRS.CHECKPOINTS, epoch1),
                    os.path.join(resume.ENV.OUTPUT.DIRS.CHECKPOINTS, epoch1))
    resume_tp = _config(data_dir, tmp_path / "two_tp", epochs=2)
    resume_tp.PARALLEL.PARAM_SHARDING = "tp"
    resume_tp.PARALLEL.MESH.MODEL = 2
    shutil.copytree(os.path.join(one.ENV.OUTPUT.DIRS.CHECKPOINTS, epoch1),
                    os.path.join(resume_tp.ENV.OUTPUT.DIRS.CHECKPOINTS, epoch1))
    _dump(fresh, tmp_path / "fresh.yaml")
    _dump(resume, tmp_path / "resume_fsdp.yaml")
    _dump(resume_tp, tmp_path / "resume_tp.yaml")
    ranks = run_ranks(__file__, "trainer_body", 2, tmp_path, timeout=240)

    # two ranks, two epochs: the one-process run, step by step
    two = ranks[0]["fresh"]
    assert sorted(two["rows"]) == sorted(straight["rows"]) and len(two["rows"]) >= 6
    _close(two["rows"], straight["rows"])
    _params_close(two, straight)
    assert ranks[1]["fresh"]["rows"] is None  # rank 1 writes no metrics
    for key in ranks[0]["fresh"]["params"]:
        assert torch.equal(ranks[0]["fresh"]["params"][key], ranks[1]["fresh"]["params"][key])

    # the two-rank epoch-1 checkpoint resumes in one process for epoch 2
    back = _config(data_dir, tmp_path / "back", epochs=2)
    shutil.copytree(os.path.join(fresh.ENV.OUTPUT.DIRS.CHECKPOINTS, epoch1),
                    os.path.join(back.ENV.OUTPUT.DIRS.CHECKPOINTS, epoch1))
    resumed = _train(back)
    # against the one-process run resumed from its own epoch-1 checkpoint (a
    # resumed epoch is not the straight run's: the Trainer's resume, in JAX
    # as here, is held to itself)
    again = _config(data_dir, tmp_path / "again", epochs=2)
    shutil.copytree(os.path.join(one.ENV.OUTPUT.DIRS.CHECKPOINTS, epoch1),
                    os.path.join(again.ENV.OUTPUT.DIRS.CHECKPOINTS, epoch1))
    reference = _train(again)
    rows2 = {s: r for s, r in reference["rows"].items() if s > steps_per_epoch}
    assert len(rows2) >= steps_per_epoch
    _close({s: r for s, r in resumed["rows"].items() if s > steps_per_epoch}, rows2)
    _params_close(resumed, reference)

    # the one-process epoch-1 checkpoint resumes on two ranks under FSDP
    fsdp = ranks[0]["resume_fsdp"]
    assert fsdp["step"] == reference["step"]
    _close({s: r for s, r in fsdp["rows"].items() if s > steps_per_epoch}, rows2)
    _params_close(fsdp, reference)
    for key, value in reference["val"].items():
        assert abs(fsdp["val"][key] - value) <= LOSS_ATOL, (key, fsdp["val"][key], value)
        assert abs(resumed["val"][key] - value) <= LOSS_ATOL, key

    # and under 'tp' (each rank a share of the split leaves): the same epoch,
    # and a last checkpoint written whole in the one-process layout
    tp = ranks[0]["resume_tp"]
    _close({s: r for s, r in tp["rows"].items() if s > steps_per_epoch}, rows2)
    _params_close(tp, reference)
    last = sorted(c for c in os.listdir(resume_tp.ENV.OUTPUT.DIRS.CHECKPOINTS)
                  if c.startswith("checkpoint_step"))[-1]
    saved = torch.load(os.path.join(resume_tp.ENV.OUTPUT.DIRS.CHECKPOINTS, last, "state",
                                    "state.pt"), weights_only=True)["model"]
    assert saved.keys() == reference["params"].keys()
    _params_close({"params": saved}, reference)
