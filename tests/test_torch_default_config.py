"""The step built from the default config, under every optimizer and
schedule the config can name.

``tools/train_bench.build_step(config=...)`` on the port's copy of the
default config with mFormerV1_sm's arch cut to a tiny width and depth, at
32 px on the CPU: AutoAugment, colour jitter and random erasing on, remat
'dots' on normal and GradNorm steps, GradNorm's update every 2 steps, the
heads in a parameter group at 10x the rate. Two steps of each of AdamW,
SGD, Muon and AdEMAMix under each of the cosine, linear, step and wsd
schedules (the numbers themselves are held against JAX in
tests/test_torch_optim.py, test_torch_schedules.py and
test_torch_gradnorm.py).
"""

import numpy as np
import pytest
import torch

from linnaeus_tpu_torch import configuration as tconf
from linnaeus_tpu_torch.configuration.archs import apply_arch
from linnaeus_tpu_torch.tools import train_bench

TASKS = ("taxa_L10", "taxa_L20")
NC = {"taxa_L10": 7, "taxa_L20": 3}


OPTIMIZERS = ("adamw", "sgd", "muon", "ademamix")
SCHEDULES = ("cosine", "linear", "step", "wsd")


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_default_config_trains(optimizer, schedule):
    """A step built from the default config (GradNorm every 2 steps,
    AutoAugment, jitter, erasing, remat 'dots' for both kinds of step), the
    heads in a parameter group at 10x the rate, under each optimizer and
    schedule the config can name, trains: finite losses, the clip holds,
    the task weights move and sum to the task count, the heads' rate is 10x."""
    cfg = tconf.get_default_config()
    apply_arch(cfg, "mFormerV1_sm")
    cfg.defrost()
    cfg.merge_from_other_cfg({
        "DATA": {"TASK_KEYS_H5": list(TASKS)},
        "MODEL": {"IMG_SIZE": 32, "CONVNEXT_STAGES": {"DEPTHS": [1, 1, 1, 1],
                                                      "DIMS": [8, 16, 32, 64]},
                  "ROPE_STAGES": {"DEPTHS": [1, 1], "DIMS": [32, 64], "NUM_HEADS": [2, 2]}},
        "LOSS": {"GRAD_WEIGHTING": {"TASK": {"UPDATE_INTERVAL": 2}}},
        "OPTIMIZER": {"NAME": optimizer, "PARAMETER_GROUPS": {
            "ENABLED": True, "HEADS": {"FILTER": {"TYPE": "name", "PATTERNS": ["head_"]},
                                       "LR_MULTIPLIER": 10.0}}},
        "LR_SCHEDULER": {"NAME": schedule, "WARMUP_FRACTION": 0.05, "BASE_LR": 1e-3,
                         "WARMUP_LR": 1e-4},
    })
    cfg.OPTIMIZER.PARAMETER_GROUPS.DEFAULT.OPTIMIZER = optimizer
    run, state = train_bench.build_step(4, config=cfg, num_classes=NC, device="cpu")
    assert state.model.gradient_checkpointing and state.model.remat_policy == "dots"
    assert run.augment is not None and run.gradnorm_step is not None
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    history = [run() for _ in range(2)]
    assert "gradnorm" in history[1] and "gradnorm" not in history[0]
    for m in history:
        assert np.isfinite(float(m["loss"])) and float(m["grad_norm_post_clip"]) <= 5.0 + 1e-4
    w = state.gradnorm.task_weights
    assert (w > 0).all() and abs(float(w.sum()) - len(TASKS)) < 1e-5 and not torch.equal(
        w, torch.ones_like(w))
    rates = {g["label"]: g["lr"] / g["lr_multiplier"] for g in state.optimizer.param_groups}
    heads = [g["lr"] for g in state.optimizer.param_groups if g["label"] == "HEADS"]
    default = [g["lr"] for g in state.optimizer.param_groups if g["label"] == "default"]
    assert heads and default and heads[0] == pytest.approx(10 * default[0])
    assert rates["HEADS"] == pytest.approx(rates["default"])
    # a step of plain SGD at the warm-up's rate is lost in float32 beside a
    # weight where the gradient is small (behind the 1e-6 layer scales)
    moved = sum(not torch.equal(before[n], p.detach())
                for n, p in state.model.named_parameters())
    assert moved > 0.5 * len(before)


def test_host_augmentation_path_raises_by_name():
    """AUG.SINGLE_AUG_DEVICE 'cpu' (the loader's host path) comes with the
    data feed; until then the config-built step says so."""
    cfg = tconf.get_default_config()
    apply_arch(cfg, "mFormerV1_sm")
    cfg.defrost()
    cfg.merge_from_other_cfg({"DATA": {"TASK_KEYS_H5": list(TASKS)}, "MODEL": {"IMG_SIZE": 32},
                              "AUG": {"SINGLE_AUG_DEVICE": "cpu"}})
    with pytest.raises(NotImplementedError, match="SINGLE_AUG_DEVICE"):
        train_bench.build_step(2, config=cfg, num_classes=NC, device="cpu")
