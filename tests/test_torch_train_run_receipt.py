"""The port's receipt tool against the TPU package's, on a run of the port's CLI.

A tiny mFormerV1 (the DIMS of tests/test_parity_reference.py:39-42 widened
to four stages) trains two epochs through ``python -m
linnaeus_tpu_torch.train.main --device cpu`` on a tiny hybrid dataset of
``tools/e2e_train_bench.py::generate_dataset`` (32 px JPEGs, ``.npz``
labels, four ranks of a few classes with nulls). The receipt that
``linnaeus_tpu_torch/tools/train_run_receipt.py`` distils from the run
directory must equal the one ``linnaeus_tpu/tools/train_run_receipt.py``
distils from it (on this machine both name the device "cpu"), and it must
carry the loss curve, the epochs, the validation passes, the checkpoint
saves and ``model_params``: the Trainer's log lines are worded as the JAX
Trainer's, which the regexes read. ``tiny_phase1`` is shared with
tests/test_torch_rl.py.
"""

import atexit
import contextlib
import json
import os
import signal
import sys

import pytest
import yaml

import linnaeus_tpu_torch.utils.hpc as thpc
from linnaeus_tpu.tools import train_run_receipt as jreceipt
from linnaeus_tpu_torch.tools import e2e_train_bench as tbench
from linnaeus_tpu_torch.tools import train_run_receipt as treceipt
from linnaeus_tpu_torch.train import main as tmain

TASKS = ["taxa_L10", "taxa_L20", "taxa_L30", "taxa_L40"]
IMG, BATCH, N_OBS, EPOCHS = 32, 8, 48, 2


def tiny_experiment(d: str, labels: str, images: str, name: str = "tiny") -> str:
    """The yaml of a tiny float32 mFormerV1 on the hybrid dataset: a 0.75
    split (4 train steps and 1 val batch an epoch), GradNorm every 2 steps,
    a checkpoint and both validation passes every epoch, metrics every step."""
    exp = {
        "EXPERIMENT": {"NAME": name, "PROJECT": "receipts", "GROUP": "tiny"},
        "ENV": {"OUTPUT": {"BASE_DIR": os.path.join(d, "out")}},
        "MODEL": {
            "TYPE": "mFormerV1", "NAME": "tiny", "IMG_SIZE": IMG, "DROP_PATH_RATE": 0.0,
            "CONVNEXT_STAGES": {"DEPTHS": [1, 1, 1, 1], "DIMS": [8, 16, 32, 64]},
            "ROPE_STAGES": {"DEPTHS": [1, 1], "DIMS": [32, 64], "NUM_HEADS": [2, 2],
                            "MLP_RATIO": [2.0, 2.0]},
        },
        "DATA": {
            "IMG_SIZE": IMG, "BATCH_SIZE": BATCH, "BATCH_SIZE_VAL": BATCH,
            "TASK_KEYS_H5": TASKS, "PARTIAL": {"LEVELS": True},
            "H5": {"LABELS_PATH": labels, "TRAIN_VAL_SPLIT_RATIO": 0.75},
            "HYBRID": {"USE_HYBRID": True, "IMAGES_DIR": images, "FILE_EXTENSION": ".jpg"},
            "SAMPLER": {"GROUPED_MODE": "mixed-pairs"},
            "PREFETCH": {"NUM_IO_THREADS": 2, "MEM_CACHE_SIZE": 0},
        },
        "AUG": {"AUTOAUG": {"POLICY": "", "COLOR_JITTER": 0.0}, "RANDOM_ERASE": {"PROB": 0.0}},
        "TRAIN": {"EPOCHS": EPOCHS, "AMP_OPT_LEVEL": "O0",
                  "MIXED_PRECISION": {"ENABLED": False},
                  "GRADIENT_CHECKPOINTING": {"ENABLED_NORMAL_STEPS": False}},
        "LOSS": {"GRAD_WEIGHTING": {"TASK": {"UPDATE_INTERVAL": 2}}},
        "LR_SCHEDULER": {"WARMUP_EPOCHS": 0, "WARMUP_STEPS": 1, "REFERENCE_BS": BATCH},
        "SCHEDULE": {
            "MIX": {"GROUP_LEVELS": ["taxa_L20"]},
            "VALIDATION": {"INTERVAL_EPOCHS": 1, "MASK_META_INTERVAL_EPOCHS": 1},
            "CHECKPOINT": {"INTERVAL_EPOCHS": 1},
            "METRICS": {"CONSOLE_INTERVAL": 1, "WANDB_INTERVAL": 1},
        },
    }
    path = os.path.join(d, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(exp, f)
    return path


@contextlib.contextmanager
def process_handlers_restored():
    """A fresh shutdown registry for the Trainer, as in a new process; on
    leaving, drain it (at exit it would log to a closed stream) and put back
    the signal handlers and excepthook the Trainer replaced (utils/hpc.py)."""
    signals = (signal.SIGINT, signal.SIGTERM, signal.SIGUSR1)
    handlers, excepthook = {sig: signal.getsignal(sig) for sig in signals}, sys.excepthook
    thpc._registry = None
    try:
        yield
    finally:
        registry = thpc.get_shutdown_registry()
        registry.drain()
        atexit.unregister(registry.drain)
        thpc._registry = None
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
        sys.excepthook = excepthook


def tiny_phase1(d: str, null_frac: float = 0.2) -> dict:
    """The hybrid dataset and two epochs of the port's CLI on it, in-process
    on the CPU; returns the paths."""
    labels, images = tbench.generate_dataset(os.path.join(d, "data"), N_OBS, IMG,
                                             learnable=True, null_frac=null_frac,
                                             species=5, hybrid=True)
    cfg = tiny_experiment(d, labels, images)
    with process_handlers_restored():
        trainer = tmain.main(["--cfg", cfg, "--device", "cpu"])
    return {"labels": labels, "images": images, "cfg": cfg,
            "run_dir": trainer.config.ENV.OUTPUT.DIRS.EXP_BASE,
            "ckpt_dir": trainer.ckpt_dir, "steps": trainer.progress.global_step,
            "steps_per_epoch": trainer.steps_per_epoch}


@pytest.fixture(scope="module")
def phase1(tmp_path_factory):
    return tiny_phase1(str(tmp_path_factory.mktemp("receipt")))


def test_receipt_of_a_port_run_equals_the_jax_tools(phase1, tmp_path):
    run_dir = phase1["run_dir"]
    got = treceipt.build_receipt(run_dir)
    want = jreceipt.build_receipt(run_dir)
    assert got == want
    out = tmp_path / "r.json"
    treceipt.main(["--run-dir", run_dir, "--out", str(out)])
    assert json.loads(out.read_text()) == got


def test_receipt_of_a_port_run_carries_every_field(phase1):
    r = treceipt.build_receipt(phase1["run_dir"])
    steps, spe = phase1["steps"], phase1["steps_per_epoch"]
    assert r["device"] == "cpu" and r["backend"] == "cpu"
    assert r["steps"] == steps == EPOCHS * spe and len(r["loss_curve"]) == steps
    assert r["loss_first"] == r["loss_curve"][0][1] and r["loss_last"] == r["loss_curve"][-1][1]
    assert r["model_params"] > 0
    assert [e["epoch"] for e in r["epochs"]] == list(range(EPOCHS))
    assert all(e["samples"] == spe * BATCH and e["img_per_sec"] > 0 for e in r["epochs"])
    assert r["img_per_sec_steady"] > 0
    phases = [(v["phase"], v["step"]) for v in r["validation"]]
    assert phases == [(p, (e + 1) * spe) for e in range(EPOCHS) for p in ("val", "val_mask_meta")]
    assert all("loss" in v for v in r["validation"])
    # one save an epoch and the final one after training (as the JAX Trainer)
    assert r["checkpoint_saves"] == EPOCHS + 1 and "resumes" not in r


def test_receipt_cli_writes_where_asked(phase1, tmp_path, capsys):
    out = tmp_path / "nested" / "receipt.json"
    treceipt.main(["--run-dir", phase1["run_dir"], "--out", str(out), "--max-curve-points", "3"])
    r = json.loads(out.read_text())
    assert len(r["loss_curve"]) <= 4 and r["loss_curve"][-1][0] == phase1["steps"]
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["out"] == str(out) and printed["validations"] == 2 * EPOCHS
