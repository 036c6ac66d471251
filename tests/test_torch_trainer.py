"""The port's Trainer and training CLI against the TPU package's.

(a) One epoch of the TPU package's ``Trainer`` and of the port's on the
tiny mFormerV1 of tests/test_trainer_e2e.py::make_config (HDF5 labels and
images, mixed-pairs batches at the genus level, HierarchicalSoftmax heads,
GradNorm every 2 steps), made deterministic (drop path 0, mixing and
metadata masking off, augmentation off), the port starting from the TPU
Trainer's initial parameters through ``utils/convert.py``. Both loaders
give the same batches (tests/test_torch_data_pipeline.py). Bars, float32:
per-step losses 1e-4, gradient norms 1e-3 relative, the validation summary
1e-4: those that tests/test_torch_train_step.py holds three steps to.

(b) The port alone, two epochs with GradNorm, remat 'dots' and AutoAugment
on: checkpoints, auto-resume, a validation pass interrupted and replayed
from its next batch, the preemption checkpoint (the cases of
tests/test_trainer_e2e.py:100, :271 and :369), early stop across a resume,
EMA evaluation, the subset metrics, the standalone validation API, and the
CLI itself in two processes (train, then resume).

(c) Every option the port does not run raises by name (AutoBatch on the
CPU, remote pretrained paths); the CLI without ``--device`` needs a card,
to train and to run ``--throughput``.

Each test has a time limit of its own (SIGALRM).
"""

import functools
import json
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

import linnaeus_tpu_torch.utils.hpc as thpc
from linnaeus_tpu.train.loop import Trainer as JTrainer
from linnaeus_tpu_torch.configuration import get_default_config as t_default
from linnaeus_tpu_torch.metrics.tracker import MetricsTracker
from linnaeus_tpu_torch.ops_schedule import TrainingStage
from linnaeus_tpu_torch.train import main as tmain
from linnaeus_tpu_torch.train.loop import Trainer
from linnaeus_tpu_torch.train.validation import validate_one_pass, validate_with_partial_mask
from linnaeus_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_trainer_e2e import data_dir, make_config  # noqa: F401  (data_dir: a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_ATOL, NORM_RTOL, VAL_ATOL = 1e-4, 1e-3, 1e-4


def time_limit(seconds: int):
    """Fail the test with TimeoutError once it has run ``seconds``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            def expire(signum, frame):
                raise TimeoutError(f"{fn.__name__} ran past {seconds} s")

            previous = signal.signal(signal.SIGALRM, expire)
            signal.alarm(seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, previous)
        return run
    return wrap


@pytest.fixture(autouse=True)
def fresh_registry():
    """A preempted shutdown registry would stop the next Trainer at once:
    each test gets a fresh one, as a new process would."""
    thpc._registry = None
    yield
    thpc._registry = None


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny model gains nothing from intra-op threads, and beside other
    test processes their spinning multiplies its time many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def deterministic(cfg):
    """make_config without its random draws: no mixing, no metadata
    masking (drop path is 0 and augmentation off there already), in
    float32 (with MIXED_PRECISION off, both packages read the legacy
    AMP_OPT_LEVEL, whose default 'O1' means bfloat16), every step's metrics
    logged."""
    cfg.SCHEDULE.MIX.PROB.ENABLED = False
    cfg.SCHEDULE.META_MASKING.ENABLED = False
    cfg.TRAIN.AMP_OPT_LEVEL = "O0"
    cfg.SCHEDULE.METRICS.CONSOLE_INTERVAL = 1
    cfg.SCHEDULE.METRICS.WANDB_INTERVAL = 1
    return cfg


def port_config(jcfg):
    """The port's copy of the default config with the same settings."""
    cfg = t_default()
    cfg.merge_from_other_cfg(jcfg)
    return cfg


def step_rows(log_dir):
    rows = {}
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            if "train/loss" in row:
                rows[row["step"]] = row
    return rows


@pytest.fixture(scope="module")
def jax_epoch(data_dir, tmp_path_factory):  # noqa: F811
    cfg = deterministic(make_config(data_dir, tmp_path_factory.mktemp("jax") / "out", epochs=1))
    trainer = JTrainer(cfg)
    params = jax.tree.map(np.asarray, jax.device_get(trainer.state.params))
    trainer.train()
    trainer.ckpt_writer.close()
    out = {
        "params": params, "rows": step_rows(cfg.ENV.OUTPUT.DIRS.LOGS),
        "val": trainer.metrics.phase_summary("val"),
        "val_mask_meta": trainer.metrics.phase_summary("val_mask_meta"),
        "weights": np.asarray(jax.device_get(trainer.state.gradnorm.task_weights)),
        "steps": trainer.progress.global_step,
    }
    trainer.train_loader.close()
    return out


@time_limit(300)
def test_one_epoch_matches_the_jax_trainer(jax_epoch, data_dir, tmp_path):  # noqa: F811
    jcfg = deterministic(make_config(data_dir, tmp_path / "out", epochs=1))
    trainer = Trainer(port_config(jcfg), device="cpu")
    trainer.model.load_state_dict(state_dict_from_jax(
        jax_epoch["params"], (1, 1, 1, 1), (1, 1), ("TEMPORAL", "SPATIAL"),
        trainer.task_keys), strict=True)
    trainer.train()
    trainer.close()
    got, want = step_rows(trainer.config.ENV.OUTPUT.DIRS.LOGS), jax_epoch["rows"]
    assert sorted(got) == sorted(want) == list(range(1, jax_epoch["steps"] + 1))
    assert jax_epoch["steps"] >= 3
    for step in want:
        g, w = got[step], want[step]
        for key in [k for k in w if k.startswith("train/loss")]:
            assert abs(g[key] - w[key]) <= LOSS_ATOL, (step, key, g[key], w[key])
        for key in ("train/grad_norm_pre_clip", "train/grad_norm_post_clip"):
            assert abs(g[key] - w[key]) <= NORM_RTOL * abs(w[key]), (step, key, g[key], w[key])
    np.testing.assert_allclose(trainer.state.gradnorm.task_weights.numpy(),
                               jax_epoch["weights"], rtol=NORM_RTOL)
    for phase in ("val", "val_mask_meta"):
        summary = trainer.metrics.phase_summary(phase)
        assert summary.keys() == jax_epoch[phase].keys()
        for key, value in jax_epoch[phase].items():
            assert abs(summary[key] - value) <= VAL_ATOL, (phase, key, summary[key], value)


def port_only(data_dir, out, epochs=2, **extra):  # noqa: F811
    """make_config with the default config's training options back on:
    GradNorm every 2 steps, remat 'dots' on normal and GradNorm steps,
    AutoAugment with jitter and erasing, mixing and metadata masking."""
    cfg = port_config(make_config(data_dir, out, epochs=epochs))
    cfg.TRAIN.GRADIENT_CHECKPOINTING.ENABLED_NORMAL_STEPS = True
    cfg.TRAIN.GRADIENT_CHECKPOINTING.ENABLED_GRADNORM_STEPS = True
    cfg.AUG.AUTOAUG.POLICY = "original"
    cfg.AUG.AUTOAUG.COLOR_JITTER = 0.4
    cfg.AUG.RANDOM_ERASE.PROB = 0.25
    for dotted, value in extra.items():
        node = cfg
        parts = dotted.split(".")
        for p in parts[:-1]:
            node = node[p]
        node[parts[-1]] = value
    return cfg


@time_limit(240)
def test_trainer_end_to_end_and_resume(data_dir, tmp_path):  # noqa: F811
    cfg = port_only(data_dir, tmp_path / "out", **{"SCHEDULE.CHECKPOINT.KEEP_LAST_N": 1,
                                                   "DEBUG.PROFILE.START_STEP": 1,
                                                   "DEBUG.PROFILE.END_STEP": 2})
    trainer = Trainer(cfg, device="cpu")
    assert trainer.model.gradient_checkpointing and trainer.model.remat_policy == "dots"
    trainer.train()
    trainer.close()
    assert trainer.progress.global_step == 2 * trainer.steps_per_epoch
    for key in ("loss", "acc1/taxa_L10", "chain_accuracy"):
        assert trainer.metrics.get(MetricsTracker.VAL, key) is not None
    assert trainer.metrics.get(MetricsTracker.VAL_MASK_META, "loss") is not None
    w = trainer.state.gradnorm.task_weights
    assert abs(float(w.sum()) - 2.0) < 1e-4 and trainer.metrics.gradnorm_history
    assert sum(t["gradnorm_updates"] for t in trainer.epoch_timings.values()) == (
        trainer.progress.global_step // 2)
    # retention keeps the last one
    assert os.listdir(cfg.ENV.OUTPUT.DIRS.CHECKPOINTS) == [
        f"checkpoint_step_{trainer.progress.global_step:010d}"]
    assets = os.listdir(cfg.ENV.OUTPUT.DIRS.ASSETS)
    assert "dataset_metadata.json" in assets and "taxonomy.json" in assets
    timing = trainer.epoch_timings[1]
    assert timing["steps"] == trainer.steps_per_epoch and timing["wall_s"] > 0
    assert timing["first_step"] == trainer.steps_per_epoch + 1 and timing["median_step_ms"] > 0
    # the profiled window wrote its trace; its device-busy share is the card's only
    assert os.path.exists(os.path.join(cfg.ENV.OUTPUT.DIRS.LOGS, "profile_steps_1_2.json"))
    assert trainer.profile_summary is None

    # a fresh trainer resumes the state bit for bit
    from linnaeus_tpu_torch.utils.checkpoint import snapshot_state

    again = Trainer(cfg, device="cpu")
    assert again.try_resume()
    assert again.progress.global_step == trainer.progress.global_step
    assert bool(again.config.LOADING_FROM_CHECKPOINT)
    assert again.config.TRAIN.START_EPOCH == again.progress.current_epoch
    saved, loaded = snapshot_state(trainer.state), snapshot_state(again.state)
    for name, value in saved["model"].items():
        assert torch.equal(value, loaded["model"][name]), name
    assert torch.equal(saved["generator"], loaded["generator"])
    assert torch.equal(saved["gradnorm"]["task_weights"], loaded["gradnorm"]["task_weights"])
    again.close()


V0_TINY = {"MODEL.TYPE": "mFormerV0", "MODEL.NAME": "tiny_v0",
           "MODEL.STAGES.DIMS": [8, 12, 24, 32, 64], "MODEL.STAGES.MBCONV_DEPTHS": [1, 1],
           "MODEL.STAGES.ATTN_DEPTHS": [1, 1], "MODEL.STAGES.NUM_HEADS": [2, 2]}


@time_limit(240)
def test_mformer_v0_trains_an_epoch_and_resumes_with_its_running_statistics(
        data_dir, tmp_path):  # noqa: F811
    """mFormerV0 through the Trainer with GradNorm, validation, the EMA and a
    checkpoint: every BatchNorm's running statistics move and stay finite,
    the EMA mirrors the parameters only (an EMA evaluation uses the live
    statistics, as in the TPU package), and a resumed Trainer holds the
    statistics bit for bit and trains on from them."""
    from linnaeus_tpu_torch.models.blocks.common import BatchNorm
    from linnaeus_tpu_torch.models.mformer_v0 import MFormerV0
    from linnaeus_tpu_torch.utils.checkpoint import snapshot_state

    cfg = port_only(data_dir, tmp_path / "out", epochs=1, **V0_TINY,
                    **{"TRAIN.EMA.ENABLED": True})
    trainer = Trainer(cfg, device="cpu")
    model = trainer.model
    assert isinstance(model, MFormerV0)
    bns = {n: m for n, m in model.named_modules() if isinstance(m, BatchNorm)}
    assert len(bns) == 9
    trainer.train()
    trainer.close()
    for name, bn in bns.items():
        assert bn.running_mean.ne(0).any() and bn.running_var.ne(1).any(), name
        assert torch.isfinite(bn.running_mean).all() and torch.isfinite(bn.running_var).all()
    assert trainer.metrics.get(MetricsTracker.VAL, "loss") is not None
    assert set(trainer.state.ema_params) == {n for n, _ in model.named_parameters()}
    assert sum(t["gradnorm_updates"] for t in trainer.epoch_timings.values()) == (
        trainer.progress.global_step // 2)

    cfg2 = port_only(data_dir, tmp_path / "out", epochs=2, **V0_TINY,
                     **{"TRAIN.EMA.ENABLED": True})
    again = Trainer(cfg2, device="cpu")
    assert again.try_resume()
    saved, loaded = snapshot_state(trainer.state), snapshot_state(again.state)
    for name, value in saved["model"].items():
        assert torch.equal(value, loaded["model"][name]), name
    assert any("running_var" in k for k in saved["model"])
    for name, value in saved["ema_params"].items():
        assert torch.equal(value, loaded["ema_params"][name]), name
    resumed = {n: m.running_var.clone() for n, m in again.model.named_modules()
               if isinstance(m, BatchNorm)}
    again.train()
    again.close()
    assert again.progress.global_step == 2 * trainer.steps_per_epoch
    for name, m in again.model.named_modules():
        if isinstance(m, BatchNorm):
            assert not torch.equal(m.running_var, resumed[name]), name


@time_limit(240)
def test_resumed_epoch_reads_the_samplers_batches(data_dir, tmp_path):  # noqa: F811
    """Train one epoch, then resume with two: the second epoch reads the
    batches the sampler gives for epoch 1, and the loss stays finite."""
    logged = {"SCHEDULE.METRICS.CONSOLE_INTERVAL": 1, "SCHEDULE.METRICS.WANDB_INTERVAL": 1}
    cfg = port_only(data_dir, tmp_path / "out", epochs=1, **logged)
    first = Trainer(cfg, device="cpu")
    first.train()
    first.close()
    cfg2 = port_only(data_dir, tmp_path / "out", epochs=2, **logged)
    second = Trainer(cfg2, device="cpu")
    second.train()
    second.close()
    assert second.resumed_from.endswith(f"checkpoint_step_{first.steps_per_epoch:010d}")
    assert list(second.epoch_timings) == [1]
    assert second.epoch_timings[1]["first_step"] == first.progress.global_step + 1
    sampler = second.train_loader.sampler
    sampler.set_epoch(1)
    assert [b.tolist() for b in second.train_loader.epoch_indices] == [
        b.tolist() for b in sampler.batches()]
    rows = step_rows(cfg2.ENV.OUTPUT.DIRS.LOGS)
    assert sorted(rows) == list(range(1, second.progress.global_step + 1))
    assert all(np.isfinite(r["train/loss"]) for r in rows.values())


@time_limit(240)
def test_mid_validation_resume(data_dir, tmp_path):  # noqa: F811
    """A validation pass interrupted mid-way stays queued with its partial
    accumulators and replays from the next batch (the TPU package's
    test_mid_validation_resume)."""
    cfg = port_only(data_dir, tmp_path / "out", epochs=1,
                    **{"DATA.H5.TRAIN_VAL_SPLIT_RATIO": 0.6})
    trainer = Trainer(cfg, device="cpu")
    real_step = trainer._eval_step
    calls = {"n": 0}

    def dying_step(*a, **kw):
        if calls["n"] >= 1:
            raise KeyboardInterrupt("preempted")
        calls["n"] += 1
        return real_step(*a, **kw)

    trainer._eval_step = dying_step
    trainer.progress.queue_validation(TrainingStage.VALIDATION_NORMAL)
    with pytest.raises(KeyboardInterrupt):
        trainer._run_pending_validations()
    assert trainer.progress.has_pending_validations()
    partial = trainer.progress.partial_validation_indices["val"]
    assert partial["next_index"] == 1 and partial["count"] > 0
    state = json.loads(json.dumps(trainer.progress.state_dict()))
    trainer.progress.load_state_dict(state)
    trainer._eval_step = real_step
    trainer._run_pending_validations()
    assert not trainer.progress.has_pending_validations()
    assert "val" not in trainer.progress.partial_validation_indices
    resumed = trainer.metrics.phase_summary("val")
    trainer.metrics.reset_phase("val")
    trainer._validate(TrainingStage.VALIDATION_NORMAL)
    full = trainer.metrics.phase_summary("val")
    assert resumed.keys() == full.keys()
    for key in full:
        assert abs(resumed[key] - full[key]) < 1e-5, key
    # the standalone API shares the accumulation with the Trainer's pass
    api = validate_one_pass(trainer._eval_step, trainer.state, trainer.val_loader,
                            trainer.task_keys, trainer.num_classes, trainer.meta_dim)
    for key in full:
        assert abs(api[key] - full[key]) < 1e-5, key
    masked = validate_one_pass(trainer._eval_step, trainer.state, trainer.val_loader,
                               trainer.task_keys, trainer.num_classes, trainer.meta_dim,
                               mask_meta=True)
    combo = np.zeros(trainer.meta_dim, np.float32)
    combo[:2] = 1.0
    partial_pass = validate_with_partial_mask(trainer._eval_step, trainer.state,
                                              trainer.val_loader, trainer.task_keys,
                                              trainer.num_classes, combo)
    assert masked["loss"] != full["loss"] and "loss" in partial_pass
    trainer.close()


@time_limit(240)
def test_preemption_checkpoint_and_resume(data_dir, tmp_path):  # noqa: F811
    cfg = port_only(data_dir, tmp_path / "out", epochs=3)
    trainer = Trainer(cfg, device="cpu")
    orig_increment = trainer.progress.increment_step

    def increment_and_preempt():
        orig_increment()
        trainer.shutdown.preempted.set()

    trainer.progress.increment_step = increment_and_preempt
    trainer.train()
    step_at_preempt = trainer.progress.global_step
    assert step_at_preempt == 1
    trainer.shutdown.drain()  # fires the callback: the emergency checkpoint
    assert os.listdir(cfg.ENV.OUTPUT.DIRS.CHECKPOINTS) == ["checkpoint_step_0000000001"]
    trainer.close()
    thpc._registry = None  # a new process starts with a fresh registry
    again = Trainer(cfg, device="cpu")
    assert again.try_resume()
    assert again.progress.global_step == step_at_preempt
    again.close()


@time_limit(240)
def test_early_stop_ema_and_subset_metrics(data_dir, tmp_path):  # noqa: F811
    """Early stop on an accuracy (direction-aware) survives a resume;
    validation runs on the EMA weights and puts the model's own back; the
    null / rarity / taxa-subset accuracies come out."""
    cfg = port_only(data_dir, tmp_path / "out", epochs=6, **{
        "TRAIN.EARLY_STOP.ACTIVE": True, "TRAIN.EARLY_STOP.METRIC": "val_chain_accuracy",
        "TRAIN.EARLY_STOP.PATIENCE_STEPS": 1, "TRAIN.EARLY_STOP.MIN_DELTA": 10.0,
        "TRAIN.EMA.ENABLED": True, "TRAIN.EMA.DECAY": 0.5,
        "METRICS.TRACK_NULL_VS_NON_NULL": True, "METRICS.NULL_VS_NON_NULL_TASKS": ["taxa_L10"],
        "METRICS.TRACK_RARITY": True, "METRICS.RARITY_PERCENTILES": [50],
        "METRICS.TAXA_SUBSETS": [["g100", "taxa_L20", 100]]})
    trainer = Trainer(cfg, device="cpu")
    trainer.train()
    trainer.close()
    assert trainer.progress.global_step < 6 * trainer.steps_per_epoch
    assert trainer.early_stop.higher_is_better and trainer.early_stop.steps_since_improvement >= 1
    summary = trainer.metrics.phase_summary("val")
    assert "acc1_non_null/taxa_L10" in summary
    assert any(k.startswith("acc1_rarity_") for k in summary)
    assert any(k.startswith("acc1_taxa_g100/") for k in summary)
    own = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    assert any(not torch.equal(own[n], trainer.state.ema_params[n]) for n in own)
    trainer._validate(TrainingStage.VALIDATION_NORMAL)
    assert all(torch.equal(own[n], p) for n, p in trainer.model.named_parameters())
    again = Trainer(cfg, device="cpu")
    assert again.try_resume()
    assert again.early_stop.state_dict() == trainer.early_stop.state_dict()
    for n, value in trainer.state.ema_params.items():
        assert torch.equal(value, again.state.ema_params[n]), n
    again.close()


def _cli_yaml(data_dir, out, epochs):  # noqa: F811
    cfg = port_only(data_dir, out, epochs=epochs)
    default = t_default()

    def diff(node, base):
        return {k: (diff(v, base[k]) if isinstance(v, dict) and k in base else v)
                for k, v in node.items() if k not in base or v != base[k]}

    overrides = diff(json.loads(json.dumps(cfg)), json.loads(json.dumps(default)))
    path = os.path.join(str(out), f"exp_{epochs}.yaml")
    os.makedirs(str(out), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(overrides, f)
    return path


@time_limit(400)
def test_the_cli_trains_validates_checkpoints_and_resumes(data_dir, tmp_path):  # noqa: F811
    """``python -m linnaeus_tpu_torch.train.main --cfg <yaml> --device cpu``
    in two processes: two epochs, then three on the same output directory,
    which resumes from the second epoch's checkpoint."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    out = tmp_path / "out"
    for epochs in (2, 3):
        run = subprocess.run(
            [sys.executable, "-m", "linnaeus_tpu_torch.train.main", "--cfg",
             _cli_yaml(data_dir, out, epochs), "--device", "cpu"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    logs = os.path.join(str(out), "default_project", "default_group", "e2e", "logs")
    with open(os.path.join(logs, "main_p0.log")) as f:
        text = f.read()
    assert "Resumed from" in text and "checkpoint_step_0000000008" in text
    assert text.count("[val] step") == 3 and "Training complete" in text
    ckpts = os.listdir(os.path.join(os.path.dirname(logs), "checkpoints"))
    assert "checkpoint_step_0000000012" in ckpts


OPTIONS = {
    "DATA.AUTOBATCH.ENABLED": (True, "DATA.AUTOBATCH"),
    "DATA.AUTOBATCH.ENABLED_VAL": (True, "DATA.AUTOBATCH"),
    "MODEL.PRETRAINED": ("hf://org/repo/weights.pth", "MODEL.PRETRAINED"),
    "MODEL.PRETRAINED_CONVNEXT": ("b2://bucket/weights.pth", "MODEL.PRETRAINED_CONVNEXT"),
    "ENV.OUTPUT.BUCKET.ENABLED": (True, "ENV.OUTPUT.BUCKET"),
    "PARALLEL.PARAM_SHARDING": ("fsdp", "PARALLEL.PARAM_SHARDING"),
    "PARALLEL.MESH.MODEL": (4, "PARALLEL.MESH.MODEL"),
    "PARALLEL.MULTI_HOST": (True, "PARALLEL.MULTI_HOST"),
    "PARALLEL.PIPELINE.STAGES": (2, "PARALLEL.PIPELINE.STAGES"),
    "MODEL.TYPE": ("mFormerV0", "mFormerV0"),
    "MODEL.MOE.ENABLED": (True, "MODEL.MOE.ENABLED"),
    "DATA.NATIVE_DATAPLANE": ("on", "NATIVE_DATAPLANE"),
}


@time_limit(120)
@pytest.mark.parametrize("option", OPTIONS)
def test_unported_options_raise_by_name(data_dir, tmp_path, option, monkeypatch):  # noqa: F811
    value, name = OPTIONS[option]
    cfg = port_config(make_config(data_dir, tmp_path / "out", epochs=1))
    node = cfg
    parts = option.split(".")
    for p in parts[:-1]:
        node = node[p]
    node[parts[-1]] = value
    if option == "DATA.NATIVE_DATAPLANE":
        cfg.DATA.HYBRID.USE_HYBRID = True
        cfg.DATA.HYBRID.IMAGES_DIR = str(tmp_path)
    if option == "MODEL.TYPE":
        # ported since: the Trainer builds mFormerV0 (and trains it:
        # test_mformer_v0_trains_an_epoch_and_resumes_with_its_running_statistics)
        for key, v in V0_TINY.items():
            node = cfg
            for part in key.split(".")[:-1]:
                node = node[part]
            node[key.split(".")[-1]] = v
        trainer = Trainer(cfg, device="cpu")
        trainer.close()
        assert type(trainer.model).__name__ == "MFormerV0"
        return
    if option == "ENV.OUTPUT.BUCKET.ENABLED":
        # ported since (utils/remote_sync.py, tests/test_torch_remote_sync.py):
        # the Trainer syncs the experiment's outputs at the end of training
        import linnaeus_tpu_torch.utils.remote_sync as rs

        calls = []
        monkeypatch.setattr(rs, "sync_to_bucket", lambda c, d: calls.append(d) or True)
        trainer = Trainer(cfg, device="cpu")
        trainer.close()
        trainer._sync_outputs()
        assert calls == [cfg.ENV.OUTPUT.DIRS.EXP_BASE]
        return
    if option == "MODEL.PRETRAINED_CONVNEXT":
        # ported since: a b2:// path resolves through utils/remote_sync.py,
        # which needs b2sdk (absent here), as in the TPU package
        with pytest.raises(RuntimeError, match=r"MODEL\.PRETRAINED_CONVNEXT 'b2://.*b2sdk"):
            Trainer(cfg, device="cpu").close()
        return
    if option == "MODEL.MOE.ENABLED":
        # ported since: the Trainer builds the MoE model and its step carries the
        # auxiliary losses (tests/test_torch_moe_step.py)
        cfg.MODEL.MOE.EVERY_N = 1
        trainer = Trainer(cfg, device="cpu")
        trainer.close()
        assert trainer.model.moe_num_experts == 8
        assert all(b.use_moe for s in (2, 3) for b in trainer.model.stages[s])
        return
    if option == "DATA.NATIVE_DATAPLANE":
        # ported since: the Trainer's loader reads a JPEG directory a batch at
        # a time through the host data plane (tests/test_torch_native.py)
        trainer = Trainer(cfg, device="cpu")
        trainer.close()
        dataset = trainer.bundle["train_dataset"]
        assert dataset.source.supports_batch_read() and dataset._can_bulk_read()
        return
    if option.startswith("PARALLEL."):
        # ported since (parallel/; tests/test_torch_multiprocess_trainer.py):
        # on one process the TPU package's checks decide, as on one device
        # there; FSDP over one rank shards nothing
        if option == "PARALLEL.PARAM_SHARDING":
            trainer = Trainer(cfg, device="cpu")
            trainer.close()
            assert trainer.mesh.shape == {"data": 1, "model": 1}
            assert not any(hasattr(p, "device_mesh") for p in trainer.model.parameters())
            return
        if option == "PARALLEL.MULTI_HOST":
            # the process group starts from torch.distributed.run's
            # environment, which a plain process does not have
            with pytest.raises(ValueError, match="env:// rendezvous"):
                Trainer(cfg, device="cpu").close()
            return
        from linnaeus_tpu.parallel.mesh import create_mesh as j_create_mesh

        with pytest.raises(ValueError) as ours:
            Trainer(cfg, device="cpu").close()
        with pytest.raises(ValueError) as theirs:
            if option == "PARALLEL.MESH.MODEL":
                j_create_mesh(cfg, devices=jax.devices()[:1])
            else:
                JTrainer(cfg)
        assert str(ours.value) == str(theirs.value)
        return
    with pytest.raises(NotImplementedError, match=name.replace(".", r"\.")):
        Trainer(cfg, device="cpu").close()


@time_limit(120)
def test_the_cli_needs_a_card_unless_told_otherwise(data_dir, tmp_path):  # noqa: F811
    path = _cli_yaml(data_dir, tmp_path / "out", 1)
    if not torch.cuda.is_available():
        for extra in ([], ["--throughput"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tmain.main(["--cfg", path, *extra])


def test_profiled_device_rows_keep_lambda_kernels_and_drop_annotations():
    """The rows by kernel name keep every kernel, those whose demangled
    names hold a lambda's '#' too, and leave out the user-annotation ranges
    (``Optimizer.step#AdamW.step``, ``ProfilerStep#3``) that cover kernels
    with rows of their own."""
    from types import SimpleNamespace

    from linnaeus_tpu_torch.utils.device import profiled_device_rows

    def row(key, us, device="DeviceType.CUDA", annotation=False):
        return SimpleNamespace(key=key, device_type=device, is_user_annotation=annotation,
                               self_device_time_total=us, count=2)

    events = [
        row("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
            "at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}"
            "::operator()() const::{lambda(float)#1}>(at::TensorIteratorBase&)>", 3000.0),
        row("nvjet_tst_192x192_64x4_2x1_v_bz_coopB_TNN", 1000.0),
        row("Optimizer.step#AdamW.step", 5000.0),
        row("ProfilerStep#3", 9000.0),
        row("my_range", 700.0, annotation=True),
        row("aten::copy_", 3000.0, device="DeviceType.CPU"),
    ]
    prof = SimpleNamespace(key_averages=lambda: events)
    rows = profiled_device_rows(prof)
    assert [r[0][:12] for r in rows] == ["void at::nat", "nvjet_tst_19"]
    assert sum(r[1] for r in rows) == 4.0
