"""The port's checkpoints: ``torch.save`` of a host snapshot + JSON sidecars.

Mirrors tests/test_checkpoint_async.py on the port's TrainState, and adds
what in-place updates make necessary. Equal means bit for bit: the model,
the optimizer's state (AdamW moments and step counts; one optimizer per
parameter group behind ``MultiOptimizer``), the GradNorm state, the
generator every random draw of a step comes from, the EMA, and the
sidecars (TrainingProgress, metrics, OpsSchedule RNG, early stop).
"""

import json
import os

import pytest
import torch
from torch import nn

import linnaeus_tpu_torch.utils.checkpoint as ckpt
from linnaeus_tpu_torch.configuration import get_default_config
from linnaeus_tpu_torch.metrics.tracker import MetricsTracker
from linnaeus_tpu_torch.ops_schedule import (
    EarlyStopState,
    OpsSchedule,
    TrainingProgress,
    TrainingStage,
)
from linnaeus_tpu_torch.optim.build import MultiOptimizer
from linnaeus_tpu_torch.train.state import create_train_state


def tiny_state(seed=0, ema=False, groups=False):
    torch.manual_seed(seed)
    model = nn.Sequential(nn.Linear(4, 8), nn.LayerNorm(8), nn.Linear(8, 3))
    if groups:
        opt = MultiOptimizer({
            "default": torch.optim.AdamW(model[:2].parameters(), lr=1e-2),
            "HEADS": torch.optim.SGD(model[2].parameters(), lr=1e-2, momentum=0.9),
        })
    else:
        opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    return create_train_state(model, opt, num_tasks=2,
                              generator=torch.Generator().manual_seed(seed + 7),
                              lr_schedule=lambda s: 1e-2 / (1 + s), ema=ema)


def take_step(state):
    """One in-place optimizer step with a draw from the state's generator,
    a GradNorm-like weight change and an EMA update."""
    x = torch.randn(5, 4, generator=state.generator)
    state.model.zero_grad()
    state.model(x).square().mean().backward()
    state.apply_gradients()
    state.gradnorm.task_weights.mul_(torch.tensor([1.1, 0.9]))
    state.gradnorm.has_initted.fill_(True)
    if state.ema_params is not None:
        with torch.no_grad():
            for n, p in state.model.named_parameters():
                state.ema_params[n].mul_(0.5).add_(p, alpha=0.5)


def sidecar_objects(steps=3):
    cfg = get_default_config()
    cfg.SCHEDULE.META_MASKING.PARTIAL.ENABLED = True
    cfg.SCHEDULE.META_MASKING.PARTIAL.WHITELIST = [["TEMPORAL"], ["SPATIAL"]]
    progress = TrainingProgress(global_step=steps, current_epoch=1, expected_total_steps=10)
    progress.queue_validation(TrainingStage.VALIDATION_MASK_META)
    progress.partial_validation_indices["val_mask_meta"] = {"next_index": 1, "count": 8.0,
                                                            "totals": {"loss": 3.5}}
    metrics = MetricsTracker(["t1", "t2"])
    metrics.update("val", {"loss": 0.7, "acc1/t1": 0.25}, n=8)
    metrics.log_gradnorm(2, {"gradnorm/avg_norm": 1.5})
    schedule = OpsSchedule(cfg, progress)
    for _ in range(3):
        schedule.pick_partial_mask_combo()
    early = EarlyStopState("val_chain_accuracy", higher_is_better=True)
    early.update(0.4, step=2)
    return progress, metrics, schedule, early


def save(writer, d, state, objects=None, **kw):
    progress, metrics, schedule, early = objects or sidecar_objects()
    return writer.save(d, state, training_progress=progress, metrics_state=metrics.state_dict(),
                       ops_schedule_state=schedule.state_dict(),
                       early_stop_state=early.state_dict(), config_dump="A: 1\n", **kw)


@pytest.mark.parametrize("ema", [False, True])
@pytest.mark.parametrize("groups", [False, True])
def test_round_trip(tmp_path, groups, ema):
    """Model, optimizer, generator, GradNorm, EMA, progress, metrics,
    schedule RNG and early stop come back bit for bit into a state built
    afresh; the restored generator then draws what the saved one draws."""
    state = tiny_state(0, ema=ema, groups=groups)
    for _ in range(3):
        take_step(state)
    objects = sidecar_objects()
    path = save(ckpt.CheckpointWriter(), str(tmp_path), state, objects, metric_value=0.7,
                wandb_run_id="run-1")
    assert os.path.basename(path) == "checkpoint_step_0000000003"
    assert os.path.isfile(os.path.join(path, ckpt.STATE_DIR, ckpt.STATE_FILE))
    fresh = tiny_state(1, ema=ema, groups=groups)
    fresh, sidecar = ckpt.load_checkpoint(path, fresh)
    saved, loaded = ckpt.snapshot_state(state), ckpt.snapshot_state(fresh)
    assert saved.keys() == loaded.keys()
    assert saved["step"] == loaded["step"] == 3
    for key in ("model", "gradnorm", "ema_params"):
        _assert_same(saved[key], loaded[key])
    _assert_same(saved["optimizer"], loaded["optimizer"])
    assert torch.equal(saved["generator"], loaded["generator"])
    assert torch.equal(torch.rand(4, generator=state.generator),
                       torch.rand(4, generator=fresh.generator))
    progress, metrics, schedule, early = objects
    assert sidecar["metric_value"] == 0.7 and sidecar["wandb_run_id"] == "run-1"
    again = sidecar_objects(steps=0)
    again[0].load_state_dict(sidecar["training_progress"])
    again[1].load_state_dict(sidecar["metrics"])
    again[2].load_state_dict(sidecar["ops_schedule"])
    again[3].load_state_dict(sidecar["early_stop"])
    assert again[0].state_dict() == json.loads(json.dumps(progress.state_dict()))
    assert again[1].state_dict() == json.loads(json.dumps(metrics.state_dict()))
    assert again[3].state_dict() == early.state_dict()
    assert [again[2].pick_partial_mask_combo() for _ in range(6)] == [
        schedule.pick_partial_mask_combo() for _ in range(6)]
    with open(os.path.join(path, "config.yaml")) as f:
        assert f.read() == "A: 1\n"


def _assert_same(a, b):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


def test_async_save_matches_sync_after_wait(tmp_path):
    state = tiny_state()
    take_step(state)
    sync_path = ckpt.save_checkpoint(str(tmp_path / "sync"), state)
    writer = ckpt.CheckpointWriter(async_save=True)
    path = writer.save(str(tmp_path / "async"), state, metric_value=1.5)
    writer.wait()
    assert os.path.isdir(os.path.join(path, ckpt.STATE_DIR))
    assert writer.last_save_seconds is not None and writer.last_write_seconds is not None
    a = torch.load(os.path.join(sync_path, ckpt.STATE_DIR, ckpt.STATE_FILE), weights_only=True)
    b = torch.load(os.path.join(path, ckpt.STATE_DIR, ckpt.STATE_FILE), weights_only=True)
    _assert_same(a, b)
    _, sidecar = ckpt.load_checkpoint(path, tiny_state(1))
    assert sidecar["metric_value"] == 1.5
    # a second save through the same writer (waits internally) also lands
    take_step(state)
    writer.save(str(tmp_path / "async"), state)
    writer.close()
    assert len(ckpt.list_checkpoints(str(tmp_path / "async"))) == 2


def test_async_snapshot_is_taken_before_the_next_step(tmp_path, monkeypatch):
    """The optimizer updates the parameters and moments in place: an async
    save that is still writing while the next step runs must write the
    state of the save, bit for bit, not the state after the step."""
    import threading

    state = tiny_state(groups=True)
    take_step(state)
    before = ckpt.snapshot_state(state)
    gate = threading.Event()
    real_save = torch.save

    def slow_save(obj, f, *a, **kw):
        gate.wait(10)  # the write starts only after the next step
        return real_save(obj, f, *a, **kw)

    monkeypatch.setattr(ckpt.torch, "save", slow_save)
    writer = ckpt.CheckpointWriter(async_save=True)
    path = writer.save(str(tmp_path), state)
    for _ in range(2):
        take_step(state)
    gate.set()
    writer.wait()
    loaded = ckpt.snapshot_state(ckpt.load_checkpoint(path, tiny_state(3, groups=True))[0])
    _assert_same(loaded, before)
    after = ckpt.snapshot_state(state)
    assert not torch.equal(after["model"]["0.weight"], before["model"]["0.weight"])


def test_async_write_failure_raises_at_wait(tmp_path, monkeypatch):
    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", broken)
    writer = ckpt.CheckpointWriter(async_save=True)
    path = writer.save(str(tmp_path), tiny_state())
    with pytest.raises(OSError, match="disk full"):
        writer.wait()
    assert not os.path.isdir(os.path.join(path, ckpt.STATE_DIR))
    assert ckpt.auto_resume_helper(str(tmp_path)) is None


def test_retention_protects_in_flight_path(tmp_path):
    d = str(tmp_path / "ck")
    state = tiny_state()
    paths = []
    for step in range(3):
        state.step = step
        paths.append(ckpt.save_checkpoint(d, state, metric_value=float(step)))
    # keep_last_n=1 would delete paths[0] and paths[1]; protecting paths[0]
    # (as if its async flush were still running) keeps it alive
    deleted = ckpt.manage_checkpoints(d, keep_last_n=1, protect=[paths[0]])
    assert paths[1] in deleted
    assert os.path.isdir(paths[0]) and os.path.isdir(paths[2])
    # the best by metric (step 0's 0.0; lower is better) and the last survive
    for step in range(3, 6):
        state.step = step
        ckpt.save_checkpoint(d, state, metric_value=float(10 - step))
    ckpt.manage_checkpoints(d, keep_top_n=1, keep_last_n=1, higher_is_better=False)
    assert [os.path.basename(p) for p in ckpt.list_checkpoints(d)] == [
        "checkpoint_step_0000000000", "checkpoint_step_0000000005"]


def test_auto_resume_skips_unfinalized(tmp_path):
    d = str(tmp_path / "ck")
    complete = ckpt.save_checkpoint(d, tiny_state())
    # a later checkpoint whose async flush never finalized: sidecar written,
    # the state file half-written under state.tmp, no state dir
    partial = os.path.join(d, "checkpoint_step_0000000099")
    os.makedirs(os.path.join(partial, ckpt.STATE_DIR + ".tmp"))
    with open(os.path.join(partial, ckpt.SIDECAR_NAME), "w") as f:
        f.write("{}")
    assert ckpt.auto_resume_helper(d) == complete
    assert ckpt.auto_resume_helper(str(tmp_path / "none")) is None


def test_ema_toggled_across_a_resume(tmp_path):
    """EMA enabled after the save: seeded from the restored parameters;
    disabled after it: the stored EMA is dropped."""
    plain = tiny_state()
    take_step(plain)
    path = ckpt.save_checkpoint(str(tmp_path / "a"), plain)
    with_ema, _ = ckpt.load_checkpoint(path, tiny_state(1, ema=True))
    for n, p in with_ema.model.named_parameters():
        assert torch.equal(with_ema.ema_params[n], p.detach())
    take_step(with_ema)
    path = ckpt.save_checkpoint(str(tmp_path / "b"), with_ema)
    dropped, _ = ckpt.load_checkpoint(path, tiny_state(2))
    assert dropped.ema_params is None
    _assert_same(ckpt.snapshot_state(dropped)["model"], ckpt.snapshot_state(with_ema)["model"])
