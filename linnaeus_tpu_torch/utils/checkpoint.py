"""Checkpointing: the train state through ``torch.save`` + JSON sidecars.

Port of linnaeus_tpu/utils/checkpoint.py (reference parity:
utils/checkpoint.py:513-1332). A checkpoint directory
``checkpoint_step_<step:010d>`` bundles the TrainState (parameters,
optimizer state, step, GradNorm state, the state of the generator every
random draw of a step comes from, the EMA) in ``state/state.pt`` plus the
JSON sidecar (TrainingProgress with the pending-validation replay state,
metrics tracker, OpsSchedule RNG, early stop, wandb run id) and the config
snapshot. Retention implements KEEP_TOP_N (by metric) + KEEP_LAST_N
(checkpoint.py:1202) and ``auto_resume_helper`` finds the latest finalized
checkpoint in a directory (checkpoint.py:1308).

Where the TPU package's state is immutable, the optimizer here updates the
parameters and moments in place: ``CheckpointWriter.save`` copies the state
to host memory before it returns (the snapshot), and its thread only writes
that copy. The state file is written under ``state.tmp/`` and the directory
renamed to ``state/`` when it is complete, so a save cut off mid-flight
leaves no ``state/`` and auto-resume skips it.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from linnaeus_tpu_torch.loss.gradnorm import GradNormState
from linnaeus_tpu_torch.utils.logging import get_main_logger

logger = get_main_logger()

SIDECAR_NAME = "sidecar.json"
STATE_DIR = "state"
STATE_FILE = "state.pt"


def _ckpt_name(step: int) -> str:
    return f"checkpoint_step_{step:010d}"


def _to_host(obj):
    """A copy of ``obj`` with every tensor copied to host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def snapshot_state(state) -> dict[str, Any]:
    """Everything ``load_checkpoint`` restores of a TrainState, copied to
    host memory: the model's state_dict, the optimizer's, the step, the
    GradNorm state, the generator's state and the EMA (or None)."""
    gn = state.gradnorm
    return {
        "step": int(state.step),
        "model": _to_host(state.model.state_dict()),
        "optimizer": _to_host(state.optimizer.state_dict()),
        "gradnorm": {
            "task_weights": _to_host(gn.task_weights),
            "initial_losses": _to_host(gn.initial_losses),
            "has_initted": _to_host(gn.has_initted),
        },
        "generator": state.generator.get_state().clone(),
        "ema_params": _to_host(state.ema_params) if state.ema_params is not None else None,
    }


class CheckpointWriter:
    """Checkpoint writer with optional async state flush.

    With ``async_save`` the save returns once the state is copied to host
    memory, and the serialization and disk write run on a background thread
    while the train loop goes on (the reference blocks its hot loop on
    ``torch.save``, utils/checkpoint.py:513+). One save may be outstanding
    at a time; ``wait()`` must be called before reading a just-written
    checkpoint, before process exit, and before uploading the directory.
    ``last_save_seconds`` is how long the last ``save`` held its caller,
    ``last_write_seconds`` how long its state file took to write.
    """

    def __init__(self, async_save: bool = False):
        self.async_save = bool(async_save)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.last_save_seconds: float | None = None
        self.last_write_seconds: float | None = None

    def save(
        self,
        checkpoint_dir: str,
        state,
        training_progress=None,
        metrics_state: dict | None = None,
        ops_schedule_state: dict | None = None,
        early_stop_state: dict | None = None,
        config_dump: str | None = None,
        wandb_run_id: str | None = None,
        metric_value: float | None = None,
        batch: dict | None = None,
    ) -> str:
        """Save one checkpoint; returns its path. ``state`` is a TrainState
        or a ``snapshot_state`` of one. ``batch`` records the batch sizes and
        the base LR the run trains with (AutoBatch resumes with them)."""
        self.wait()  # one outstanding async save at a time
        t0 = time.perf_counter()
        snapshot = state if isinstance(state, dict) else snapshot_state(state)
        step = int(snapshot["step"])
        path = os.path.abspath(os.path.join(checkpoint_dir, _ckpt_name(step)))
        os.makedirs(path, exist_ok=True)
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(path, snapshot), name="ckpt-write", daemon=True
            )
            self._thread.start()
        else:
            self._write_state(path, snapshot)

        sidecar: dict[str, Any] = {
            "step": step,
            "metric_value": metric_value,
            "wandb_run_id": wandb_run_id,
        }
        if training_progress is not None:
            sidecar["training_progress"] = training_progress.state_dict()
        if metrics_state is not None:
            sidecar["metrics"] = metrics_state
        if ops_schedule_state is not None:
            sidecar["ops_schedule"] = ops_schedule_state
        if early_stop_state is not None:
            # patience/best must survive resume or a run that should have
            # stopped keeps training (reference: early_stop_state serialized
            # with the checkpoint, utils/checkpoint.py)
            sidecar["early_stop"] = early_stop_state
        if batch is not None:
            sidecar["batch"] = batch
        with open(os.path.join(path, SIDECAR_NAME), "w") as f:
            json.dump(sidecar, f, indent=2, default=_json_default)
        if config_dump is not None:
            with open(os.path.join(path, "config.yaml"), "w") as f:
                f.write(config_dump)
        self.last_save_seconds = time.perf_counter() - t0
        logger.info(
            f"Saved checkpoint at step {step} -> {path}"
            + (" (flushing async)" if self.async_save else "")
        )
        return path

    def _write_state(self, path: str, snapshot: dict) -> None:
        t0 = time.perf_counter()
        final = os.path.join(path, STATE_DIR)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(snapshot, os.path.join(tmp, STATE_FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)  # the state exists only once it is whole
        self.last_write_seconds = time.perf_counter() - t0

    def _write_guarded(self, path: str, snapshot: dict) -> None:
        try:
            self._write_state(path, snapshot)
        except BaseException as e:  # re-raised by wait() on the caller's thread
            self._error = e

    def wait(self) -> None:
        """Block until any outstanding async write has finalized; raise what
        it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self) -> None:
        self.wait()


def save_checkpoint(checkpoint_dir: str, state, **sidecars) -> str:
    """One-shot synchronous save (tools/tests; the Trainer holds a
    CheckpointWriter so epoch saves can flush asynchronously)."""
    return CheckpointWriter(async_save=False).save(checkpoint_dir, state, **sidecars)


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def load_checkpoint(path: str, state):
    """Restore ``state`` (a TrainState built as the run builds it) in place
    from a checkpoint directory; returns (state, sidecar).

    ``ema_params`` may be toggled across a resume: resuming with EMA newly
    enabled seeds the EMA from the restored parameters; resuming with EMA
    disabled drops the stored EMA.
    """
    state_file = os.path.join(os.path.abspath(path), STATE_DIR, STATE_FILE)
    restore_snapshot(state, torch.load(state_file, map_location="cpu", weights_only=True))
    sidecar = read_sidecar(path)
    logger.info(f"Loaded checkpoint from {path} (step {sidecar.get('step')})")
    return state, sidecar


def read_sidecar(path: str) -> dict:
    """A checkpoint directory's sidecar (step, progress, metrics, batch...),
    empty when it has none."""
    sidecar_path = os.path.join(path, SIDECAR_NAME)
    if not os.path.exists(sidecar_path):
        return {}
    with open(sidecar_path) as f:
        return json.load(f)


def restore_snapshot(state, saved: dict[str, Any]) -> None:
    """Put a :func:`snapshot_state` back into ``state`` in place: the
    parameters, the optimizer's state (moments it did not hold are
    dropped), the step, the GradNorm state, the generator and the EMA."""
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    device = state.gradnorm.task_weights.device
    gn = saved["gradnorm"]
    state.gradnorm = GradNormState(
        task_weights=gn["task_weights"].to(device),
        initial_losses=gn["initial_losses"].to(device),
        has_initted=gn["has_initted"].to(device),
    )
    state.generator.set_state(saved["generator"])
    if state.ema_params is not None:
        if saved["ema_params"] is None:
            logger.warning(
                "Checkpoint has no ema_params (EMA was enabled after it was "
                "written); seeding EMA from the restored params"
            )
            state.ema_params = {
                n: p.detach().clone() for n, p in state.model.named_parameters()
            }
        else:
            with torch.no_grad():
                for name, value in saved["ema_params"].items():
                    state.ema_params[name].copy_(value)
    elif saved["ema_params"] is not None:
        logger.warning(
            "Checkpoint carries ema_params but EMA is disabled; the stored EMA "
            "buffers are dropped"
        )
    state.last_collated = None


def list_checkpoints(checkpoint_dir: str) -> list[str]:
    if not os.path.isdir(checkpoint_dir):
        return []
    entries = [
        os.path.join(checkpoint_dir, d)
        for d in sorted(os.listdir(checkpoint_dir))
        if d.startswith("checkpoint_step_")
        and os.path.isdir(os.path.join(checkpoint_dir, d))
    ]
    return entries


def auto_resume_helper(checkpoint_dir: str) -> str | None:
    """Latest FINALIZED checkpoint path in dir, or None (checkpoint.py:1308).

    A directory whose ``state`` subdir is absent is a save that was cut off
    mid-flight (async flush interrupted by a crash/preemption before the
    state directory's rename) — resume from the previous complete one.
    """
    for c in reversed(list_checkpoints(checkpoint_dir)):
        if os.path.isdir(os.path.join(c, STATE_DIR)):
            return c
        logger.warning(f"Skipping incomplete checkpoint (no state dir): {c}")
    return None


def read_model_state(path: str) -> dict[str, torch.Tensor]:
    """The model's state_dict from a port checkpoint directory
    (``<path>/state/state.pt``, on the CPU). An Orbax checkpoint directory
    (the JAX package's) raises by name: the port reads no Orbax state."""
    state_file = os.path.join(path, STATE_DIR, STATE_FILE)
    if os.path.isfile(state_file):
        return torch.load(state_file, map_location="cpu", weights_only=True)["model"]
    if os.path.isdir(os.path.join(path, STATE_DIR)):
        raise NotImplementedError(
            f"{path!r}: an Orbax training checkpoint (the JAX package's) has no "
            f"{STATE_DIR}/{STATE_FILE}; the port reads no Orbax state. Give a port "
            "checkpoint directory, a .msgpack or a .pt file")
    raise FileNotFoundError(f"No checkpoint state in {path}")


def manage_checkpoints(
    checkpoint_dir: str,
    keep_top_n: int = 0,
    keep_last_n: int = 0,
    higher_is_better: bool = True,
    protect: list[str] | None = None,
) -> list[str]:
    """Apply retention policy; returns deleted paths (checkpoint.py:1202).

    Keeps the union of the N best (by sidecar metric_value) and the N most
    recent; with both 0, keeps everything. ``protect`` paths are never
    deleted — the Trainer passes the checkpoint whose async flush may still
    be in flight (it faces retention on the next save instead).
    """
    if keep_top_n <= 0 and keep_last_n <= 0:
        return []
    ckpts = list_checkpoints(checkpoint_dir)
    keep: set[str] = {os.path.abspath(p) for p in (protect or [])}
    if keep_last_n > 0:
        keep.update(ckpts[-keep_last_n:])
    if keep_top_n > 0:
        scored = []
        for c in ckpts:
            try:
                with open(os.path.join(c, SIDECAR_NAME)) as f:
                    mv = json.load(f).get("metric_value")
            except (OSError, json.JSONDecodeError):
                mv = None
            if mv is not None:
                scored.append((mv, c))
        scored.sort(key=lambda x: x[0], reverse=higher_is_better)
        keep.update(c for _, c in scored[:keep_top_n])
    keep = {os.path.abspath(p) for p in keep}
    deleted = []
    for c in ckpts:
        if os.path.abspath(c) not in keep:
            shutil.rmtree(c, ignore_errors=True)
            deleted.append(c)
            logger.info(f"Retention: deleted {c}")
    return deleted
