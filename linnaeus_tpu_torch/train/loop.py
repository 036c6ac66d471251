"""Trainer — full training orchestration, on one rank or many.

Port of linnaeus_tpu/train/loop.py (reference parity: linnaeus/main.py:
426-2537 + train.py:13-443 + validation.py:49-637):

  build datasets -> loaders -> schedule -> model, optimizer, TrainState
  -> epoch loop { train epoch -> checkpoint trigger -> validation passes }
  with auto-resume (incl. pending-validation replay), GradNorm cadence,
  early stop, retention policy, and phase-keyed metrics.

The model, state, train step and GradNorm step come from
train/build.py::build_training, the same function ``tools/train_bench.py``
builds its config step with. The model is drawn from ``MISC.SEED`` and every
random draw of a step comes from the state's generator, seeded with it too.
Schedule values enter each step as operands computed on the host. GradNorm's
update re-forwards the collated batch the step just consumed, collated again
from the same batch and scalars with the generator states the step saved
(``train_step.collated``), as the TPU package regenerates it from the step's
key.

MODEL.PRETRAINED* loads pretrained weights (utils/pretrained.py) into the
model after it is built and before the optimizer and the EMA exist, unless
an auto-resume checkpoint is there: resume wins. DATA.AUTOBATCH.ENABLED /
ENABLED_VAL search the train / validation batch (train/autobatch.py) at the
end of the build by real steps on the card (a train trial ends with one
GradNorm update when GradNorm is on, and holds the batches the loader keeps
on the card ahead of the step), from a snapshot of the state that is
put back afterwards, then rebuild the loaders and, for the train batch,
scale BASE_LR by new / old and rebuild the schedules, the optimizer and the
step. The schedule steps given as fractions (warm-up, masking, mixing,
intervals) are resolved again from the unresolved config against the new
batch's step count, as a run configured with that batch resolves them; the
TPU package keeps the configured batch's counts there (ROADMAP F6: the port
departs from it on purpose). The search
reads allocator peaks, which move with what else the process holds, so a
run that finds an auto-resume checkpoint does not search again: it takes
the batches and the base LR that the checkpoint records.

More than one rank (parallel/): the Trainer starts the process group where
``torch.distributed.run`` asks for one (``initialize_multi_host``), builds
the (data, model) mesh from PARALLEL.MESH and hands it to the loaders (each
rank reads its rows of its host's batch) and to ``build_training`` (the
TPU package's checks of PARALLEL, then replicated, FSDP2, TP or EP, the
ring and the pipeline). Rank 0 alone writes the console log, the metrics
files, wandb and the checkpoints (whole, in the one-process format); every
rank takes the snapshot (a sharded state is gathered) and every rank loads
a checkpoint on resume. Validation sums each batch's counts over the data
axis. AutoBatch aligns the batch to the data axis's size, as the TPU
package does (and to 2 under 'mixed-pairs').

What the port does not run raises by name: remote output sync
(ENV.OUTPUT.BUCKET), and, through build_model, make_train_step and
load_pretrained, remote pretrained paths. mFormerV0 trains here as
mFormerV1 does: its BatchNorm running statistics are buffers of the model,
so the step updates them, and checkpoints, resume and AutoBatch's snapshot
carry them with the model's state_dict (train/step.py).

Each loop iteration (a train step and, when due, the GradNorm update, the
``trainer/gradnorm`` span) is the ``trainer/iteration`` span of
utils/tracing.py, recorded whether tracing is on or not: host clock
readings and, on CUDA, two events on the stream. At the epoch's end the
Trainer takes the epoch's iterations from the recorder and sums them up
into ``epoch_timings[epoch]``. The stream's time between an iteration's two
events is not device-busy time: it holds every gap in which the device
waits for the host's next launch. The torch.profiler window of
DEBUG.PROFILE (``profile_summary``) gives the device-busy share (the union
of the device's operations on the trace's clock), the spans the window
recorded (the train step's phases among them: train/step.py) and the
device's idle time by the span the host was in.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import statistics
import time

import numpy as np
import torch

from linnaeus_tpu_torch.configuration.utils import setup_output_dirs
from linnaeus_tpu_torch.data.build import build_datasets, build_loaders
from linnaeus_tpu_torch.metrics.chain_accuracy import chain_accuracy_counts
from linnaeus_tpu_torch.metrics.tracker import MetricsTracker
from linnaeus_tpu_torch.ops_schedule import EarlyStopState, OpsSchedule, TrainingProgress
from linnaeus_tpu_torch.ops_schedule.training_progress import TrainingStage
from linnaeus_tpu_torch.optim.build import lr_dict_for_logging
from linnaeus_tpu_torch.parallel.mesh import create_mesh, initialize_multi_host, is_main_process
from linnaeus_tpu_torch.utils import checkpoint as ckpt
from linnaeus_tpu_torch.utils import tracing
from linnaeus_tpu_torch.utils.debug import check_debug_flag
from linnaeus_tpu_torch.utils.device import (
    busy_window,
    idle_by_span,
    profile_events,
    resolve_device,
)
from linnaeus_tpu_torch.utils.logging import get_main_logger
from linnaeus_tpu_torch.utils.meta import compute_meta_chunk_bounds_by_name, total_meta_dim
from linnaeus_tpu_torch.utils.pretrained import pretrained_paths

from .autobatch import auto_find_batch_size, device_memory_bytes, measure_peak_bytes
from .build import build_training
from .step import ScheduleScalars, make_eval_step
from .validation import accumulate_batch, eval_masks, soft_targets, summarize_totals, to_host

logger = get_main_logger()


def combo_to_mask(combo: list[str] | None, bounds_by_name: dict, meta_dim: int):
    mask = np.zeros((meta_dim,), np.float32)
    if combo:
        for name in combo:
            b = bounds_by_name.get(name.upper()) or bounds_by_name.get(name)
            if b:
                mask[b[0]:b[1]] = 1.0
    return mask


def profile_window_summary(events, spans: dict, steps: int, wall_ms: float) -> dict:
    """A profiled window of ``steps`` steps from its events
    (utils/device.py::profile_events) and the recorder's summary of the
    spans it recorded (utils/tracing.py::summary): its wall and device-busy
    ms a step, the idle share on the trace's clock, each span's calls and
    host and device ms a step, and the device's idle ms by span."""
    busy_ms, window_ms = busy_window(events)
    return {
        "steps": steps, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms / steps,
        "idle_share": 1.0 - busy_ms / window_ms if window_ms > 0 else None,
        "spans": {name: {"calls": v["calls"], "host_ms_per_step": v["host_ms"] / steps,
                         "device_ms_per_step": (None if v["device_ms"] is None
                                                else v["device_ms"] / steps)}
                  for name, v in spans.items()},
        "idle_ms_by_span": idle_by_span(events, set(spans)),
    }


class Trainer:
    def __init__(self, config, skip_validation: bool = False,
                 device: torch.device | str | None = None):
        # the process group first (before a card is touched), then the mesh
        initialize_multi_host(config, device)
        self.device = resolve_device(device)
        self.mesh = create_mesh(config, device_type=self.device.type)
        self.is_main = is_main_process()
        self.config = config
        self.skip_validation = skip_validation
        ab = config.DATA.AUTOBATCH
        if ab.get("ENABLED", False) or ab.get("ENABLED_VAL", False):
            device_memory_bytes(self.device)  # the probe needs a card: raises without one
        setup_output_dirs(config)
        self.ckpt_dir = config.ENV.OUTPUT.DIRS.CHECKPOINTS
        # async flush: the hot loop resumes while the snapshot writes in the
        # background (SCHEDULE.CHECKPOINT.ASYNC); waited at resume/exit/
        # preemption
        self.ckpt_writer = ckpt.CheckpointWriter(
            async_save=bool(config.SCHEDULE.CHECKPOINT.get("ASYNC", True))
        )

        from linnaeus_tpu_torch.utils.hpc import get_shutdown_registry

        self.shutdown = get_shutdown_registry()
        self.shutdown.install_handlers()

        # ---------------- data
        self.bundle = build_datasets(config)
        self.num_classes = self.bundle["num_classes"]
        self.task_keys = tuple(config.DATA.TASK_KEYS_H5)
        self.taxonomy_tree = self.bundle["taxonomy_tree"]
        # persist class maps / densities / taxonomy so a finished run
        # carries what a serving bundle needs
        if config.ENV.OUTPUT.DIRS.get("ASSETS") and self.is_main:
            from linnaeus_tpu_torch.data.processor import process_and_save_dataset_metadata

            process_and_save_dataset_metadata(
                self.bundle["processor"], config.ENV.OUTPUT.DIRS.ASSETS
            )
        self.train_loader, self.val_loader = build_loaders(
            config, self.bundle, device=self.device, mesh=self.mesh
        )
        self.shutdown.register(self.train_loader)
        if self.val_loader is not None:
            self.shutdown.register(self.val_loader)
        self.steps_per_epoch = max(len(self.train_loader), 1)
        total_steps = self.steps_per_epoch * int(config.TRAIN.EPOCHS)
        from linnaeus_tpu_torch.utils.schedule_utils import (
            apply_lr_scaling,
            resolve_all_schedule_params,
            schedule_summary,
            validate_schedule_config,
        )

        validate_schedule_config(config)
        # the fractions as configured, for AutoBatch to resolve again (F6)
        self._unresolved_schedule = config.clone()
        resolve_all_schedule_params(config, total_steps)
        # linear LR scaling by the batch of one optimizer step (reference
        # applies this unconditionally, main.py:924); accumulation splits
        # the loader batch into microbatches and does not multiply it
        apply_lr_scaling(config, int(config.DATA.BATCH_SIZE))
        config.freeze()

        # ---------------- progress & schedule
        self.progress = TrainingProgress(expected_total_steps=total_steps)
        self.metrics = MetricsTracker(list(self.task_keys))
        self.ops_schedule = OpsSchedule(config, self.progress, self.metrics)
        # direction inferred from the metric name, reference convention
        # (ops_schedule.py:164-170: 'loss' in name -> lower is better)
        es_metric = str(config.TRAIN.EARLY_STOP.METRIC)
        self.early_stop = EarlyStopState(
            metric_name=es_metric,
            higher_is_better="loss" not in es_metric.lower(),
        )
        logger.info("\n" + schedule_summary(config, total_steps, self.steps_per_epoch))
        from linnaeus_tpu_torch.utils.schedule_utils import generate_schedule_plot

        plot_path = generate_schedule_plot(
            config, total_steps, f"{config.ENV.OUTPUT.DIRS.LOGS}/schedule.png")
        if plot_path:
            logger.info(f"Schedule plot written to {plot_path}")
        from linnaeus_tpu_torch.utils.training_consistency import (
            TrainingConsistencyChecker,
            validate_training_schedule,
        )

        validate_training_schedule(config, total_steps, self.steps_per_epoch)
        self.consistency = TrainingConsistencyChecker(config, total_steps)

        from linnaeus_tpu_torch.metrics.step_logger import StepMetricsLogger, initialize_wandb

        self.wandb_run = initialize_wandb(config) if self.is_main else None
        jsonl_path = None
        if config.ENV.OUTPUT.DIRS.LOGS and self.is_main:
            jsonl_path = f"{config.ENV.OUTPUT.DIRS.LOGS}/metrics.jsonl"
        self.step_logger = StepMetricsLogger(
            config, self.ops_schedule, self.metrics,
            wandb_run=self.wandb_run, jsonl_path=jsonl_path,
        )

        # ---------------- model / optimizer / state / steps
        gw = config.LOSS.GRAD_WEIGHTING.TASK
        init_weights = list(gw.INIT_WEIGHTS or [])
        if not init_weights and str(gw.INIT_STRATEGY) == "inverse_density":
            dens = self.bundle["processor"].task_label_density
            init_weights = [
                1.0 / max(dens.get(t, {}).get("train", dens.get(t, {}).get("all", 1.0)), 1e-3)
                for t in self.task_keys
            ]
        self.ema_enabled = bool(config.TRAIN.get("EMA", {}).get("ENABLED", False))
        self.ema_eval = self.ema_enabled and bool(config.TRAIN.EMA.get("EVAL", True))
        # pretrained init and AutoBatch; auto-resume wins: a checkpoint in
        # the output directory means this run already trained past init, at
        # the batch that checkpoint records
        resume_path = (ckpt.auto_resume_helper(self.ckpt_dir)
                       if bool(config.TRAIN.AUTO_RESUME) else None)
        pretrained = bool(pretrained_paths(config))
        if pretrained and resume_path:
            logger.info(
                "MODEL.PRETRAINED set but an auto-resume checkpoint exists — skipping "
                "pretrained init (resume wins)")
            pretrained = False
        parts = build_training(
            config, self.num_classes, self.taxonomy_tree, device=self.device,
            seed=int(config.MISC.SEED), total_steps=total_steps,
            steps_per_epoch=self.steps_per_epoch,
            init_task_weights=init_weights or None, pretrained=pretrained, mesh=self.mesh,
        )
        self.model, self.state = parts.model, parts.state
        # the loaders' reports by name ("ConvNeXt", "RoPE-ViT", ...), empty
        # when no pretrained weights were loaded
        self.pretrained_reports = parts.pretrained_reports
        self._optimizer_and_step = parts.optimizer_and_step
        self.group_schedules = parts.schedules
        self.lr_schedule = parts.schedules["default"]
        self.train_criteria, self.val_criteria = parts.train_criteria, parts.val_criteria
        self._train_step, self._gradnorm_update = parts.train_step, parts.gradnorm_step
        self.meta_dim = total_meta_dim(config)
        self.bounds_by_name = compute_meta_chunk_bounds_by_name(config)
        self._no_combo = torch.zeros(self.meta_dim, device=self.device)
        n_params = sum(p.numel() for p in self.model.parameters())
        logger.info(f"Model params: {n_params:,}")
        if parts.augment is not None:
            logger.info(
                "On-device augmentation enabled: policy="
                f"{config.AUG.AUTOAUG.POLICY!r} jitter="
                f"{config.AUG.AUTOAUG.COLOR_JITTER} erase="
                f"{config.AUG.RANDOM_ERASE.PROB}"
            )
        null_tasks = ()
        if bool(config.METRICS.get("TRACK_NULL_VS_NON_NULL", False)):
            null_tasks = tuple(
                t for t in config.METRICS.NULL_VS_NON_NULL_TASKS if t in self.task_keys
            )
        subset_bins = None
        taxa_selectors = None
        proc = self.bundle.get("processor")
        if bool(config.METRICS.get("TRACK_RARITY", False)) and proc is not None:
            subset_bins = {
                t: b for t in self.task_keys
                if (b := proc.rarity_class_bins(t)) is not None
            }
        if proc is not None and getattr(proc, "taxa_subsets", None):
            taxa_selectors = proc.taxa_subset_selectors()
        self._eval_step = make_eval_step(
            self.val_criteria, self.task_keys,
            has_meta=self.meta_dim > 0, num_classes=self.num_classes,
            null_tasks=null_tasks, subset_bins=subset_bins,
            taxa_selectors=taxa_selectors,
        )
        if check_debug_flag(config, "DEBUG.LOSS.GRADNORM_MEMORY") and self._gradnorm_update:
            logger.debug(
                "[GRADNORM_MEMORY] re-forward config: "
                f"accum_steps={gw.get('GRADNORM_ACCUM_STEPS', 1)} "
                f"remat={config.TRAIN.GRADIENT_CHECKPOINTING.ENABLED_GRADNORM_STEPS} "
                f"zero_aux={gw.ZERO_AUX_INFO} "
                f"linear_heads={gw.USE_LINEAR_HEADS_FOR_GRADNORM_REFORWARD}"
            )

        # timing of the run (module docstring): the current epoch's steps
        # and whether each ran a GradNorm update
        self.step_times: list[dict] = []
        self.epoch_timings: dict[int, dict] = {}
        self.validation_seconds: list[tuple[str, float]] = []
        self.resumed_from: str | None = None
        self.resume_seconds: float | None = None
        self._profiler = None
        self._profile_t0 = 0.0
        self.profile_summary: dict | None = None
        # what AutoBatch found, by "train" / "val": the budget, every trial's
        # peak bytes (None: out of memory), the batch before and after, the
        # search's seconds, and for "train" the base LR before and after; on
        # resume only the checkpoint it came from and the batch
        self.autobatch: dict[str, dict] = {}
        if resume_path and (ab.get("ENABLED", False) or ab.get("ENABLED_VAL", False)):
            self._resume_autobatch(resume_path)
        else:
            if ab.get("ENABLED", False):
                self._run_autobatch()
            if ab.get("ENABLED_VAL", False):
                self._run_autobatch_val()
        # callbacks run before resources close during drain(), so the
        # emergency checkpoint lands before the loaders shut down
        self.shutdown.register_callback(self._on_preempt)

    def close(self) -> None:
        """Finish any checkpoint write, stop the loaders' threads, and leave
        the shutdown registry (a process that builds several Trainers)."""
        self.ckpt_writer.close()
        self.train_loader.close()
        if self.val_loader is not None:
            self.val_loader.close()
        self.shutdown.unregister_callback(self._on_preempt)

    # ----------------------------------------------------------- AutoBatch
    def _zeros_batch(self, bs: int) -> dict:
        """A batch of ``bs`` zeros as the loader gives it (uint8 images)."""
        size = self.config.MODEL.IMG_SIZE
        h, w = (size, size) if isinstance(size, int) else tuple(size)
        dev = self.device
        return {
            "images": torch.zeros((bs, h, w, int(self.config.MODEL.IN_CHANS)),
                                  dtype=torch.uint8, device=dev),
            "targets": {t: torch.zeros((bs,), dtype=torch.long, device=dev)
                        for t in self.task_keys},
            "aux": torch.zeros((bs, self.meta_dim), device=dev) if self.meta_dim else None,
            "group_ids": torch.zeros((bs,), dtype=torch.int32, device=dev),
        }

    def _search(self, key: str, run_trial, fraction: float, lo: int, hi: int,
                multiple_of: int = 1) -> int:
        """AutoBatch's search with ``run_trial(bs)`` as the probe, from a
        snapshot of the state that is put back afterwards (the trials are
        real steps: they move the parameters, the moments, the GradNorm
        state, the generator and the step counter)."""
        saved = ckpt.snapshot_state(self.state)
        trials: dict[int, int | None] = {}
        total = device_memory_bytes(self.device)
        t0 = time.perf_counter()
        found = auto_find_batch_size(
            lambda bs: measure_peak_bytes(run_trial, bs, self.device),
            target_memory_fraction=fraction, min_batch_size=lo, max_batch_size=hi,
            total_bytes=total, multiple_of=multiple_of, trials=trials,
        )
        ckpt.restore_snapshot(self.state, saved)
        self.model.zero_grad(set_to_none=True)
        self.autobatch[key] = {"budget_bytes": int(total * fraction), "trials": trials,
                               "found": found, "seconds": time.perf_counter() - t0}
        return found

    def _set_train_batch(self, batch_size: int, base_lr: float) -> None:
        """Train at ``batch_size`` and ``base_lr`` where the build assumed
        the configured batch: rebuild the loaders, TOTAL_STEPS, the group
        schedules, the optimizer on the same parameters (fresh moments) and
        the step, which reads the default schedule for its lr metric."""
        from linnaeus_tpu_torch.optim.schedules import build_group_schedules

        logger.info(f"AutoBatch: updating DATA.BATCH_SIZE -> {batch_size}")
        self.config.defrost()
        self.config.DATA.BATCH_SIZE = batch_size
        self.config.freeze()
        self._rebuild_loaders()
        self.steps_per_epoch = max(len(self.train_loader), 1)
        total_steps = self.steps_per_epoch * int(self.config.TRAIN.EPOCHS)
        self.progress.expected_total_steps = total_steps
        self.config.defrost()
        self._resolve_fractions_again(total_steps)
        self.config.LR_SCHEDULER.BASE_LR = base_lr
        self.config.freeze()
        logger.info(f"AutoBatch: base LR -> {base_lr:.3e}; rebuilding schedules for "
                    f"total_steps={total_steps}")
        self.group_schedules = build_group_schedules(
            self.config, total_steps, self.steps_per_epoch)
        self.lr_schedule = self.group_schedules["default"]
        optimizer, self._train_step = self._optimizer_and_step(self.group_schedules)
        self.state.optimizer = optimizer
        self.state.lr_schedule = self.group_schedules

    def _resolve_fractions_again(self, total_steps: int) -> None:
        """Every schedule step the config gives as a fraction, resolved
        again from the configured fraction against ``total_steps`` (and
        TOTAL_STEPS set), as a run configured with the new batch resolves
        them (F6)."""
        from linnaeus_tpu_torch.utils.schedule_utils import (
            _FRACTION_PAIRS,
            _node_at,
            resolve_all_schedule_params,
        )

        for path, steps_key, frac_key in _FRACTION_PAIRS:
            try:
                src, dst = _node_at(self._unresolved_schedule, path), _node_at(self.config, path)
            except KeyError:
                continue
            if steps_key in src:
                dst[steps_key] = src[steps_key]
            if frac_key in src:
                dst[frac_key] = src[frac_key]
        resolve_all_schedule_params(self.config, total_steps)

    def _set_val_batch(self, batch_size: int) -> None:
        logger.info(f"AutoBatch(val): updating DATA.BATCH_SIZE_VAL -> {batch_size}")
        self.config.defrost()
        self.config.DATA.BATCH_SIZE_VAL = batch_size
        self.config.freeze()
        self._rebuild_loaders()

    def _rebuild_loaders(self) -> None:
        """New loaders at the config's batch sizes. The old ones have not
        been iterated (no threads) and share the datasets, so they leave
        the shutdown registry unclosed."""
        for old in (self.train_loader, self.val_loader):
            if old is not None:
                self.shutdown.unregister(old)
        self.train_loader, self.val_loader = build_loaders(
            self.config, self.bundle, device=self.device, mesh=self.mesh)
        self.shutdown.register(self.train_loader)
        if self.val_loader is not None:
            self.shutdown.register(self.val_loader)

    def _resume_autobatch(self, path: str) -> None:
        """AutoBatch when an auto-resume checkpoint exists: the batches and
        the base LR the checkpoint records, so the resumed run keeps its LR,
        its schedule and the loader positions it saved. A checkpoint that
        records none keeps the configured batches."""
        recorded = ckpt.read_sidecar(path).get("batch")
        if recorded is None:
            logger.warning(f"AutoBatch: {path} records no batch; resuming at the configured "
                           "batches without a search")
            return
        ab = self.config.DATA.AUTOBATCH
        if ab.get("ENABLED", False):
            bs, lr = int(recorded["BATCH_SIZE"]), float(recorded["BASE_LR"])
            self.autobatch["train"] = {"resumed_from": path, "found": bs, "base_lr_after": lr}
            if (bs, lr) != (int(self.config.DATA.BATCH_SIZE),
                            float(self.config.LR_SCHEDULER.BASE_LR)):
                self._set_train_batch(bs, lr)
        if ab.get("ENABLED_VAL", False):
            bs = int(recorded["BATCH_SIZE_VAL"])
            self.autobatch["val"] = {"resumed_from": path, "found": bs}
            if bs != int(self.config.DATA.BATCH_SIZE_VAL):
                self._set_val_batch(bs)

    def _run_autobatch(self) -> None:
        """The largest train batch under TARGET_MEMORY_FRACTION (reference:
        main.py:1249-1396), each trial STEPS_PER_TRIAL steps of the
        configured step and, when GradNorm is on, one GradNorm update, which
        re-forwards the kept batch with a backward a task and may peak above
        the step, with the loader's DEVICE_PREFETCH_DEPTH batches resident
        beside them (the TPU package probes the step alone); then the loaders,
        the LR, the schedules, the optimizer and the step are rebuilt around
        it."""
        ab = self.config.DATA.AUTOBATCH
        scalars = ScheduleScalars.zeros(self.meta_dim, device=self.device)

        def run_trial(bs: int) -> None:
            batch = self._zeros_batch(bs)
            # the batches the loader copies to the card ahead of the step
            ahead = [self._zeros_batch(bs)
                     for _ in range(self.train_loader.device_prefetch_depth)]
            for _ in range(int(ab.STEPS_PER_TRIAL)):
                self.state, _metrics = self._train_step(self.state, batch, scalars)
            if self._gradnorm_update is not None:
                self.state, _metrics = self._gradnorm_update(self.state, batch, scalars)
            del ahead

        old_bs = int(self.config.DATA.BATCH_SIZE)
        old_lr = float(self.config.LR_SCHEDULER.BASE_LR)
        # the mixed-pairs sampler takes even batches only (the TPU package
        # aligns to the data-parallel count alone, so one device may get an
        # odd batch there: ROADMAP F7)
        pairs = self.train_loader.sampler.mode == "mixed-pairs"
        found = self._search("train", run_trial, float(ab.TARGET_MEMORY_FRACTION),
                             int(ab.MIN_BATCH_SIZE), int(ab.MAX_BATCH_SIZE),
                             multiple_of=math.lcm(self.mesh.data, 2 if pairs else 1))
        self.autobatch["train"].update(batch_before=old_bs, base_lr_before=old_lr,
                                       base_lr_after=old_lr)
        if found == old_bs:
            return
        # the absolute scaling already ran once for the configured batch
        self._set_train_batch(found, old_lr * (found / max(old_bs, 1)))
        self.autobatch["train"]["base_lr_after"] = float(self.config.LR_SCHEDULER.BASE_LR)

    def _run_autobatch_val(self) -> None:
        """The largest validation batch under TARGET_MEMORY_FRACTION_VAL
        (reference: DATA.AUTOBATCH.ENABLED_VAL), probed by eval steps under
        ``no_grad``; then the loaders are rebuilt."""
        ab = self.config.DATA.AUTOBATCH
        no_combo = np.zeros((self.meta_dim,), np.float32)

        def run_trial(bs: int) -> None:
            batch = self._zeros_batch(bs)
            with torch.no_grad():
                for _ in range(int(ab.STEPS_PER_TRIAL_VAL)):
                    self._eval_step(self.state, batch, *eval_masks(batch, False, no_combo))

        old_bs = int(self.config.DATA.BATCH_SIZE_VAL)
        found = self._search("val", run_trial, float(ab.TARGET_MEMORY_FRACTION_VAL),
                             int(ab.MIN_BATCH_SIZE_VAL), int(ab.MAX_BATCH_SIZE_VAL))
        self.autobatch["val"]["batch_before"] = old_bs
        if found != old_bs:
            self._set_val_batch(found)

    # ------------------------------------------------------------ resume
    def try_resume(self) -> bool:
        if not self.config.TRAIN.AUTO_RESUME:
            return False
        self.ckpt_writer.wait()  # a same-process save must finalize first
        latest = ckpt.auto_resume_helper(self.ckpt_dir)
        if latest is None:
            return False
        t0 = time.perf_counter()
        self.state, sidecar = ckpt.load_checkpoint(latest, self.state)
        if "training_progress" in sidecar and not bool(
            self.config.TRAIN.PRESERVE_CHECKPOINT_SCHEDULE
        ):
            self.progress.load_state_dict(sidecar["training_progress"])
        if "metrics" in sidecar:
            self.metrics.load_state_dict(sidecar["metrics"])
        if "ops_schedule" in sidecar:
            self.ops_schedule.load_state_dict(sidecar["ops_schedule"])
        if "early_stop" in sidecar:
            self.early_stop.load_state_dict(sidecar["early_stop"])
        # reference parity: resume advertises itself in the config BEFORE
        # any wandb init reads config.to_dict() (checkpoint.py:927,946)
        self.config.defrost()
        self.config.TRAIN.START_EPOCH = int(self.progress.current_epoch)
        self.config.LOADING_FROM_CHECKPOINT = True
        self.config.freeze()
        # wandb run continuity (reference: checkpoint.py:1051-1054)
        run_id = sidecar.get("wandb_run_id")
        if run_id and self.wandb_run is None and self.is_main:
            from linnaeus_tpu_torch.metrics.step_logger import initialize_wandb

            self.wandb_run = initialize_wandb(self.config, resume_run_id=run_id)
            self.step_logger.wandb_run = self.wandb_run
        elif self.wandb_run is not None:
            # a run initialized pre-resume snapshotted the config without
            # the resume stamp — push the update (needs ALLOW_WANDB_VAL_CHANGE)
            try:
                self.wandb_run.config.update(
                    {"LOADING_FROM_CHECKPOINT": True,
                     "RESUMED_AT_EPOCH": int(self.progress.current_epoch)},
                    allow_val_change=bool(
                        self.config.TRAIN.get("ALLOW_WANDB_VAL_CHANGE", False)
                    ),
                )
            except Exception as e:  # wandb policy rejection is non-fatal
                logger.warning(f"wandb config update on resume failed: {e}")
        self.resumed_from = latest
        self.resume_seconds = time.perf_counter() - t0
        logger.info(f"Resumed from {latest} at step {self.progress.global_step}")
        # replay validations that were pending when interrupted
        if self.progress.has_pending_validations() and not self.skip_validation:
            logger.info(
                f"Replaying {len(self.progress.pending_validations)} pending validations"
            )
            self._run_pending_validations()
        return True

    # ---------------------------------------------------------- preemption
    def _on_preempt(self) -> None:
        """Shutdown-registry callback: on SIGUSR1/SIGTERM save an emergency
        checkpoint (incl. pending-validation queue + partial indices) and tag
        the wandb run preempting, then rely on AUTO_RESUME (reference:
        utils/hpc_utils.py:16-43 + main.py signal handlers)."""
        if not self.shutdown.preempted.is_set():
            return
        from linnaeus_tpu_torch.utils.hpc import mark_wandb_preempting

        mark_wandb_preempting(self.wandb_run)
        try:
            self._save_checkpoint()
            self.ckpt_writer.wait()  # durable before the process dies
            logger.warning("Preemption checkpoint saved")
        except Exception as e:
            logger.error(f"Preemption checkpoint failed: {e}")

    # ------------------------------------------------------------ training
    def train(self) -> None:
        self.try_resume()
        start_epoch = self.progress.current_epoch
        for epoch in range(start_epoch, int(self.config.TRAIN.EPOCHS)):
            self.progress.start_epoch(epoch)
            self._train_one_epoch(epoch)
            if self.shutdown.preempted.is_set():
                logger.warning("Preempted; stopping training loop")
                return

            at_boundary = True
            if self.ops_schedule.should_save_checkpoint(at_boundary):
                self._save_checkpoint()
            self._queue_epoch_validations(at_boundary)
            self._run_pending_validations()

            current_lr = float(self.lr_schedule(self.progress.global_step))
            if self.ops_schedule.should_stop_early(
                current_lr=current_lr, early_stop_state=self.early_stop
            ):
                logger.info("Early stopping triggered")
                break
            self.progress.end_epoch()
        self._save_checkpoint()
        self.ckpt_writer.wait()
        self._sync_outputs()
        logger.info("Training complete")

    def _sync_outputs(self) -> None:
        """The output directory to the B2 bucket (utils/remote_sync.py), at
        training end and, under ENV.OUTPUT.BUCKET.SYNC_ON_CHECKPOINT, after
        each checkpoint, from rank 0. No-op unless ENV.OUTPUT.BUCKET.ENABLED;
        a failed upload is logged, as in the TPU package, and training goes
        on."""
        if not self.is_main or not self.config.ENV.OUTPUT.BUCKET.get("ENABLED", False):
            return
        from linnaeus_tpu_torch.utils.remote_sync import sync_to_bucket

        try:
            sync_to_bucket(self.config, self.config.ENV.OUTPUT.DIRS.EXP_BASE)
        except Exception as e:  # a remote outage must not end the run
            logger.error(f"Remote output sync failed: {e}")

    def _profile(self, step: int) -> None:
        """DEBUG.PROFILE.START_STEP / END_STEP: torch.profiler over the
        steps after START_STEP up to END_STEP, its chrome trace written under
        the logs directory. On CUDA the window starts and ends with the
        device idle, and ``profile_summary`` is ``profile_window_summary``
        of it. Tracing the host slows it, so these are the profiled loop's."""
        prof = self.config.DEBUG.PROFILE
        start, end = int(prof.get("START_STEP", 0) or 0), int(prof.get("END_STEP", 0) or 0)
        if end <= start:
            return
        if step == start and self._profiler is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._profile_t0 = time.perf_counter()
            self._profiler.__enter__()
        if step == end and self._profiler is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            wall_ms = 1000.0 * (time.perf_counter() - self._profile_t0) / (end - start)
            self._profiler.__exit__(None, None, None)
            path = f"{self.config.ENV.OUTPUT.DIRS.LOGS}/profile_steps_{start}_{end}.json"
            self._profiler.export_chrome_trace(path)
            if self.device.type == "cuda":
                self.profile_summary = profile_window_summary(
                    profile_events(self._profiler), tracing.summary(since=self._profile_t0),
                    end - start, wall_ms)
                logger.info(f"profiled steps {start + 1}-{end}: {self.profile_summary}")
            self._profiler = None
            logger.info(f"Wrote torch profiler trace for steps {start}-{end} to {path}")

    def _train_one_epoch(self, epoch: int) -> None:
        level = self.ops_schedule.get_mixup_group_level()
        if level in self.bundle["train_dataset"].labels.group_ids:
            self.train_loader.set_group_level(level)
        self.train_loader.set_epoch(epoch)
        self.metrics.reset_phase(MetricsTracker.TRAIN)

        epoch_start = time.perf_counter()
        n_seen = 0
        self.step_times = []
        self.step_logger.start_epoch(len(self.train_loader))
        for batch in self.train_loader:
            step = self.progress.global_step
            self._profile(step)
            combo = None
            if self.ops_schedule.get_partial_mask_enabled(step):
                combo = self.ops_schedule.pick_partial_mask_combo()
            scalars = ScheduleScalars.from_ops_schedule(
                self.ops_schedule, step, self.meta_dim,
                # without a combination the mask is zeros, kept on the device
                # rather than copied there every step
                combo_mask=(self._no_combo if combo is None else
                            combo_to_mask(combo, self.bounds_by_name, self.meta_dim)),
                device=self.device,
            )
            with tracing.span("trainer/iteration", always=True):
                self.state, step_metrics = self._train_step(self.state, batch, scalars)
                self.progress.increment_step()
                n_seen += int(batch["images"].shape[0])
                gn_host = None
                if self.ops_schedule.should_update_gradnorm(self.progress.global_step):
                    if self._gradnorm_update is not None:
                        with tracing.span("trainer/gradnorm"):
                            self.state, gn_metrics = self._gradnorm_update(
                                self.state, batch, scalars)
                            gn_host = {k: v.detach().cpu().numpy()
                                       for k, v in gn_metrics.items()}
            self.step_times.append({"step": self.progress.global_step,
                                    "gradnorm": gn_host is not None})
            if check_debug_flag(self.config, "DEBUG.TRAINING_LOOP"):
                logger.debug(
                    f"[TRAINING_LOOP] step={self.progress.global_step} "
                    f"loss={float(step_metrics['loss']):.6f} "
                    f"grad_norm={float(step_metrics['grad_norm_pre_clip']):.4f} "
                    f"mixed_frac={float(step_metrics['mixed_frac']):.3f}"
                )
            if check_debug_flag(self.config, "DEBUG.SCHEDULING"):
                logger.debug(
                    f"[SCHEDULING] step={step} mix_prob={float(scalars.mix_prob):.4f} "
                    f"meta_mask={float(scalars.meta_mask_prob):.4f} "
                    f"partial_mask={float(scalars.partial_mask_prob):.4f} "
                    f"null_mask={float(scalars.null_mask_prob):.4f} combo={combo}"
                )
            if gn_host is not None:
                if check_debug_flag(
                    self.config, "DEBUG.LOSS.VERBOSE_GRADNORM_LOGGING"
                ) or check_debug_flag(self.config, "DEBUG.LOSS.GRADNORM_METRICS"):
                    logger.debug(
                        f"[GRADNORM] step={self.progress.global_step} "
                        + " ".join(f"{k}={np.asarray(v).tolist()}"
                                   for k, v in sorted(gn_host.items()))
                    )
                self.metrics.log_gradnorm(self.progress.global_step, gn_host)
                flat = {}
                for k, v in gn_host.items():
                    if np.ndim(v) == 0:
                        flat[k] = float(v)
                    else:
                        for i, t in enumerate(self.task_keys):
                            flat[f"{k}/{t}"] = float(np.asarray(v)[i])
                self.step_logger._emit_wandb(flat, self.progress.global_step)

            gstep = self.progress.global_step
            if self.ops_schedule.should_log_to_console(
                gstep
            ) or self.ops_schedule.should_log_to_wandb(gstep):
                host = to_host(step_metrics)
                host = {k: v for k, v in host.items() if not isinstance(v, torch.Tensor)}
                lr_now = float(self.lr_schedule(gstep))
                self.consistency.check_step(gstep, loss=float(host.get("loss", 0.0)))
                # phase-keyed train metrics (reference: MetricsTracker train
                # phase, utils/metrics/tracker.py), sampled at log cadence:
                # reading them every step would wait for the device every step
                self.metrics.update(MetricsTracker.TRAIN, host)
                self.step_logger.log_step_metrics(gstep, epoch, host, lr=lr_now)
                sched_values = {
                    "meta_mask_prob": self.ops_schedule.get_meta_mask_prob(gstep),
                    "mix_prob": self.ops_schedule.get_mixup_prob(gstep),
                    "null_mask_prob": self.ops_schedule.get_null_mask_prob(gstep),
                }
                # per-group LR export (reference:
                # multi_lr_scheduler.py:177 get_lr_dict_for_wandb)
                lr_groups = lr_dict_for_logging(
                    self.config, self.lr_schedule, gstep,
                    group_schedules=self.group_schedules,
                )
                if len(lr_groups) > 1:
                    sched_values.update(lr_groups)
                self.step_logger.log_schedule_values(gstep, sched_values)
            if self.ops_schedule.should_log_lr(gstep):
                self.metrics.log_lr(gstep, float(self.lr_schedule(gstep)))
            if self.ops_schedule.should_log_pipeline_metrics(gstep):
                self.step_logger.log_pipeline_metrics(
                    gstep, self.train_loader.pipeline_metrics()
                )

            limit = int(self.config.DEBUG.EARLY_EXIT_AFTER_N_OPTIMIZER_STEPS or 0)
            if limit and self.progress.global_step >= limit:
                logger.info(f"DEBUG early exit after {limit} steps")
                break
            if self.shutdown.preempted.is_set():
                break

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - epoch_start
        self.epoch_timings[epoch] = self._epoch_timing(elapsed)
        batch_size = max(int(self.config.DATA.BATCH_SIZE), 1)
        self.consistency.check_epoch_boundary(
            epoch, n_seen // batch_size, self.steps_per_epoch
        )
        logger.info(
            f"epoch {epoch} done: {n_seen} samples in {elapsed:.1f}s "
            f"({n_seen / max(elapsed, 1e-9):.1f} img/s); timing "
            f"{json.dumps(self.epoch_timings[epoch])}"
        )

    def _epoch_timing(self, wall_s: float) -> dict:
        """The epoch's timing from ``step_times`` and its ``trainer/iteration``
        spans, taken from the recorder (the device is idle): its steps and
        GradNorm updates, its first step, its wall seconds, the median host
        interval from one step's start to the next (a step as the loop takes
        it: the batch's wait, the launches, the GradNorm update when due),
        and on CUDA the milliseconds between each iteration's two events on
        the stream (the event span, the device's waits for the host
        included), the median of those without a GradNorm update, and their
        sum over the wall time."""
        rows = self.step_times
        spans = tracing.take("trainer/iteration")
        starts = [s.start for s in spans]
        out = {
            "steps": len(rows),
            "first_step": rows[0]["step"] if rows else None,
            "gradnorm_updates": sum(r["gradnorm"] for r in rows),
            "wall_s": wall_s,
            "median_step_ms": (1000.0 * statistics.median(np.diff(starts))
                               if len(starts) > 1 else None),
        }
        if spans and self.device.type == "cuda":
            span_ms = [s.device_ms for s in spans]
            plain = [ms for ms, r in zip(span_ms, rows) if not r["gradnorm"]]
            out.update({
                "event_span_ms_total": float(sum(span_ms)),
                "median_event_span_ms": statistics.median(plain) if plain else None,
                "event_span_share": sum(span_ms) / 1000.0 / wall_s,
            })
        return out

    # ---------------------------------------------------------- validation
    def _queue_epoch_validations(self, at_boundary: bool) -> None:
        if self.skip_validation or self.val_loader is None:
            return
        if self.ops_schedule.should_validate(at_boundary):
            self.progress.queue_validation(TrainingStage.VALIDATION_NORMAL)
        if self.ops_schedule.should_validate_mask_meta(at_boundary):
            self.progress.queue_validation(TrainingStage.VALIDATION_MASK_META)
        if self.ops_schedule.should_validate_partial_mask_meta(at_boundary):
            for combo in self.ops_schedule.get_partial_mask_meta_whitelist():
                self.progress.queue_validation(
                    TrainingStage.VALIDATION_PARTIAL_MASK_META, partial_combo=combo
                )
        if self.ops_schedule.should_run_exhaustive_final_validation():
            comps = self.ops_schedule.get_exhaustive_meta_components()
            for r in range(1, len(comps) + 1):
                for combo in itertools.combinations(comps, r):
                    self.progress.queue_validation(
                        TrainingStage.VALIDATION_PARTIAL_MASK_META,
                        partial_combo=list(combo),
                    )

    def _run_pending_validations(self) -> None:
        # Peek-run-pop (not pop-run): if the process dies mid-validation the
        # entry is still queued in the checkpointed TrainingProgress and the
        # resume path replays it from its partial index (reference:
        # training_progress.py:61-130, main.py:1439-1727).
        while self.progress.has_pending_validations():
            entry = self.progress.pending_validations[0]
            stage = TrainingStage(entry["stage"])
            combo = entry.get("partial_combo")
            self._validate(stage, combo)
            if self.shutdown.preempted.is_set():
                return  # entry stays queued; partial indices checkpointed
            self.progress.pop_validation()

    def _validate(self, stage: TrainingStage, combo: list[str] | None = None) -> None:
        if self.val_loader is None:
            return
        # EXPERIMENT.LOG_LEVEL_VALIDATION: temporarily switch the main
        # logger's level for the duration of a validation pass (reference:
        # main.py:1899-1908). DEBUG.VERBOSE_DEBUG wins — a run that forced
        # DEBUG everywhere must not be demoted exactly where it is debugging.
        val_level = self.config.EXPERIMENT.get("LOG_LEVEL_VALIDATION")
        prev_level = None
        if val_level and not bool(self.config.DEBUG.get("VERBOSE_DEBUG", False)):
            import logging as _logging

            prev_level = logger.level
            logger.setLevel(getattr(_logging, str(val_level).upper(), logger.level))
        t0 = time.perf_counter()
        try:
            self._validate_inner(stage, combo)
        finally:
            if prev_level is not None:
                logger.setLevel(prev_level)
        self.validation_seconds.append((stage.value, time.perf_counter() - t0))

    @contextlib.contextmanager
    def _eval_weights(self):
        """TRAIN.EMA.EVAL: the model holds the EMA weights for the pass and
        its own again after it."""
        if not (self.ema_eval and self.state.ema_params is not None):
            yield
            return
        params = dict(self.model.named_parameters())
        kept = {n: p.detach().clone() for n, p in params.items()}
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(self.state.ema_params[n])
        try:
            yield
        finally:
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(kept[n])

    def _validate_inner(
        self, stage: TrainingStage, combo: list[str] | None = None
    ) -> None:
        self.progress.enter_stage(stage)
        if stage == TrainingStage.VALIDATION_NORMAL:
            phase = MetricsTracker.VAL
            mask_meta, combo_mask = False, np.zeros((self.meta_dim,), np.float32)
        elif stage == TrainingStage.VALIDATION_MASK_META:
            phase = MetricsTracker.VAL_MASK_META
            mask_meta, combo_mask = True, np.zeros((self.meta_dim,), np.float32)
        else:
            phase = MetricsTracker.partial_mask_phase(combo or [])
            mask_meta = False
            combo_mask = combo_to_mask(combo, self.bounds_by_name, self.meta_dim)

        self.metrics.reset_phase(phase)
        # mid-validation resume: restore partial accumulators if this pass
        # was interrupted (reference: training_progress.py partial indices)
        partial = self.progress.partial_validation_indices.get(phase)
        if isinstance(partial, dict):
            start_index = int(partial.get("next_index", 0))
            totals = dict(partial.get("totals", {}))
            count = float(partial.get("count", 0.0))
            chain_correct = float(partial.get("chain_correct", 0.0))
            chain_total = float(partial.get("chain_total", 0.0))
            if start_index:
                logger.info(f"[{phase}] resuming validation at batch {start_index}")
        else:
            start_index = 0
            totals = {}
            count = 0.0
            chain_correct = 0.0
            chain_total = 0.0
        with self._eval_weights():
            for i, batch in enumerate(self.val_loader):
                if i < start_index:
                    continue
                if self.shutdown.preempted.is_set():
                    # partial accumulators stay in TrainingProgress for resume
                    return
                metrics, outputs = self._eval_step(
                    self.state, batch, *eval_masks(batch, mask_meta, combo_mask))
                cc, ct = chain_accuracy_counts(
                    outputs, soft_targets(batch["targets"], self.num_classes), self.task_keys)
                host = to_host({**metrics, "_chain_correct": cc, "_chain_total": ct})
                ranks = [host]
                if self.mesh.group("data") is not None:
                    # every data rank's share of the batch, added in rank order
                    ranks = [None] * self.mesh.data
                    torch.distributed.all_gather_object(ranks, host,
                                                        group=self.mesh.group("data"))
                host = ranks[0]
                chain_correct += sum(float(h.pop("_chain_correct")) for h in ranks)
                chain_total += sum(float(h.pop("_chain_total")) for h in ranks)
                if check_debug_flag(self.config, "DEBUG.VALIDATION_METRICS"):
                    logger.debug(
                        f"[VALIDATION_METRICS] {phase} batch={i} "
                        + " ".join(f"{k}={float(v):.4f}" for k, v in sorted(host.items()))
                    )
                for h in ranks:
                    totals, count = accumulate_batch(totals, count, h)
                self.progress.partial_validation_indices[phase] = {
                    "next_index": i + 1,
                    "totals": dict(totals),
                    "count": count,
                    "chain_correct": chain_correct,
                    "chain_total": chain_total,
                }
        self.progress.partial_validation_indices.pop(phase, None)

        if count == 0:
            return
        summary = summarize_totals(totals, count, chain_correct, chain_total)
        self.metrics.update(phase, summary, n=count)
        if check_debug_flag(self.config, "DEBUG.DUMP_METRICS"):
            dump_path = (
                f"{self.config.ENV.OUTPUT.DIRS.LOGS}/metrics_state_"
                f"{self.progress.global_step}.json"
            )
            with open(dump_path, "w") as f:
                json.dump(self.metrics.state_dict(), f, indent=2, default=str)
            logger.debug(f"[DUMP_METRICS] wrote {dump_path}")
        improved = self.metrics.check_best(phase, self.progress.current_epoch)
        if phase == MetricsTracker.VAL:
            self.early_stop.update(
                self._early_stop_metric(summary), self.progress.global_step,
                min_delta=self.config.TRAIN.EARLY_STOP.get("MIN_DELTA"),
            )
        logger.info(
            f"[{phase}] step {self.progress.global_step} "
            + " ".join(f"{k}={v:.4f}" for k, v in sorted(summary.items()))
            + (" (best)" if improved else "")
        )
        self.step_logger.log_validation(self.progress.global_step, phase, summary)
        self.progress.enter_stage(TrainingStage.TRAINING)

    def _early_stop_metric(self, summary: dict[str, float]) -> float:
        """Resolve TRAIN.EARLY_STOP.METRIC against the validation summary
        (reference: ops_schedule.py:216 pulls the configured metric from the
        tracker, e.g. 'val_loss' or 'val_chain_accuracy'). Accepts the
        reference's 'val_*' / 'val/*' prefixes; summary keys themselves
        ('loss', 'chain_accuracy', 'acc1/taxa_L10') also work."""
        name = self.early_stop.metric_name
        key = name
        for prefix in ("val_", "val/"):
            if key.lower().startswith(prefix):
                key = key[len(prefix):]
                break
        if key in summary:
            return float(summary[key])
        if not getattr(self, "_warned_es_metric", False):
            self._warned_es_metric = True
            logger.warning(
                f"TRAIN.EARLY_STOP.METRIC={name!r} not found in validation "
                f"summary (keys: {sorted(summary)}); falling back to loss"
            )
        fallback = summary.get("loss", float("inf"))
        return float(-fallback if self.early_stop.higher_is_better else fallback)

    # ---------------------------------------------------------- checkpoint
    def _save_checkpoint(self) -> str:
        if check_debug_flag(self.config, "DEBUG.CHECKPOINT"):
            logger.debug(
                f"[CHECKPOINT] saving step={self.state.step} "
                f"param_tensors={len(list(self.model.parameters()))} dir={self.ckpt_dir}"
            )
        metric = self.metrics.get(MetricsTracker.VAL, "loss")
        wandb_run_id = getattr(self.wandb_run, "id", None) if self.wandb_run else None
        # every rank takes the snapshot (a sharded state is gathered whole);
        # rank 0 alone writes it
        # (an FSDP2 model may be between a forward and a backward, unsharded:
        # the config says whether it gathers; a share of the model axis is
        # tagged for good)
        sharded = (self.mesh.device_mesh is not None
                   and str(self.config.PARALLEL.get("PARAM_SHARDING", "replicated")) == "fsdp"
                   ) or any(getattr(p, "share", None) is not None
                            for p in self.model.parameters())
        if not self.is_main:
            if sharded:
                ckpt.snapshot_state(self.state)  # its part of the gathers
            return os.path.join(os.path.abspath(self.ckpt_dir),
                                f"checkpoint_step_{int(self.state.step):010d}")
        snapshot = ckpt.snapshot_state(self.state)
        path = self.ckpt_writer.save(
            self.ckpt_dir,
            snapshot,
            training_progress=self.progress,
            metrics_state=self.metrics.state_dict(),
            ops_schedule_state=self.ops_schedule.state_dict(),
            early_stop_state=self.early_stop.state_dict(),
            config_dump=self.config.dump(),
            metric_value=metric,
            wandb_run_id=wandb_run_id,
            batch={"BATCH_SIZE": int(self.config.DATA.BATCH_SIZE),
                   "BATCH_SIZE_VAL": int(self.config.DATA.BATCH_SIZE_VAL),
                   "BASE_LR": float(self.config.LR_SCHEDULER.BASE_LR)},
        )
        if self.config.ENV.OUTPUT.BUCKET.get("SYNC_ON_CHECKPOINT", False):
            self.ckpt_writer.wait()  # upload only finalized files
            self._sync_outputs()
        sc = self.config.SCHEDULE.CHECKPOINT
        ckpt.manage_checkpoints(
            self.ckpt_dir,
            keep_top_n=int(sc.KEEP_TOP_N),
            keep_last_n=int(sc.KEEP_LAST_N),
            higher_is_better=False,
            # the just-saved checkpoint may still be flushing async; it
            # faces retention on the next save
            protect=[path],
        )
        return path
