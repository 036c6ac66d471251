"""The training traffic's driver: the program's training step, fed as the
Trainer feeds it, without its loader.

Set-up builds the step ``train/build.py::build_training`` makes from the
configuration file (over the program's defaults), loads the benchmark's
weights into it, puts a ring of distinct seeded batches on the device and
takes the mix's first steps through the window's own call: the first three
are recorded for the correctness check (each step's loss and its global
gradient norm before and after the clip, as the step reports them; each
leaf's first gradient as AdamW holds it after one step,
``exp_avg / (1 - beta1)``; each leaf's change after three). The window then runs the same object on, step
after step, each with the schedules' per-step values
(``ScheduleScalars.from_ops_schedule``, as the Trainer computes them), until
the seconds are up and the card has finished. The reference
(benchmark/reference/train.py) then follows the first three steps from the
same weights, batches and seeds.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import common, data
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train

CHECKED_STEPS = 3


def program_config(doc: dict):
    """The program's config: its defaults under the configuration file."""
    from linnaeus_tpu_torch.configuration import get_default_config
    from linnaeus_tpu_torch.configuration.cfg_node import CfgNode
    from linnaeus_tpu_torch.configuration.utils import merge_configs

    return merge_configs(get_default_config(), CfgNode(doc["config"]))


class TrainDriver:
    def __init__(self, doc: dict, traffic: dict, seed: int, device):
        self.doc, self.traffic, self.seed, self.device = doc, traffic, int(seed), device
        self.num_classes = dict(doc["num_classes"])
        self.spec = ref_model.spec_from_config(doc["config"], self.num_classes)
        self.batch = int(traffic["batch"])
        self.total_steps = int(doc["total_steps"])
        self.seeds = {k: common.subseed(seed, k) for k in ("weights", "step", "data", "tree")}

    # ------------------------------------------------------------------ set-up
    def setup(self) -> None:
        from linnaeus_tpu_torch.ops_schedule import OpsSchedule, TrainingProgress
        from linnaeus_tpu_torch.train.build import build_training
        from linnaeus_tpu_torch.train.step import ScheduleScalars
        from linnaeus_tpu_torch.utils.schedule_utils import resolve_all_schedule_params

        cfg = program_config(self.doc)
        resolve_all_schedule_params(cfg, self.total_steps)
        self.ops = OpsSchedule(cfg, TrainingProgress(expected_total_steps=self.total_steps))
        self.parts = build_training(cfg, self.num_classes, device=self.device,
                                    seed=self.seeds["step"], total_steps=self.total_steps,
                                    steps_per_epoch=max(self.total_steps // int(cfg.TRAIN.EPOCHS), 1))
        weights = common.make_weights(ref_model.param_shapes(self.spec), self.seeds["weights"],
                                      self.device)
        self.parts.model.load_state_dict(weights, strict=True)
        self.hierarchy = data.taxonomy(self.num_classes, self.seeds["tree"])
        self.ring = data.train_ring(self.spec, self.hierarchy, self.batch,
                                    int(self.traffic["ring"]), self.seeds["data"], self.device)
        self.combo = torch.zeros(self.parts.meta_dim, device=self.device)
        self.scalars = lambda step: ScheduleScalars.from_ops_schedule(
            self.ops, step, self.parts.meta_dim, combo_mask=self.combo, device=self.device)
        self.fed = 0
        self.recorded = self._first_steps(weights)
        del weights
        for _ in range(int(self.traffic["warmup_steps"])):
            self.step()
        self._sync()

    def step(self) -> dict:
        state = self.parts.state
        batch = self.ring[self.fed % len(self.ring)]
        self.fed += 1
        _, metrics = self.parts.train_step(state, batch, self.scalars(state.step))
        return metrics

    def _first_steps(self, weights: dict) -> dict:
        model, opt = self.parts.model, self.parts.state.optimizer
        kept = {"loss": [], "norm_pre": [], "norm_post": []}
        for i in range(CHECKED_STEPS):
            metrics = self.step()
            for key, name in (("loss", "loss"), ("norm_pre", "grad_norm_pre_clip"),
                              ("norm_post", "grad_norm_post_clip")):
                kept[key].append(metrics[name].detach())
            if i == 0:
                beta1 = float(self.doc["config"]["OPTIMIZER"]["BETAS"][0])
                # a leaf the optimizer holds no moment of got no gradient
                grads = {n: (opt.state[p]["exp_avg"].norm() / (1.0 - beta1)
                             if "exp_avg" in opt.state.get(p, {}) else torch.zeros(()))
                         for n, p in model.named_parameters()}
        change = {n: (p.detach() - weights[n]).norm() for n, p in model.named_parameters()}
        out = {k: [float(v) for v in vals] for k, vals in kept.items()}
        out["grad"] = {n: float(v) for n, v in grads.items()}
        out["change"] = {n: float(v) for n, v in change.items()}
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ window
    def window(self, seconds: float) -> dict:
        self._sync()
        t0 = time.perf_counter()
        steps = 0
        while time.perf_counter() - t0 < seconds:
            self.step()
            steps += 1
        self._sync()
        wall = time.perf_counter() - t0
        self.window_facts = {"steps": steps, "seconds": wall, "images": steps * self.batch}
        return {"train_img_per_s": steps * self.batch / wall}

    def traced(self) -> dict:
        """What the per-layer readers read: the mix's ``trace_steps`` more
        steps traced on the device alone (the profiler then costs the host
        little), after two it sees but does not record; then two steps
        traced on the host too, for torch.optim's ranges and what the host
        did in the gaps."""
        from torch.profiler import ProfilerActivity, profile, schedule

        def traced_steps(activities, n):
            with profile(activities=activities,
                         schedule=schedule(wait=0, warmup=2, active=n, repeat=1)) as prof:
                for i in range(2):
                    self.step()
                    if i == 1:  # the device idle when recording starts
                        self._sync()
                    prof.step()
                for i in range(n):
                    self.step()
                    if i == n - 1:
                        self._sync()
                    prof.step()
            return common.Trace(prof)

        steps = int(self.traffic["trace_steps"])
        device_trace = traced_steps([ProfilerActivity.CUDA], steps)
        host_trace = traced_steps([ProfilerActivity.CPU, ProfilerActivity.CUDA], 2)
        return {"kind": "train", "trace": device_trace, "traced_steps": steps,
                "host_trace": host_trace, "host_steps": 2,
                "window": self.window_facts, "batch": self.batch, "spec": self.spec}

    # ------------------------------------------------------------------ check
    def release(self) -> None:
        del self.parts, self.ops, self.scalars
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, quant: bool = False) -> dict:
        """The reference's readings of the first three steps."""
        weights = common.make_weights(ref_model.param_shapes(self.spec), self.seeds["weights"],
                                      self.device)
        trainer = ref_train.Trainer(weights, self.spec, self.doc["config"], self.total_steps,
                                    self.seeds["step"], self.device, quant=quant)
        kept = {"loss": [], "norm_pre": [], "norm_post": []}
        for i in range(CHECKED_STEPS):
            out = trainer.train_step(self.ring[i % len(self.ring)])
            for key in kept:
                kept[key].append(out[key])
            if i == 0:
                grads = {n: float(g.norm()) for n, g in out["grads"].items()}
        change = {n: float((trainer.W[n].detach() - weights[n]).norm()) for n in weights}
        return dict(kept, grad=grads, change=change)

    def counts(self) -> tuple[int, int]:
        return self.window_facts["steps"], 0

    def check(self, limits: dict) -> tuple[bool, dict]:
        with no_tf32():
            ref = self.reference()
        numbers = compare(self.recorded, ref)
        return judge(numbers, limits)


DRIVER = TrainDriver


class no_tf32:
    """float32 products in float32 for the reference, the setting restored."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def compare(got: dict, ref: dict) -> dict:
    """The numbers the check can compare: the worst step's gap of the loss,
    of the global gradient norm before the clip (``grad_norm_gap``) and after
    it (``clip_norm_gap``, which also takes step one's gradient as AdamW
    holds it, the norm of every leaf's ``exp_avg / (1 - beta1)``), each over
    the reference's; by leaf, the gap of the first gradient's norm and of
    the change's norm over the reference's norm of that leaf or of the
    median leaf, whichever is larger, read at the worst leaf and at the
    median leaf. Leaves whose reference gradient is under a thousandth of
    the median leaf's (nought but for rounding, as a bias under the final
    LayerNorm) are left out."""
    def worst(a: list, b: list) -> float:
        return max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a, b))

    held = float(np.sqrt(sum(v * v for v in got["grad"].values())))
    g_med = float(np.median([ref["grad"][n] for n in ref["grad"]]))
    moving = [n for n in ref["grad"] if ref["grad"][n] >= 1e-3 * g_med]
    out = {"loss_gap": worst(got["loss"], ref["loss"]),
           "grad_norm_gap": worst(got["norm_pre"], ref["norm_pre"]),
           "clip_norm_gap": worst(got["norm_post"] + [held], ref["norm_post"] + ref["norm_post"][:1])}
    for key in ("grad", "change"):
        r = np.array([ref[key][n] for n in moving])
        g = np.array([got[key][n] for n in moving])
        gaps = np.abs(g - r) / np.maximum(r, float(np.median(r)))
        out[f"{key}_leaf_gap"] = float(gaps.max())
        out[f"{key}_median_gap"] = float(np.median(gaps))
        out[f"_worst_{key}_leaf"] = moving[int(np.argmax(gaps))]
    out["_left_out"] = len(ref["grad"]) - len(moving)
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each limited number beside its limit; correct when every one was
    read, is finite and is within its limit."""
    shown = {k: {"value": None if numbers.get(k) is None else float(numbers[k]), "limit": lim}
             for k, lim in limits.items()}
    ok = all(v["value"] is not None and np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in shown.values())
    return ok, shown
