"""The training traffic's driver for a model with expert layers (kind
``train_moe``): ``train.py``'s driver, the program's step driven the same
way, with three differences.

- The reference is ``reference/model_moe.py`` and ``reference/train_moe.py``.
- In the three checked steps a forward hook on each of the program's
  ``MoEMlp`` layers records the program's routing: it runs the layer's own
  ``capacity`` and ``route`` again on the layer's input with its router
  (exact with router noise 0, which the reference requires). The reference
  then follows the three steps under the program's experts (``model_moe``'s
  routing operand) and queues them for its own capacity, so a near-tied
  token that bfloat16 and float32 activations send to different experts,
  and the capacity drops that follow it down the queue, no longer stand
  between the two sides' gradients, while the drops stay the reference's.
  The routing itself is compared apart, by three more numbers
  (``compare``).
- A traced run also reads the expert products' device time: two more steps
  profiled on host and device, the device time of the operations
  ``aten::baddbmm`` (the experts' two products, forward) and
  ``BaddbmmBackward0`` (their backward), which no other layer of the model
  calls, as ``ctx["experts_ms"]`` a step.
"""

from __future__ import annotations

import torch

from benchmark import common, data
from benchmark.drivers import train as base
from benchmark.reference import model_moe as ref_moe
from benchmark.reference import train_moe as ref_train

# the expert products' operations in the profiler's events (forward, backward)
EXPERT_OPS = ("aten::baddbmm", "BaddbmmBackward0",
              "autograd::engine::evaluate_function: BaddbmmBackward0")


def watch_routing(model) -> tuple[list, list]:
    """Forward hooks on every ``MoEMlp`` of ``model``: each call appends
    the layer's ``(experts, keep, probs at experts)`` (B, N, k) to the list
    returned beside the hooks' handles."""
    from linnaeus_tpu_torch.models.blocks import moe

    seen: list[tuple] = []

    def hook(layer, args, output):
        if layer.noise_std > 0.0:
            raise ValueError("router noise: the hook cannot repeat the layer's draw")
        x = args[0]
        with torch.no_grad():
            logits = x.float() @ layer.router.float()
            cap = moe.capacity(x.shape[1], layer.num_experts, layer.top_k, layer.capacity_factor)
            probs, _, experts, _, keep = moe.route(logits, layer.top_k, cap)
        seen.append((experts, keep, probs.gather(-1, experts)))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, moe.MoEMlp)]
    return handles, seen


def expert_device_ms(events) -> float | None:
    """Device ms of the profiler's ``EXPERT_OPS`` events, each counted once
    (one inside another of them is the outer one's); None without one."""
    total, found = 0.0, False
    for e in events:
        if e.name not in EXPERT_OPS:
            continue
        parent = e.cpu_parent
        while parent is not None and parent.name not in EXPERT_OPS:
            parent = parent.cpu_parent
        if parent is None:
            total += e.device_time_total / 1e3
            found = True
    return total if found else None


class TrainMoEDriver(base.TrainDriver):
    def __init__(self, doc: dict, traffic: dict, seed: int, device):
        self.doc, self.traffic, self.seed, self.device = doc, traffic, int(seed), device
        self.num_classes = dict(doc["num_classes"])
        self.spec = ref_moe.spec_from_config(doc["config"], self.num_classes)
        self.batch = int(traffic["batch"])
        self.total_steps = int(doc["total_steps"])
        self.seeds = {k: common.subseed(seed, k) for k in ("weights", "step", "data", "tree")}

    def setup(self) -> None:
        from linnaeus_tpu_torch.ops_schedule import OpsSchedule, TrainingProgress
        from linnaeus_tpu_torch.train.build import build_training
        from linnaeus_tpu_torch.train.step import ScheduleScalars
        from linnaeus_tpu_torch.utils.schedule_utils import resolve_all_schedule_params

        cfg = base.program_config(self.doc)
        resolve_all_schedule_params(cfg, self.total_steps)
        self.ops = OpsSchedule(cfg, TrainingProgress(expected_total_steps=self.total_steps))
        self.parts = build_training(cfg, self.num_classes, device=self.device,
                                    seed=self.seeds["step"], total_steps=self.total_steps,
                                    steps_per_epoch=max(self.total_steps // int(cfg.TRAIN.EPOCHS), 1))
        weights = common.make_weights(ref_moe.param_shapes(self.spec), self.seeds["weights"],
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

    def _first_steps(self, weights: dict) -> dict:
        """``train.py``'s readings of the checked steps, and under ``route``
        the program's own ``(experts, keep, probs at experts)``, a list of
        layers a step; ``self.held`` keeps its experts."""
        handles, seen = watch_routing(self.parts.model)
        try:
            out = super()._first_steps(weights)
        finally:
            for h in handles:
                h.remove()
        per = len(seen) // base.CHECKED_STEPS
        steps = [seen[i * per:(i + 1) * per] for i in range(base.CHECKED_STEPS)]
        self.held = [[e for e, _, _ in s] for s in steps]
        out["route"] = steps
        return out

    def traced(self) -> dict:
        from torch.profiler import ProfilerActivity, profile

        ctx = super().traced()
        steps = 2
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                self.step()
            self._sync()
        ms = expert_device_ms(prof.events())
        return dict(ctx, kind="train_moe", experts_ms=None if ms is None else ms / steps)

    def holding(self, i: int, rows: int):
        """Step ``i``'s program routing of the first ``rows`` images, or None
        (the reference routes by itself) where the program took fewer."""
        held = self.held[i]
        if any(e.shape[0] < rows for e in held):
            return None
        return [e[:rows] for e in held]

    def reference(self, quant: bool = False, hold: bool = True) -> dict:
        """The reference's readings of the first three steps, under the
        program's routing (``hold``) or its own."""
        weights = common.make_weights(ref_moe.param_shapes(self.spec), self.seeds["weights"],
                                      self.device)
        trainer = ref_train.Trainer(weights, self.spec, self.doc["config"], self.total_steps,
                                    self.seeds["step"], self.device, quant=quant)
        kept = {"loss": [], "norm_pre": [], "norm_post": [], "route": []}
        for i in range(base.CHECKED_STEPS):
            batch = self.ring[i % len(self.ring)]
            routing = self.holding(i, batch["images"].shape[0]) if hold else None
            out = trainer.train_step(batch, routing=routing)
            for key in kept:
                kept[key].append(out[key])
            if i == 0:
                grads = {n: float(g.norm()) for n, g in out["grads"].items()}
        change = {n: float((trainer.W[n].detach() - weights[n]).norm()) for n in weights}
        return dict(kept, grad=grads, change=change)

    def check(self, limits: dict) -> tuple[bool, dict]:
        with base.no_tf32():
            ref = self.reference()
        return base.judge(compare(self.recorded, ref), limits)


DRIVER = TrainMoEDriver


def compare(got: dict, ref: dict) -> dict:
    """``train.compare``'s numbers and three of the routing, over the
    three steps' expert layers and the images both sides saw:
    ``route_flip_share``, the share of (token, choice) whose expert in
    ``got``'s own ranking differs from the one in ``ref``'s;
    ``keep_mismatch_share``, the share whose capacity drop differs (under
    the held routing both queue the same experts, so any is the program's
    capacity or queue at fault); and ``router_prob_gap``, the worst layer
    and step's median over (token, choice) of the gap of the probability at
    the expert used over ``ref``'s."""
    out = base.compare(got, ref)
    flips, kept, total, gaps = 0, 0, 0, []
    for got_step, ref_step in zip(got["route"], ref["route"]):
        for (g_own, g_keep, g_p), (r_own, r_keep, r_p) in zip(got_step, ref_step):
            rows = min(g_own.shape[0], r_own.shape[0])
            flips += int((g_own[:rows] != r_own[:rows]).sum())
            kept += int((g_keep[:rows] != r_keep[:rows]).sum())
            total += g_own[:rows].numel()
            gap = (g_p[:rows] - r_p[:rows]).abs() / r_p[:rows]
            gaps.append(float(gap.median()))
    out["route_flip_share"] = flips / total if total else None
    out["keep_mismatch_share"] = kept / total if total else None
    out["router_prob_gap"] = max(gaps) if gaps else None
    return out
