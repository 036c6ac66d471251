"""TrainState: everything one optimizer step reads and changes.

Port of linnaeus_tpu/train/state.py. Where the TPU package carries a pytree
of arrays through a pure step, this state holds live objects that the step
updates in place: the model (float32 parameters), the optimizer with its
moments, the step counter, the GradNorm state, the ``torch.Generator`` that
every random draw of a step comes from (so a run is reproducible from its
seed), optionally an exponential moving average of the parameters, and,
for the GradNorm update, the generator's state before each collate of the
last train step, from which that step's batch is collated again.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping

import torch
from torch import nn

from linnaeus_tpu_torch.loss.gradnorm import GradNormState, init_gradnorm_state
from linnaeus_tpu_torch.models.blocks.common import Dropout, DropPath
from linnaeus_tpu_torch.models.blocks.moe import MoEMlp
from linnaeus_tpu_torch.models.heads.heads import MultiTaskHeads

Schedule = Callable[[int], float]


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    gradnorm: GradNormState
    generator: torch.Generator
    # step -> learning rate, or a mapping of parameter-group label ->
    # schedule (optim/schedules.py::build_group_schedules, "default" for the
    # labels without one of their own); each optimizer group's rate is set
    # from its label's schedule times its ``lr_multiplier`` before each
    # update. None keeps the optimizer's own rates.
    lr_schedule: Schedule | Mapping[str, Schedule] | None = None
    # exponential moving average of the parameters by name (None: disabled)
    ema_params: dict[str, torch.Tensor] | None = None
    # the generator's state before each microbatch's collate in the last
    # train step (a few bytes each), from which the GradNorm re-forward
    # collates that step's batch again (train/step.py); None before a step
    collate_rng: list[torch.Tensor] | None = None

    def group_lr(self, group: Mapping, step: int) -> float:
        """The rate of optimizer param group ``group`` at ``step``."""
        sched = self.lr_schedule
        if not callable(sched):
            sched = sched.get(group.get("label", "default"), sched["default"])
        return float(sched(step)) * float(group.get("lr_multiplier", 1.0))

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients on the parameters, at the
        schedules' rates for this step; advances the step counter."""
        if self.lr_schedule is not None:
            for group in self.optimizer.param_groups:
                group["lr"] = self.group_lr(group, self.step)
        self.optimizer.step()
        self.step += 1


def create_train_state(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    num_tasks: int,
    generator: torch.Generator,
    init_task_weights=None,
    lr_schedule: Schedule | Mapping[str, Schedule] | None = None,
    ema: bool = False,
) -> TrainState:
    """``generator`` must live on the model's device; it is handed to every
    DropPath and Dropout of the model, so stochastic depth and dropout draw
    from it too, to its MoE MLPs' router noise, and to its heads, whose
    gumbel routing draws from it."""
    device = next(model.parameters()).device
    if generator.device.type != device.type:
        raise ValueError(
            f"create_train_state: the generator is on {generator.device}, the model on {device}"
        )
    for module in model.modules():
        if isinstance(module, (DropPath, Dropout, MoEMlp, MultiTaskHeads)):
            module.generator = generator
    return TrainState(
        step=0,
        model=model,
        optimizer=optimizer,
        gradnorm=init_gradnorm_state(num_tasks, init_task_weights, device=device),
        generator=generator,
        lr_schedule=lr_schedule,
        # the average starts at a copy of the initial parameters
        ema_params=(
            {n: p.detach().clone() for n, p in model.named_parameters()} if ema else None
        ),
    )
