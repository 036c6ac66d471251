"""TrainState: everything one optimizer step reads and changes.

Port of linnaeus_tpu/train/state.py. Where the TPU package carries a pytree
of arrays through a pure step, this state holds live objects that the step
updates in place: the model (float32 parameters), the optimizer with its
moments, the step counter, the GradNorm state, the ``torch.Generator`` that
every random draw of a step comes from (so a run is reproducible from its
seed), optionally an exponential moving average of the parameters, and,
for the GradNorm update, the collated tensors the last train step consumed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, NamedTuple

import torch
from torch import nn

from linnaeus_tpu_torch.loss.gradnorm import GradNormState, init_gradnorm_state
from linnaeus_tpu_torch.models.blocks.common import Dropout, DropPath
from linnaeus_tpu_torch.models.heads.heads import MultiTaskHeads

Schedule = Callable[[int], float]


class Collated(NamedTuple):
    """What a train step's forward consumed, after [0, 1] conversion,
    augmentation, mixing and meta-masking: images in the model's compute
    dtype (its first op casts to it, so the forward is the same), soft
    targets by task, and the metadata or None."""

    images: torch.Tensor
    targets: dict[str, torch.Tensor]
    meta: torch.Tensor | None


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
    # the collated tensors of the last train step (train/step.py, kept when
    # GradNorm is to re-forward them), else None
    last_collated: Collated | None = None

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
    from it too, and to its heads, whose gumbel routing draws from it."""
    device = next(model.parameters()).device
    if generator.device.type != device.type:
        raise ValueError(
            f"create_train_state: the generator is on {generator.device}, the model on {device}"
        )
    for module in model.modules():
        if isinstance(module, (DropPath, Dropout, MultiTaskHeads)):
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
