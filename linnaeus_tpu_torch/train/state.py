"""TrainState: everything one optimizer step reads and changes.

Port of linnaeus_tpu/train/state.py. Where the TPU package carries a pytree
of arrays through a pure step, this state holds live objects that the step
updates in place: the model (float32 parameters), the optimizer with its
moments, the step counter, the GradNorm state, the ``torch.Generator`` that
every random draw of a step comes from (so a run is reproducible from its
seed) and, optionally, an exponential moving average of the parameters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from linnaeus_tpu_torch.loss.gradnorm import GradNormState, init_gradnorm_state
from linnaeus_tpu_torch.models.blocks.common import DropPath


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    gradnorm: GradNormState
    generator: torch.Generator
    # step -> learning rate, written into the optimizer's groups before each
    # update; None keeps the optimizer's own rate
    lr_schedule: Callable[[int], float] | None = None
    # exponential moving average of the parameters by name (None: disabled)
    ema_params: dict[str, torch.Tensor] | None = None

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients on the parameters, at the
        schedule's rate for this step; advances the step counter."""
        if self.lr_schedule is not None:
            lr = float(self.lr_schedule(self.step))
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def create_train_state(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    num_tasks: int,
    generator: torch.Generator,
    init_task_weights=None,
    lr_schedule: Callable[[int], float] | None = None,
    ema: bool = False,
) -> TrainState:
    """``generator`` must live on the model's device; it is handed to every
    DropPath of the model, so stochastic depth draws from it too."""
    device = next(model.parameters()).device
    if generator.device.type != device.type:
        raise ValueError(
            f"create_train_state: the generator is on {generator.device}, the model on {device}"
        )
    for module in model.modules():
        if isinstance(module, DropPath):
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
