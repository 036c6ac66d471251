"""Optimizer construction from config.

Port of linnaeus_tpu/optim/build.py for its single-group AdamW: decoupled
weight decay that skips one-dimensional parameters (biases, norm scales),
over ``torch.optim.AdamW`` with two parameter groups. The learning rate is
set on the groups before every update by the train step, from the
schedule. SGD, Muon, AdEMAMix and multi-group configs are not ported yet
and raise.
"""

from __future__ import annotations

from typing import Iterable

import torch
from torch import nn

from .schedules import Schedule


def _no_decay_mask(named_parameters: Iterable[tuple[str, torch.Tensor]]) -> dict[str, bool]:
    """name -> True where decoupled weight decay applies: parameters of more
    than one dimension. Biases, norm scales and layer scales are skipped."""
    return {name: p.dim() > 1 for name, p in named_parameters}


def build_optimizer(
    config,
    schedule: Schedule | float,
    model: nn.Module,
) -> torch.optim.Optimizer:
    """AdamW over the trainable parameters of ``model`` in two groups (decay,
    no decay). ``schedule`` gives the initial learning rate (its value at
    step 0, or the number itself)."""
    opt = config.OPTIMIZER
    pg = opt.get("PARAMETER_GROUPS", {})
    if pg and pg.get("ENABLED", False):
        raise NotImplementedError(
            "OPTIMIZER.PARAMETER_GROUPS is not ported yet: multi-group optimizers come "
            "with the Trainer (train/loop.py)"
        )
    name = str(opt.NAME).lower()
    if name in ("sgd", "muon", "ademamix"):
        raise NotImplementedError(
            f"OPTIMIZER.NAME '{name}' is not ported yet: a later change ports the "
            "optimizers beyond AdamW"
        )
    if name != "adamw":
        raise ValueError(f"Unknown OPTIMIZER.NAME '{name}'")
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    decays = _no_decay_mask(named)
    betas = tuple(opt.BETAS)
    lr = float(schedule(0) if callable(schedule) else schedule)
    groups = [
        {"params": [p for n, p in named if decays[n]], "weight_decay": float(opt.WEIGHT_DECAY)},
        {"params": [p for n, p in named if not decays[n]], "weight_decay": 0.0},
    ]
    return torch.optim.AdamW(
        groups, lr=lr, betas=(float(betas[0]), float(betas[1])), eps=float(opt.EPS),
    )
