"""Optimizer construction from config.

Port of linnaeus_tpu/optim/build.py: AdamW, SGD (Nesterov), Muon and
AdEMAMix, alone or per parameter group (OPTIMIZER.PARAMETER_GROUPS). Each
parameter carries one label: the first group whose FILTER selects it
(utils/param_filters.py, evaluated on the Flax path and layout), else
"default". Where the TPU package maps the labels onto
``optax.multi_transform``, the port builds one torch optimizer per label
and steps them side by side (:class:`MultiOptimizer`). Every param group
carries its ``label`` and ``lr_multiplier``; the train state sets each
group's rate before every update from the label's schedule times the
multiplier (train/state.py), as the TPU package scales each group's
schedule.

Weight decay is decoupled. AdamW and SGD skip parameters of one dimension
(biases, norm scales, layer scales); Muon and AdEMAMix decay every
parameter, as the TPU package chains their decay without a mask.
"""

from __future__ import annotations

import logging
from collections import ChainMap
from typing import Callable, Iterable, Mapping

import torch
from torch import nn

from linnaeus_tpu_torch.utils.convert import jax_layouts
from linnaeus_tpu_torch.utils.param_filters import (
    build_filter_from_config,
    filtering_report,
    param_labels,
)

from .ademamix import AdEMAMix
from .muon import Muon
from .schedules import Schedule

logger = logging.getLogger(__name__)


def _no_decay_mask(named_parameters: Iterable[tuple[str, torch.Tensor]]) -> dict[str, bool]:
    """name -> True where decoupled weight decay applies: parameters of more
    than one dimension. Biases, norm scales and layer scales are skipped."""
    return {name: p.dim() > 1 for name, p in named_parameters}


class MultiOptimizer:
    """One optimizer per parameter-group label, stepped together: the
    port's ``optax.multi_transform``. ``param_groups`` and ``state`` read
    through to the optimizers inside."""

    def __init__(self, optimizers: Mapping[str, torch.optim.Optimizer]):
        self.optimizers = dict(optimizers)

    @property
    def param_groups(self) -> list[dict]:
        return [g for opt in self.optimizers.values() for g in opt.param_groups]

    @property
    def state(self) -> ChainMap:
        return ChainMap(*(opt.state for opt in self.optimizers.values()))

    def step(self) -> None:
        for opt in self.optimizers.values():
            opt.step()


def _make_single(
    name: str,
    config,
    named: list[tuple[str, torch.Tensor]],
    layouts: Mapping[str, Callable],
    lr: float,
    label: str = "default",
    lr_multiplier: float = 1.0,
    weight_decay: float | None = None,
) -> torch.optim.Optimizer:
    """The optimizer ``name`` over ``named`` parameters, every param group
    tagged with ``label`` and ``lr_multiplier``, at rate ``lr`` times it."""
    opt = config.OPTIMIZER
    wd = float(opt.WEIGHT_DECAY if weight_decay is None else weight_decay)
    name = name.lower()
    tag = {"label": label, "lr_multiplier": float(lr_multiplier)}
    lr = lr * float(lr_multiplier)
    if name in ("adamw", "sgd"):
        decays = _no_decay_mask(named)
        groups = [
            {"params": [p for n, p in named if decays[n]], "weight_decay": wd, **tag},
            {"params": [p for n, p in named if not decays[n]], "weight_decay": 0.0, **tag},
        ]
        groups = [g for g in groups if g["params"]]
        if name == "adamw":
            betas = tuple(opt.BETAS)
            return torch.optim.AdamW(groups, lr=lr, betas=(float(betas[0]), float(betas[1])),
                                     eps=float(opt.EPS))
        return torch.optim.SGD(groups, lr=lr, momentum=float(opt.MOMENTUM), nesterov=True)
    params = [{"params": [p for _, p in named], **tag}]
    if name == "muon":
        m = opt.MUON
        views = {p: (layouts[n].to_jax, layouts[n].from_jax) for n, p in named}
        return Muon(params, lr=lr, momentum=float(m.MOMENTUM), nesterov=bool(m.NESTEROV),
                    ns_steps=int(m.NS_STEPS), weight_decay=wd,
                    apply_scaling=bool(m.APPLY_SCALING), strict=bool(m.STRICT), layouts=views)
    if name == "ademamix":
        betas = tuple(opt.BETAS)
        t_ab3 = opt.get("T_ALPHA_BETA3")
        return AdEMAMix(params, lr=lr,
                        betas=(float(betas[0]), float(betas[1]),
                               float(betas[2]) if len(betas) > 2 else 0.9999),
                        alpha=float(opt.ALPHA), t_alpha_beta3=int(t_ab3) if t_ab3 else None,
                        eps=float(opt.EPS), weight_decay=wd)
    raise ValueError(f"Unknown OPTIMIZER.NAME '{name}'")


def _group_configs(config) -> dict[str, Mapping]:
    """The OPTIMIZER.PARAMETER_GROUPS entries that define a group (those with
    a FILTER), in config order."""
    pg = config.OPTIMIZER.get("PARAMETER_GROUPS", {})
    out = {}
    for gname, gcfg in pg.items():
        if gname in ("ENABLED", "DEFAULT") or not isinstance(gcfg, dict):
            continue
        if not gcfg.get("FILTER"):
            logger.warning(f"Parameter group '{gname}' has no FILTER; skipping")
            continue
        out[gname] = gcfg
    return out


def _multi_group(config) -> bool:
    pg = config.OPTIMIZER.get("PARAMETER_GROUPS", {})
    return bool(pg) and bool(pg.get("ENABLED", False))


def lr_multipliers(config) -> dict[str, float]:
    """Group name -> LR multiplier; {'default': 1.0} for a single group."""
    if not _multi_group(config):
        return {"default": 1.0}
    pg = config.OPTIMIZER.PARAMETER_GROUPS
    out = {"default": float(pg.get("DEFAULT", {}).get("LR_MULTIPLIER", 1.0))}
    for gname, gcfg in pg.items():
        if gname in ("ENABLED", "DEFAULT") or not isinstance(gcfg, dict):
            continue
        if gcfg.get("FILTER"):
            out[gname] = float(gcfg.get("LR_MULTIPLIER", 1.0))
    return out


def lr_dict_for_logging(config, schedule, step: int,
                        group_schedules: Mapping | None = None) -> dict[str, float]:
    """Per-group learning rates for logging: each group's own schedule
    (falling back to ``schedule``) times its LR_MULTIPLIER."""
    group_schedules = group_schedules or {}

    def at(s):
        return float(s(step)) if callable(s) else float(s)

    return {f"lr/{g}": at(group_schedules.get(g, schedule)) * m
            for g, m in lr_multipliers(config).items()}


def build_optimizer(
    config,
    schedule: Schedule | float,
    model: nn.Module,
    group_schedules: Mapping[str, Schedule] | None = None,
) -> torch.optim.Optimizer | MultiOptimizer:
    """The optimizer of ``config.OPTIMIZER`` over the trainable parameters of
    ``model``. ``schedule`` (or the number itself) gives the initial rate;
    ``group_schedules`` (optim/schedules.py::build_group_schedules) gives a
    group its own. Multi-group configs:

        OPTIMIZER.PARAMETER_GROUPS:
          ENABLED: true
          DEFAULT: {OPTIMIZER, WEIGHT_DECAY, LR_MULTIPLIER}
          <GROUP>: {OPTIMIZER, WEIGHT_DECAY, LR_MULTIPLIER, FILTER: {...}}
    """
    group_schedules = dict(group_schedules or {})

    def lr0(label):
        s = group_schedules.get(label, schedule)
        return float(s(0) if callable(s) else s)

    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    layouts = jax_layouts(model)
    if not _multi_group(config):
        return _make_single(str(config.OPTIMIZER.NAME), config, named, layouts, lr0("default"))
    groups = _group_configs(config)
    predicates = {g: build_filter_from_config(gcfg.get("FILTER")) for g, gcfg in groups.items()}
    labels = param_labels(model, predicates, default="default")
    logger.info(filtering_report(model, predicates))
    default_cfg = config.OPTIMIZER.PARAMETER_GROUPS.get("DEFAULT", {})
    optimizers = {}
    for label, gcfg in [("default", default_cfg)] + list(groups.items()):
        members = [(n, p) for n, p in named if labels[n] == label]
        if not members:  # torch optimizers take no empty parameter lists
            continue
        optimizers[label] = _make_single(
            str(gcfg.get("OPTIMIZER", config.OPTIMIZER.NAME)), config, members, layouts,
            lr0(label), label=label, lr_multiplier=float(gcfg.get("LR_MULTIPLIER", 1.0)),
            weight_decay=gcfg.get("WEIGHT_DECAY"))
    return MultiOptimizer(optimizers)
