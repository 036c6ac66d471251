"""Classification heads: Linear, Conv1d, HierarchicalSoftmax,
ConditionalClassifier; float32 logits.

Port of linnaeus_tpu/models/heads/heads.py. One module computes every task:
a Linear (or Conv1d) head per task gives the base logits, and the
hierarchical heads refine them top-down, coarse to fine, with the taxonomy
tree's dense parent -> child matrices (``TaxonomyTree.build_hierarchy_matrices``,
keyed ``f"{parent}_{child}"``):

    refined[child] = base[child] + log(parent_probs @ M[parent, child] + 1e-10)

The parent's probabilities are a plain softmax of its refined logits
(HierarchicalSoftmax) or a routing: ``soft`` (softmax / temperature),
``hard`` (one-hot argmax, eval only), ``gumbel`` (train only, noise drawn
from the ``torch.Generator`` the module is given; there is no global RNG).
``gradnorm_mode`` returns the base logits. The matrices are non-persistent
float32 buffers: the state_dict holds the heads' parameters only, as the
JAX package holds the matrices as constants.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from linnaeus_tpu_torch.models.blocks.common import Conv1d, Linear

HIERARCHICAL_TYPES = ("HierarchicalSoftmax", "ConditionalClassifier")
_MATRIX_PREFIX = "hierarchy_"


class LinearHead(nn.Module):
    def __init__(self, in_features: int, out_features: int, use_bias: bool = True):
        super().__init__()
        self.fc = Linear(in_features, out_features, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)


class Conv1dHead(nn.Module):
    """Conv1d over a singleton length axis with 'same' padding: a Linear
    with a conv-shaped weight (out, in, kernel_size)."""

    def __init__(self, in_features: int, out_features: int,
                 kernel_size: int = 1, use_bias: bool = True):
        super().__init__()
        self.fc = Conv1d(in_features, out_features, kernel_size,
                         padding="same", bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x[:, :, None]).mean(dim=-1)


def gumbel_noise(shape: torch.Size, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)) with u uniform in (0, 1) from
    ``generator``, float32."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp_min(tiny)
    return -torch.log(-torch.log(u))


def routing_probs(logits: torch.Tensor, strategy: str, temperature: float,
                  deterministic: bool, generator: torch.Generator | None) -> torch.Tensor:
    """Routing probabilities (ConditionalClassifier strategies)."""
    if strategy == "hard" and deterministic:
        return nn.functional.one_hot(logits.argmax(-1), logits.shape[-1]).to(logits.dtype)
    if strategy == "gumbel" and not deterministic:
        if generator is None:
            raise ValueError(
                "ConditionalClassifier ROUTING_STRATEGY 'gumbel' in training needs the "
                "heads' generator (MultiTaskHeads.generator); there is no global RNG")
        g = gumbel_noise(logits.shape, generator, logits.device)
        return torch.softmax((logits + g) / temperature, dim=-1)
    return torch.softmax(logits / temperature, dim=-1)


class MultiTaskHeads(nn.ModuleDict):
    """One head per task key (fine -> coarse, in order); ``forward``
    returns float32 logits by task. ``hierarchy_matrices`` is
    ``TaxonomyTree.build_hierarchy_matrices()``; without it the
    hierarchical heads give their base logits, as in the JAX package (the
    build functions raise before that: :func:`configure_classification_heads`,
    ``models.build.build_model``). ``generator`` feeds the gumbel routing;
    ``create_train_state`` may set it later, as it does for DropPath."""

    def __init__(self, in_features: int, task_keys: tuple[str, ...],
                 num_classes: Mapping[str, int],
                 head_configs: Mapping[str, Mapping[str, Any]] | None = None,
                 hierarchy_matrices: Mapping[str, np.ndarray] | None = None,
                 generator: torch.Generator | None = None):
        heads = {}
        configs = {}
        for task in task_keys:
            cfg = dict((head_configs or {}).get(task, {"TYPE": "Linear"}))
            head_type = str(cfg.get("TYPE", "Linear"))
            use_bias = bool(cfg.get("USE_BIAS", True))
            n_cls = int(num_classes[task])
            if head_type == "Conv1d":
                heads[task] = Conv1dHead(
                    in_features, n_cls, int(cfg.get("KERNEL_SIZE", 1)), use_bias)
            elif head_type == "Linear" or head_type in HIERARCHICAL_TYPES:
                # the hierarchical heads' level classifier is a Linear head
                heads[task] = LinearHead(in_features, n_cls, use_bias)
            else:
                raise ValueError(f"unknown head TYPE {head_type!r} for task {task}")
            configs[task] = cfg
        super().__init__(heads)
        self.task_keys = tuple(task_keys)
        self.head_configs = configs
        self.generator = generator
        self.pairs = []
        for key, matrix in (hierarchy_matrices or {}).items():
            self.register_buffer(_MATRIX_PREFIX + key,
                                 torch.tensor(np.asarray(matrix), dtype=torch.float32),
                                 persistent=False)
            self.pairs.append(key)

    def _is_hierarchical(self, task: str) -> bool:
        return str(self.head_configs[task].get("TYPE", "Linear")) in HIERARCHICAL_TYPES

    def matrix(self, pair_key: str) -> torch.Tensor | None:
        return getattr(self, _MATRIX_PREFIX + pair_key) if pair_key in self.pairs else None

    def forward(self, feats: torch.Tensor, gradnorm_mode: bool = False) -> dict[str, torch.Tensor]:
        base = {task: self[task](feats).float() for task in self.task_keys}
        any_hier = any(self._is_hierarchical(t) for t in self.task_keys)
        if gradnorm_mode or not any_hier or not self.pairs:
            return base
        deterministic = not self.training
        refined = dict(base)
        # the coarsest level (last key) is unrefined; each finer level adds
        # the log-prior from its parent's probabilities
        for i in range(len(self.task_keys) - 2, -1, -1):
            child, parent = self.task_keys[i], self.task_keys[i + 1]
            m = self.matrix(f"{parent}_{child}")
            if m is None or not self._is_hierarchical(child):
                continue
            cfg = self.head_configs[child]
            if str(cfg.get("TYPE")) == "ConditionalClassifier":
                parent_probs = routing_probs(
                    refined[parent], str(cfg.get("ROUTING_STRATEGY", "soft")),
                    float(cfg.get("TEMPERATURE", 1.0)), deterministic, self.generator)
            else:  # HierarchicalSoftmax
                parent_probs = torch.softmax(refined[parent], dim=-1)
            refined[child] = base[child] + torch.log(parent_probs @ m + 1e-10)
        return refined


def needs_taxonomy_tree(head_configs: Mapping[str, Any]) -> bool:
    return any(str(cfg.get("TYPE", "Linear")) in HIERARCHICAL_TYPES
               for cfg in head_configs.values() if isinstance(cfg, Mapping))


def configure_classification_heads(
    heads_config: Mapping[str, Mapping[str, Any]],
    num_classes_dict: Mapping[str, int],
    task_keys: list[str],
    in_features: int,
    taxonomy_tree=None,
    generator: torch.Generator | None = None,
) -> MultiTaskHeads:
    """The combined heads module of a ``MODEL.CLASSIFICATION.HEADS`` config;
    a hierarchical head TYPE needs the taxonomy tree, whose matrices it
    takes."""
    matrices = None
    if needs_taxonomy_tree(heads_config):
        if taxonomy_tree is None:
            raise ValueError("Hierarchical head TYPE requested but no taxonomy_tree provided")
        matrices = taxonomy_tree.build_hierarchy_matrices()
    return MultiTaskHeads(
        in_features,
        tuple(task_keys),
        {t: int(num_classes_dict[t]) for t in task_keys},
        {t: dict(heads_config.get(t, {"TYPE": "Linear"})) for t in task_keys},
        matrices,
        generator,
    )
