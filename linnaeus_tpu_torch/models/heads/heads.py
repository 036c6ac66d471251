"""Classification heads: Linear and Conv1d, one per task, float32 logits.

Port of linnaeus_tpu/models/heads/heads.py. The hierarchical heads
(HierarchicalSoftmax, ConditionalClassifier) refine logits with the
taxonomy tree's matrices; they wait for the port of utils/taxonomy and
raise here.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from linnaeus_tpu_torch.models.blocks.common import Conv1d, Linear

HIERARCHICAL_TYPES = ("HierarchicalSoftmax", "ConditionalClassifier")


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


class MultiTaskHeads(nn.ModuleDict):
    """One head per task key, in order; ``forward`` returns float32 logits
    by task."""

    def __init__(self, in_features: int, task_keys: tuple[str, ...],
                 num_classes: Mapping[str, int],
                 head_configs: Mapping[str, Mapping[str, Any]] | None = None):
        heads = {}
        for task in task_keys:
            cfg = (head_configs or {}).get(task, {"TYPE": "Linear"})
            head_type = str(cfg.get("TYPE", "Linear"))
            use_bias = bool(cfg.get("USE_BIAS", True))
            n_cls = int(num_classes[task])
            if head_type in HIERARCHICAL_TYPES:
                raise NotImplementedError(
                    f"{head_type} heads need the taxonomy tree, which is not ported yet"
                )
            if head_type == "Conv1d":
                heads[task] = Conv1dHead(
                    in_features, n_cls, int(cfg.get("KERNEL_SIZE", 1)), use_bias)
            elif head_type == "Linear":
                heads[task] = LinearHead(in_features, n_cls, use_bias)
            else:
                raise ValueError(f"unknown head TYPE {head_type!r} for task {task}")
        super().__init__(heads)

    def forward(self, feats: torch.Tensor) -> dict[str, torch.Tensor]:
        return {task: head(feats).float() for task, head in self.items()}
