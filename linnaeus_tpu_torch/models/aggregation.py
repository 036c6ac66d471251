"""Aggregation layers and feature resolvers (registered components).

Port of linnaeus_tpu/models/aggregation.py (reference: models/aggregation/*.py
and models/resolvers/*.py): AdaptivePooling, Concatenation, Conv1d and
Identity aggregations over a (B, N, C) token stack, and LearnedProjection,
AdaptivePooling, Concatenation and Identity feature resolvers, built from
MODEL.AGGREGATION and MODEL.FEATURE_RESOLVER. A Flax ``Dense`` learns its
input width on first call; a torch ``Linear`` needs it up front, so the
constructors that hold one take it (``in_features``, ``num_tokens``) and the
``configure_*`` builders take the widths of what they will see. Each
Linear is ``fc``, the JAX package's ``Dense_0``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from linnaeus_tpu_torch.models.blocks.common import Linear
from linnaeus_tpu_torch.models.factory import (
    AGGREGATION_REGISTRY,
    RESOLVER_REGISTRY,
    register_aggregation,
    register_resolver,
)


@register_aggregation("AdaptivePooling")
class AdaptivePoolingAggregation(nn.Module):
    """Mean-pool a (B, N, C) token stack to (B, C)."""

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return tokens.mean(dim=1)


@register_aggregation("Concatenation")
class ConcatenationAggregation(nn.Module):
    """Concatenate the N tokens, then project N * C back to ``out_features``."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.fc = Linear(in_features, out_features)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.fc(tokens.reshape(tokens.shape[0], -1))


@register_aggregation("Conv1d")
class Conv1dAggregation(nn.Module):
    """N -> 1 channel 1x1 Conv1d over the feature axis, as a product over the
    token axis (the mFormer dual-CLS aggregator)."""

    def __init__(self, num_tokens: int = 2):
        super().__init__()
        self.fc = Linear(num_tokens, 1)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.fc(tokens.transpose(1, 2))[..., 0]


@register_aggregation("Identity")
@register_aggregation("default")
class IdentityAggregation(nn.Module):
    """The first token of a (B, N, C) stack; a (B, C) input as it is."""

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return tokens[:, 0] if tokens.dim() == 3 else tokens


def configure_aggregation_layer(config, num_tokens: int, dim: int) -> nn.Module:
    """MODEL.AGGREGATION (reference: aggregation/utils.py:10) for a stack of
    ``num_tokens`` tokens of width ``dim``."""
    agg_type = str(config.MODEL.AGGREGATION.TYPE)
    params = config.MODEL.AGGREGATION.get("PARAMETERS", {})
    cls = AGGREGATION_REGISTRY.get(agg_type)
    if cls is None:
        raise ValueError(f"Unknown aggregation TYPE '{agg_type}'")
    if agg_type == "Concatenation":
        return cls(num_tokens * dim, int(params.get("out_channels", 768)))
    if agg_type == "Conv1d":
        return cls(num_tokens)
    return cls()


# ------------------------------------------------------------------ resolvers
@register_resolver("LearnedProjection")
class LearnedProjectionResolver(nn.Module):
    def __init__(self, in_features: int, projection_dim: int = 512):
        super().__init__()
        self.fc = Linear(in_features, projection_dim)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.fc(feats)


@register_resolver("AdaptivePooling")
class AdaptivePoolingResolver(nn.Module):
    """Pick ``projection_dim`` of the C features at the JAX package's float32
    positions ``int(i * C / projection_dim)``."""

    def __init__(self, projection_dim: int = 512):
        super().__init__()
        self.projection_dim = projection_dim

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        C = feats.shape[1]
        if C == self.projection_dim:
            return feats
        ratio = np.float32(C / self.projection_dim)
        idx = (np.arange(self.projection_dim, dtype=np.float32) * ratio).astype(np.int64)
        return feats[:, torch.from_numpy(idx).to(feats.device)]


@register_resolver("Concatenation")
class ConcatenationResolver(nn.Module):
    def forward(self, *feats: torch.Tensor) -> torch.Tensor:
        return torch.cat(feats, dim=-1)


@register_resolver("Identity")
class IdentityResolver(nn.Module):
    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return feats


def configure_feature_resolver(config, in_features: int) -> nn.Module:
    """MODEL.FEATURE_RESOLVER (reference: resolvers/utils.py:15) for features
    of width ``in_features``."""
    rtype = str(config.MODEL.FEATURE_RESOLVER.TYPE)
    params = config.MODEL.FEATURE_RESOLVER.get("PARAMETERS", {})
    cls = RESOLVER_REGISTRY.get(rtype)
    if cls is None:
        raise ValueError(f"Unknown resolver TYPE '{rtype}'")
    projection_dim = int(params.get("projection_dim", 512))
    if rtype == "LearnedProjection":
        return cls(in_features, projection_dim)
    if rtype == "AdaptivePooling":
        return cls(projection_dim)
    return cls()
