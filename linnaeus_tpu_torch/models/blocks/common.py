"""Shared small blocks: dtype-following layers, Mlp, DropPath, ResNormLayer,
MetaHead and the parameter init.

Port of linnaeus_tpu/models/blocks/common.py. Parameters are kept in
float32, as the TPU package keeps them; the layers here cast their weights
to the dtype of their input, so a bfloat16 activation runs a bfloat16
product against float32 master weights, as Flax's ``dtype`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

INIT_STD = 0.02  # trunc_normal(std=0.02), the ViT/ConvNeXt init


def _cast(p: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    return None if p is None else p.to(dtype)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class LayerNorm(nn.LayerNorm):
    """LayerNorm whose eps is always given (1e-6 in ConvNeXt parts, 1e-5 in
    the RoPE stages and heads)."""

    def __init__(self, dim: int, eps: float):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x, self.normalized_shape, self.weight.to(x.dtype),
            self.bias.to(x.dtype), self.eps,
        )


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class Conv1d(nn.Conv1d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


def gelu(x: torch.Tensor, exact: bool) -> torch.Tensor:
    """erf GELU when ``exact``, else the tanh approximation (the default)."""
    return F.gelu(x, approximate="none" if exact else "tanh")


class DropPath(nn.Module):
    """Per-sample stochastic depth in training; identity in eval. The keep
    mask is drawn from ``generator`` (on the input's device) when one is
    set, as ``create_train_state`` does with the step's generator, so a
    step is reproducible from its seed; without one it draws from torch's
    global generator."""

    def __init__(self, rate: float = 0.0, generator: torch.Generator | None = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, device=x.device, generator=self.generator) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Mlp(nn.Module):
    """Transformer MLP: fc1 -> GELU -> fc2."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 act_exact: bool = False):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features)
        self.fc2 = Linear(hidden_features, out_features)
        self.act_exact = act_exact

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x), self.act_exact))


class ResNormLayer(nn.Module):
    """(x -> w1 -> ReLU -> LN -> w2 -> ReLU -> LN) + x, inside meta heads."""

    def __init__(self, dim: int):
        super().__init__()
        self.w1 = Linear(dim, dim)
        self.norm_fn1 = LayerNorm(dim, eps=1e-5)
        self.w2 = Linear(dim, dim)
        self.norm_fn2 = LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm_fn1(F.relu(self.w1(x)))
        y = self.norm_fn2(F.relu(self.w2(y)))
        return x + y


class MetaHead(nn.Sequential):
    """Metadata embedding head: Linear -> ReLU -> LN -> ResNormLayer, at the
    upstream indices 0, 2 and 3."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__(
            Linear(in_dim, out_dim), nn.ReLU(), LayerNorm(out_dim, eps=1e-5),
            ResNormLayer(out_dim),
        )


def trunc_normal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return nn.init.trunc_normal_(
        t, std=INIT_STD, a=-2 * INIT_STD, b=2 * INIT_STD, generator=generator
    )


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """The TPU package's init, drawn from ``generator``: trunc-normal
    weights and zero biases for every Linear and Conv, unit/zero
    LayerNorms. Other parameters (layer scales, CLS tokens, RoPE
    frequencies) are set by their modules' constructors."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            trunc_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
