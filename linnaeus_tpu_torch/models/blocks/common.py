"""Shared small blocks: dtype-following layers, a BatchNorm with Flax's
semantics, Mlp, DropPath and the residual add that applies it, Dropout,
ResNormLayer, MetaHead and the parameter init.

Port of linnaeus_tpu/models/blocks/common.py. Parameters are kept in
float32, as the TPU package keeps them; the layers here cast their weights
to the dtype of their input, so a bfloat16 activation runs a bfloat16
product against float32 master weights, as Flax's ``dtype`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from linnaeus_tpu_torch.ops.drop_path import (
    SampleScale,
    scale_add,
    scale_add_reference,
    scale_samples_reference,
)
from linnaeus_tpu_torch.parallel.ops import draw_rows
from linnaeus_tpu_torch.utils import tracing

INIT_STD = 0.02  # trunc_normal(std=0.02), the ViT/ConvNeXt init


def _cast(p: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    return None if p is None else p.to(dtype)


class Linear(nn.Linear):
    """``nn.Linear`` in the input's dtype. Under tensor parallelism
    (parallel/model.py sets ``tp`` and leaves the layer its rank's share of
    the weights) it computes that share: ``("col", group)`` its output
    features of the whole input (Megatron's f before it: the input's
    gradient is summed over the group), ``("row", group)`` from the input
    features it is given, summed over the group (Megatron's g) before the
    whole bias, and ``("col_gather", group)`` a column share whose outputs
    are gathered back in rank order."""

    tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))
        from linnaeus_tpu_torch.parallel.ops import gather_rows, sum_backward, sum_forward

        mode, group = self.tp
        if mode == "row":
            y = sum_forward(F.linear(x, self.weight.to(x.dtype)), group)
            return y if self.bias is None else y + self.bias.to(x.dtype)
        y = F.linear(sum_backward(x, group), self.weight.to(x.dtype), _cast(self.bias, x.dtype))
        return gather_rows(y, group, dim=-1) if mode == "col_gather" else y


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


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A Conv2d on NHWC activations: the convolution sees an NCHW view of
    the same memory (channels-last strides) and its output is viewed back."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis with the semantics of ``flax.linen.BatchNorm``
    (``use_fast_variance``, ``force_float32_reductions``), not those of
    ``torch.nn.BatchNorm2d``:

    * the batch statistics are reduced in float32 whatever the input's dtype,
      the variance as ``max(0, E[x^2] - E[x]^2)``: the **biased** variance,
      which is also what the running variance is updated with (torch's
      BatchNorm updates it with the unbiased one);
    * ``momentum`` is Flax's, the weight of the old value:
      ``running = momentum * running + (1 - momentum) * batch`` (Flax's 0.9
      is torch's 0.1);
    * ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias`` in float32,
      cast back to the input's dtype.

    Training mode normalises with the batch statistics and updates the
    buffers once per forward; eval mode normalises with the buffers and
    leaves them alone. ``weight`` / ``bias`` are Flax's ``scale`` / ``bias``,
    ``running_mean`` / ``running_var`` its ``batch_stats`` ``mean`` / ``var``,
    in float32."""

    def __init__(self, num_features: int, eps: float, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        # data-parallel group (parallel/): the statistics are the global batch's
        self.data_group = None
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            axes = tuple(range(x.dim() - 1))
            x32 = x.float()
            if self.data_group is None:
                mean = x32.mean(axes)
                var = ((x32 * x32).mean(axes) - mean * mean).clamp_min(0.0)
            else:
                # the global batch's statistics: sums of x and x^2 in float32
                # over the data group, as Flax reduces them under SPMD
                from linnaeus_tpu_torch.parallel.ops import all_reduce_sum, group_size

                count = x32.numel() // x32.shape[-1] * group_size(self.data_group)
                sums = all_reduce_sum(torch.stack([x32.sum(axes), (x32 * x32).sum(axes)]),
                                      self.data_group)
                mean = sums[0] / count
                var = (sums[1] / count - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        # x - mean promotes to float32 in one pass, without a float32 copy of x
        return torch.addcmul(self.bias, x - mean, mul).to(x.dtype)


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
        self.data_group = None  # parallel/: draw the global batch's mask

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` times this forward's per-sample scale, in plain PyTorch. The
        model's residuals apply the scale inside their add instead
        (``drop_path_add``)."""
        scale = self._scale(x)
        return x if scale is None else scale_samples_reference(x, scale)

    def _scale(self, x: torch.Tensor) -> SampleScale | None:
        """The per-sample scale of one forward over ``x``, from uniforms
        drawn one a sample, or None where drop path is the identity (eval,
        rate 0) and nothing is drawn."""
        if not self.training or self.rate <= 0.0:
            return None
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        u = draw_rows(torch.rand, shape, x.device, self.generator, self.data_group)
        return SampleScale(u.reshape(-1), 1.0 - self.rate)

    def sample_scale(self, x: torch.Tensor) -> SampleScale | None:
        """This forward's per-sample scale for a residual add that applies it
        itself (``drop_path_add``, K2): the draw of ``forward``, the same
        uniforms from the same generator. While tracing is on the draws are
        kept as ``drop_path/scaled``, one count a scaled residual, with no
        launch of its own."""
        scale = self._scale(x)
        if scale is not None:
            tracing.count("drop_path/scaled", scale.u)
        return scale


def drop_path_add(residual: torch.Tensor, branch: torch.Tensor,
                  drop_path: DropPath, kernel: bool = True) -> torch.Tensor:
    """``residual + drop_path(branch)``. In training at a rate above 0 the
    branch's per-sample scale is applied inside the add: one pass forward
    and one backward (ops/drop_path.py, a kernel on the card), or the same
    sum in plain PyTorch where the calling block's own kernels are off
    (``kernel`` False). Otherwise the plain sum."""
    scale = drop_path.sample_scale(branch)
    if scale is None:
        return residual + branch
    if not kernel:
        return scale_add_reference(residual, branch, scale)
    return scale_add(residual, branch, scale)


class Dropout(nn.Module):
    """Element-wise dropout in training, identity in eval: each element is
    kept with probability 1 - rate and scaled by 1 / (1 - rate), as Flax's
    ``nn.Dropout``. The keep mask is drawn from ``generator``, as DropPath's
    is."""

    def __init__(self, rate: float = 0.0, generator: torch.Generator | None = None):
        super().__init__()
        self.rate = rate
        self.generator = generator
        # parallel/: draw the global batch's mask; ``batch_dim`` is the axis
        # that holds this rank's rows
        self.data_group = None
        self.batch_dim = 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        keep = 1.0 - self.rate
        mask = draw_rows(torch.rand, x.shape, x.device, self.generator, self.data_group,
                         self.batch_dim) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Mlp(nn.Module):
    """Transformer MLP: fc1 -> GELU -> dropout -> fc2 -> dropout."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 act_exact: bool = False, drop: float = 0.0):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features)
        self.fc2 = Linear(hidden_features, out_features)
        self.act_exact = act_exact
        self.drop1 = Dropout(drop)
        self.drop2 = Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop2(self.fc2(self.drop1(gelu(self.fc1(x), self.act_exact))))


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
    LayerNorms and BatchNorms. Other parameters (layer scales, CLS tokens, RoPE
    frequencies) are set by their modules' constructors."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            trunc_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, BatchNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
