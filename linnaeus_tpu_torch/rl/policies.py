"""Actor-critic policy wrapper around a linnaeus backbone.

Port of linnaeus_tpu/rl/policies.py (reference parity:
rl_env/policies.py:13-402, LinnaeusPolicyWrapper): adapts a classification
model into an actor-critic: per-rank actor logits with an extra abstain
action, plus a scalar value head over the backbone features.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from linnaeus_tpu_torch.models.blocks.common import Linear, trunc_normal_


def _feature_width(backbone: nn.Module) -> int:
    """The width of ``backbone.forward_features``: its classification
    heads' input (mFormerV1 and mFormerV0 both end in ``head``)."""
    return int(backbone.head[backbone.head.task_keys[0]].fc.weight.shape[1])


class LinnaeusPolicyWrapper(nn.Module):
    """Wraps a backbone (any module with ``forward_features``) into an
    actor-critic for the abstention environment (multitask mode).

    Per task ``actor_{t}`` = Linear(feat, n_cls + 1) and ``critic`` =
    Linear(feat, 1), trunc-normal weights drawn from ``generator`` and zero
    biases, in ``dtype`` (float32): the logits and the value are float32.

    ``abstain_prior`` > 0 initialises each actor head's abstain-action bias
    so the policy starts with about that much probability mass on
    "abstain". Without it the abstain action is 1 of n_cls + 1 and
    categorical sampling almost never explores it, so PPO gets no gradient
    toward abstaining; with it PPO calibrates the abstain/commit decision.

    The JAX module's ``deterministic`` argument is the module's mode here:
    the PPO loop keeps the policy in eval mode (no dropout or drop path)
    in rollouts and updates, as JAX passes ``deterministic=True``."""

    def __init__(self, backbone: nn.Module, task_keys: tuple[str, ...],
                 num_classes: Mapping[str, int], dtype: torch.dtype = torch.float32,
                 abstain_prior: float = 0.0, generator: torch.Generator | None = None):
        super().__init__()
        self.backbone = backbone
        self.task_keys = tuple(task_keys)
        self.num_classes = {t: int(num_classes[t]) for t in self.task_keys}
        self.dtype = dtype
        self.abstain_prior = float(abstain_prior)
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        feat = _feature_width(backbone)
        for t in self.task_keys:
            n = self.num_classes[t] + 1  # + abstain
            self.add_module(f"actor_{t}", self._dense(feat, n, generator, abstain=True))
        self.critic = self._dense(feat, 1, generator, abstain=False)
        self.to(next(backbone.parameters()).device)

    def _dense(self, feat: int, n: int, generator: torch.Generator, abstain: bool) -> Linear:
        layer = Linear(feat, n, dtype=self.dtype)
        with torch.no_grad():
            weight = torch.empty(feat, n, dtype=self.dtype)  # Flax's (in, out) draw
            layer.weight.copy_(trunc_normal_(weight, generator).T)
            layer.bias.zero_()
            if abstain and self.abstain_prior > 0:
                layer.bias[-1] = self._abstain_bias(n)
        return layer

    def _abstain_bias(self, n_actions: int) -> float:
        p = float(min(max(self.abstain_prior, 1e-4), 0.95))
        return float(np.log(n_actions - 1) + np.log(p / (1.0 - p)))

    def actor(self, task: str) -> Linear:
        return getattr(self, f"actor_{task}")

    def forward(self, images: torch.Tensor, aux: torch.Tensor | None = None
                ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        """Returns ({task: action_logits [B, n_cls+1]}, value [B]), float32."""
        feats = self.backbone.forward_features(images, aux).to(self.dtype)
        logits = {t: self.actor(t)(feats).float() for t in self.task_keys}
        value = self.critic(feats)[:, 0].float()
        return logits, value

    def evaluate_actions(self, images: torch.Tensor, aux: torch.Tensor | None,
                         actions: Mapping[str, torch.Tensor]):
        """(log_probs [B], entropy [B], value [B]) summed over ranks
        (reference: policies.py:198)."""
        logits, value = self(images, aux)
        log_prob = 0.0
        entropy = 0.0
        for t in self.task_keys:
            lp = F.log_softmax(logits[t], dim=-1)
            log_prob = log_prob + lp.gather(-1, actions[t].long()[:, None])[:, 0]
            entropy = entropy - (lp.exp() * lp).sum(-1)
        return log_prob, entropy, value


def sample_actions(logits: Mapping[str, torch.Tensor], generator: torch.Generator):
    """Per-rank categorical sampling from ``generator`` (on the logits'
    device). Returns ({task: action [B]}, log_prob [B])."""
    actions, log_prob = {}, 0.0
    for t, lg in logits.items():
        lp = F.log_softmax(lg, dim=-1)
        a = torch.multinomial(lp.exp(), 1, generator=generator)[:, 0]
        log_prob = log_prob + lp.gather(-1, a[:, None])[:, 0]
        actions[t] = a
    return actions, log_prob
