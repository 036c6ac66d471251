"""AdEMAMix: Adam's fast moving average plus a slow one, mixed by alpha.

Port of linnaeus_tpu/optim/ademamix.py (an optax transform there, a
``torch.optim.Optimizer`` here, with the same update):

    m1 = b1 m1 + (1 - b1) g,  nu = b2 nu + (1 - b2) g^2,
    m2 = b3_t m2 + (1 - b3_t) g,
    update = (m1 / (1 - b1^t) + alpha_t m2) / (sqrt(nu / (1 - b2^t)) + eps)
    p <- p - lr (update + weight_decay p)

With ``t_alpha_beta3`` set, alpha_t rises linearly to alpha and b3_t from
b1 to b3 (in log-log interpolation) over that many steps. The decoupled
weight decay applies to every parameter, as the TPU package's chain adds it
without a mask.
"""

from __future__ import annotations

import math

import torch


def alpha_beta3(step: int, alpha: float, b1: float, b3: float,
                t_alpha_beta3: int | None) -> tuple[float, float]:
    """(alpha_t, b3_t) at update ``step`` (1-based)."""
    if t_alpha_beta3 is None:
        return alpha, b3
    alpha_t = min(step * alpha / t_alpha_beta3, alpha)
    ln_b1, ln_b3 = math.log(b1), math.log(b3)
    frac = min(max(step / t_alpha_beta3, 0.0), 1.0)
    beta3_t = min(math.exp(ln_b1 * ln_b3 / ((1 - frac) * ln_b3 + frac * ln_b1)), b3)
    return alpha_t, beta3_t


class AdEMAMix(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999, 0.9999),
                 alpha: float = 5.0, t_alpha_beta3: int | None = None, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        defaults = dict(lr=lr, betas=tuple(betas), alpha=alpha, t_alpha_beta3=t_alpha_beta3,
                        eps=eps, weight_decay=weight_decay)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2, b3 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    for key in ("m1", "m2", "nu"):
                        state[key] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                alpha_t, b3_t = alpha_beta3(t, group["alpha"], b1, b3, group["t_alpha_beta3"])
                g = p.grad
                m1, m2, nu = state["m1"], state["m2"], state["nu"]
                m1.mul_(b1).add_(g, alpha=1 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1 - b2)
                m2.mul_(b3_t).add_(g, alpha=1 - b3_t)
                update = (m1 / (1 - b1**t) + alpha_t * m2) / (
                    (nu / (1 - b2**t)).sqrt() + group["eps"])
                if group["weight_decay"] > 0:
                    update.add_(p, alpha=group["weight_decay"])
                p.add_(update, alpha=-group["lr"])
        return loss
