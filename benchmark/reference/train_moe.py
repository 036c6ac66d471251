"""``train.py``'s training step for a model with expert layers.

The same collate, task loss, clip and AdamW, with the forward of
``model_moe.py`` and the loss the configuration's step minimises:
the task loss plus ``aux_weight`` times the expert layers' mean aux and
``z_weight`` times their mean z. Decoupled weight decay applies to the
weights of two or more dimensions and not to biases: the expert banks'
stacked biases ``bi`` (E, F) and ``bo`` (E, D) are biases, one row an
expert. ``train_step`` takes the routing operand of ``model_moe.forward``
and returns, beside ``train.Trainer``'s readings, each expert layer's
``own``, ``keep`` and ``probs`` under ``route``.
"""

from __future__ import annotations

import math

import torch

from . import model_moe as MM
from . import train as T


def decays(name: str, p: torch.Tensor) -> bool:
    return p.dim() > 1 and name.rsplit(".", 1)[-1] not in ("bi", "bo")


class Trainer(T.Trainer):
    def train_step(self, batch: dict, routing=None) -> dict:
        cfg, spec = self.cfg, self.spec
        scalars = T.schedule_scalars(cfg, self.step, self.total)
        images, targets, meta = T.collate(batch, spec, cfg, scalars, self.draws)
        logits, layers = MM.forward(self.W, images, meta, spec, draw=self.draws.uniform,
                                    quant=self.quant, routing=routing)
        loss = T.loss_fn(logits, targets, spec, scalars, self.draws)
        if layers:
            n, moe = len(layers), spec["moe"]
            loss = (loss + moe["aux_weight"] * sum(r["aux"] for r in layers) / n
                    + moe["z_weight"] * sum(r["z"] for r in layers) / n)
        grads = torch.autograd.grad(loss, list(self.W.values()))
        grads = dict(zip(self.W.keys(), grads))
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
        clip = float(cfg["TRAIN"]["CLIP_GRAD"])
        scale = torch.clamp(clip / (norm + 1e-6), max=1.0) if clip > 0 else 1.0
        grads = {k: g * scale for k, g in grads.items()}
        clipped = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
        self.adamw(grads, T.learning_rate(cfg, self.step, self.total))
        self.step += 1
        return {"loss": float(loss.detach()), "grads": grads,
                "norm_pre": float(norm), "norm_post": float(clipped),
                "route": [(r["own"], r["keep"], r["probs"]) for r in layers]}

    @torch.no_grad()
    def adamw(self, grads: dict, lr: float) -> None:
        opt = self.cfg["OPTIMIZER"]
        b1, b2 = (float(b) for b in opt["BETAS"][:2])
        eps, wd = float(opt["EPS"]), float(opt["WEIGHT_DECAY"])
        t = self.step + 1
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        for k, p in self.W.items():
            g = grads[k]
            if decays(k, p):
                p.mul_(1.0 - lr * wd)
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(bc2)).add_(eps)
            p.addcdiv_(self.m[k], denom, value=-lr / bc1)
