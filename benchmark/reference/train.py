"""The training step as plain float32 PyTorch: collate, loss, clip, AdamW.

Written from the configuration's description, independent of the program.
One step:

1. collate on the device: uint8 images to [0, 1]; integer labels to one-hot
   rows; with probability ``mix_prob`` (one uniform gate a batch) every
   sample whose group has another member in the batch mixes with a partner
   of its group (members ordered by a uniform draw, each taking the next,
   the last the first): images and targets by lam ~ Beta(alpha, alpha), the
   metadata by a hard pick per component (both non-zero: a coin; one
   non-zero: that one); then each sample's whole metadata vector is zeroed
   with probability ``meta_mask_prob``, and a partial mask (probability 0
   in these configurations) draws its coins;
2. the forward (reference/model.py) with stochastic depth;
3. the loss: per task the cross entropy against the soft targets, summed
   over the samples that count (a null-labelled sample counts with
   probability ``null_mask_prob``, one coin per sample and task) over their
   number, summed over tasks at weight 1;
4. the backward, the clip of the global gradient norm to ``clip``
   (scale ``clip / (norm + 1e-6)`` where below 1), and AdamW (decoupled
   weight decay on the parameters of two or more dimensions) at the
   schedule's rate: linear warm-up from ``WARMUP_LR``, then
   cosine from ``BASE_LR`` to ``MIN_LR``.

The random draws come from a ``torch.Generator`` seeded as the program's
step generator is, in the order the configuration's step makes them:
mix gate, permutation noise, lam (two gamma draws), the metadata picks per
component, the meta-masking coins, the partial-masking coins; stochastic
depth per block in layer order (a RoPE block draws for its attention, then
its MLP); the null-masking coins per task.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import model as M


def linear_ramp(step, start, end, end_steps):
    if end_steps <= 0 or step >= end_steps:
        return float(end)
    return float(start + step / max(1, end_steps) * (end - start))


def schedule_scalars(cfg: dict, step: int, total_steps: int) -> dict:
    """mix, meta-mask and null-mask probabilities at ``step``."""
    sch = cfg["SCHEDULE"]
    prob = sch["MIX"]["PROB"]
    meta = sch["META_MASKING"]
    null = sch["NULL_MASKING"]
    ramp = lambda c: linear_ramp(step, c["START_PROB"], c["END_PROB"],  # noqa: E731
                                 int(total_steps * float(c["END_FRACTION"])))
    return {
        "mix_prob": ramp(prob) if prob["ENABLED"] else 0.0,
        "meta_mask_prob": ramp(meta) if meta["ENABLED"] else 0.0,
        "null_mask_prob": ramp(null) if null["ENABLED"] else 1.0,
    }


def learning_rate(cfg: dict, step: int, total_steps: int) -> float:
    lr = cfg["LR_SCHEDULER"]
    base, low, warm_lr = float(lr["BASE_LR"]), float(lr["MIN_LR"]), float(lr["WARMUP_LR"])
    warm = int(lr["WARMUP_STEPS"])
    if step < warm:
        return (warm_lr - base) * (1.0 - step / warm) + base
    decay = max(total_steps - warm, 1)
    t = min(max(step - warm, 0), decay)
    alpha = low / base
    return base * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / decay)) + alpha)


def group_partners(group_ids: np.ndarray, noise: np.ndarray) -> np.ndarray:
    """Each sample's partner: the next member of its group in the order of
    (noise, index), the last the first; a singleton its own."""
    perm = np.arange(len(group_ids))
    for g in np.unique(group_ids):
        members = np.nonzero(group_ids == g)[0]
        members = members[np.argsort(noise[members], kind="stable")]
        perm[members] = np.roll(members, -1)
    return perm


class Draws:
    """Uniform and gamma draws of one generator, in call order."""

    def __init__(self, seed: int, device):
        self.g = torch.Generator(device=device).manual_seed(seed)
        self.device = device

    def uniform(self, shape):
        return torch.rand(shape, generator=self.g, device=self.device)

    def beta(self, alpha):
        conc = torch.full((2,), float(alpha), device=self.device)
        g = torch._standard_gamma(conc, generator=self.g)
        return g[0] / (g[0] + g[1])


def collate(batch: dict, spec: dict, cfg: dict, scalars: dict, draws: Draws):
    images = batch["images"].float() * (1.0 / 255.0)
    B = images.shape[0]
    targets = {t: torch.nn.functional.one_hot(batch["targets"][t], n).float()
               for t, n in spec["tasks"]}
    meta = batch["aux"].float()
    mix = cfg["SCHEDULE"]["MIX"]
    gate = draws.uniform(())
    noise = draws.uniform((B,))
    lam = draws.beta(mix["MIXUP"]["ALPHA"])
    picks = torch.stack([draws.uniform((B,)) < 0.5 for _ in spec["meta"]])
    meta_coins = draws.uniform((B,))
    draws.uniform((B,))  # the partial-masking coins (probability 0)
    groups = batch["group_ids"].cpu().numpy()
    perm_np = group_partners(groups, noise.cpu().numpy())
    perm = torch.from_numpy(perm_np).to(images.device)
    mixes = torch.from_numpy((perm_np != np.arange(B)) & (groups != -1)).to(images.device)
    mixes = mixes & (gate < scalars["mix_prob"])
    images = torch.where(mixes[:, None, None, None], lam * images + (1.0 - lam) * images[perm],
                         images)
    targets = {t: torch.where(mixes[:, None], lam * v + (1.0 - lam) * v[perm], v)
               for t, v in targets.items()}
    out, start = meta.clone(), 0
    for ci, (_, dim) in enumerate(spec["meta"]):
        a, b = meta[:, start:start + dim], meta[perm, start:start + dim]
        a_on, b_on = (a != 0).any(dim=1), (b != 0).any(dim=1)
        use_b = torch.where(a_on & b_on, picks[ci], ~a_on & b_on) & mixes
        out[:, start:start + dim] = torch.where(use_b[:, None], b, a)
        start += dim
    masked = meta_coins < scalars["meta_mask_prob"]
    meta = torch.where(masked[:, None], torch.zeros_like(out), out)
    return images, targets, meta


def loss_fn(logits: dict, targets: dict, spec: dict, scalars: dict, draws: Draws):
    total = 0.0
    for t, _ in spec["tasks"]:
        soft = targets[t]
        per = -(soft * torch.log_softmax(logits[t], dim=-1)).sum(dim=-1)
        coin = draws.uniform(per.shape)
        is_null = soft[:, 0] > 0.5
        keep = (soft.sum(dim=-1) > 0) & torch.where(is_null, coin < scalars["null_mask_prob"],
                                                     torch.ones_like(is_null))
        total = total + torch.where(keep, per, torch.zeros_like(per)).sum() / keep.sum().clamp_min(1)
    return total


class Trainer:
    """The reference's training state: float32 weights and AdamW moments."""

    def __init__(self, weights: dict, spec: dict, cfg: dict, total_steps: int, step_seed: int,
                 device, quant: bool = False):
        self.W = {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.W.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.W.items()}
        self.spec, self.cfg, self.total, self.quant = spec, cfg, total_steps, quant
        self.draws = Draws(step_seed, device)
        self.step = 0

    def train_step(self, batch: dict) -> dict:
        """One step on ``batch``; returns the loss, each leaf's clipped
        gradient, as the optimizer gets it, and the global gradient norm
        before and after the clip."""
        cfg, spec = self.cfg, self.spec
        scalars = schedule_scalars(cfg, self.step, self.total)
        images, targets, meta = collate(batch, spec, cfg, scalars, self.draws)
        logits = M.forward(self.W, images, meta, spec, draw=self.draws.uniform, quant=self.quant)
        loss = loss_fn(logits, targets, spec, scalars, self.draws)
        grads = torch.autograd.grad(loss, list(self.W.values()))
        grads = dict(zip(self.W.keys(), grads))
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
        clip = float(cfg["TRAIN"]["CLIP_GRAD"])
        scale = torch.clamp(clip / (norm + 1e-6), max=1.0) if clip > 0 else 1.0
        grads = {k: g * scale for k, g in grads.items()}
        clipped = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
        self.adamw(grads, learning_rate(cfg, self.step, self.total))
        self.step += 1
        return {"loss": float(loss.detach()), "grads": grads,
                "norm_pre": float(norm), "norm_post": float(clipped)}

    @torch.no_grad()
    def adamw(self, grads: dict, lr: float) -> None:
        opt = self.cfg["OPTIMIZER"]
        b1, b2 = (float(b) for b in opt["BETAS"][:2])
        eps, wd = float(opt["EPS"]), float(opt["WEIGHT_DECAY"])
        t = self.step + 1
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        for k, p in self.W.items():
            g = grads[k]
            if p.dim() > 1:  # decoupled weight decay
                p.mul_(1.0 - lr * wd)
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(bc2)).add_(eps)
            p.addcdiv_(self.m[k], denom, value=-lr / bc1)
