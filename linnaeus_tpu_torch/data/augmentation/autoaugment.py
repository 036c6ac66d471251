"""Batched on-device AutoAugment and the train augmentation pipeline.

Port of linnaeus_tpu/data/augmentation/autoaugment.py. The pipeline is the
TPU package's, in its order: one AutoAugment sub-policy per image (each of
its ops applied with its table probability), colour jitter, a horizontal
flip, then random erasing (AUG.RANDOM_ERASE.COUNT boxes) behind its own
gate.

Where JAX vmaps a ``lax.switch`` over the sub-policies, so that every image
runs its own branch, the port groups the batch: for each op slot of the
sub-policies, the images whose drawn sub-policy has op X in that slot and
whose gate for it is on form one group, and op X runs once on that group
(at each image's own magnitude). The flip and the erasing run once each on
the images whose gates are on. The groups are read on the host from one
small copy of the discrete draws (sub-policy, gates, flip, erase) per
batch; nothing loops over the images.

Randomness. ``draw_augmentation`` makes every draw of a batch from one
``torch.Generator`` (the erasing's pixel fill from a seed an image drawn
from it, and only for the images that erase); ``apply_augmentation``
applies a given set of draws, which is how a test hands in the TPU
package's own.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch

from . import ops as A
from .policies import get_policy

AugDraws = Mapping[str, Any]


class PolicyTable:
    """A policy's sub-policies as arrays over (sub-policy, op slot): op
    names ('' for an empty slot), probabilities and magnitudes."""

    def __init__(self, policy_name: str):
        policy = get_policy(policy_name)
        self.num = len(policy)
        self.slots = max(len(sp) for sp in policy)
        self.ops = np.full((self.num, self.slots), "", dtype=object)
        self.prob = np.zeros((self.num, self.slots), np.float32)
        self.mag = np.zeros((self.num, self.slots), np.float64)
        for k, sub in enumerate(policy):
            for j, (name, prob, mag) in enumerate(sub):
                self.ops[k, j], self.prob[k, j], self.mag[k, j] = name, prob, mag


def draw_augmentation(n: int, H: int, W: int, table: PolicyTable | None,
                      color_jitter: float, erase_count: int, erase_pixel: bool,
                      area_range, aspect_range, hflip_prob: float, erase_prob: float,
                      generator: torch.Generator | None, device) -> dict[str, torch.Tensor]:
    """All random draws of a batch of ``n`` images:

    policy (n,) sub-policy index; gates (n, slots) bool, each op's table
    probability; op_u (n, slots) uniform, each op's random value (its sign
    or sigma, ops.op_value); jitter (n, 3) factors; flip (n,) bool; erase
    (n,) bool; erase_boxes (n, count, 4) (y0, x0, h, w); erase_seed (n,)
    int64, pixel mode only: each image's seed of its (count, H, W, 3) fill
    (:func:`erase_fill`), which is drawn only for the images that erase.
    Without it the boxes are filled with zeros."""
    kw = {"generator": generator, "device": device}
    out: dict[str, torch.Tensor] = {}
    if table is not None:
        out["policy"] = torch.randint(0, table.num, (n,), **kw)
        u = torch.rand(n, table.slots, **kw)
        prob = torch.as_tensor(table.prob, device=device)[out["policy"]]
        out["gates"] = u < prob
        out["op_u"] = torch.rand(n, table.slots, **kw)
    if color_jitter > 0:
        out["jitter"] = torch.rand(n, 3, **kw) * (2 * color_jitter) + (1 - color_jitter)
    out["flip"] = torch.rand(n, **kw) < hflip_prob
    out["erase"] = torch.rand(n, **kw) < erase_prob
    count = max(int(erase_count), 1)
    out["erase_boxes"] = A.erase_boxes(torch.rand(n * count, 4, **kw), H, W, area_range,
                                       aspect_range).reshape(n, count, 4)
    if erase_pixel:
        out["erase_seed"] = torch.randint(0, 2**62, (n,), **kw)
    return out


def erase_fill(seeds: np.ndarray, count: int, H: int, W: int, device) -> torch.Tensor:
    """The pixel-mode fill (len(seeds), count, H, W, 3) of the images with
    these seeds (host int64): each image's normal(0.5, 0.2) pixels from a
    generator of its own seed, so a subset of a batch draws only its own."""
    return torch.stack([
        torch.randn(count, H, W, 3, device=device,
                    generator=torch.Generator(device=device).manual_seed(int(s)))
        for s in seeds]) * 0.2 + 0.5


def take_rows(draws: AugDraws, rows: torch.Tensor) -> dict[str, torch.Tensor]:
    """The draws of the images ``rows`` of the batch the draws were made for."""
    return {k: v[rows] for k, v in draws.items()}


def _run_on(img: torch.Tensor, rows: np.ndarray, fn: Callable) -> None:
    """img[rows] = fn(img[rows], index) in place, for host row indices."""
    if rows.size == 0:
        return
    idx = torch.from_numpy(rows).to(img.device, non_blocking=True)
    img.index_copy_(0, idx, fn(img.index_select(0, idx), idx))


def apply_augmentation(images: torch.Tensor, draws: AugDraws, table: PolicyTable | None,
                       erase_count: int) -> torch.Tensor:
    """Augment a batch (B, H, W, 3) float32 in [0, 1] with ``draws``
    (``draw_augmentation``'s keys); returns a new tensor."""
    img = images.clone()
    seeded = "erase_fill" not in draws and "erase_seed" in draws
    flags = [draws["flip"], draws["erase"]] + ([draws["erase_seed"]] if seeded else [])
    k = len(flags)
    if table is not None:
        flags += [draws["policy"], *draws["gates"].unbind(1)]
    host = torch.stack([f.to(torch.int64) for f in flags], 1).cpu().numpy()
    flip, erase = host[:, 0].astype(bool), host[:, 1].astype(bool)

    if table is not None:
        policy, gates = host[:, k], host[:, k + 1:].astype(bool)
        for j in range(table.slots):
            names = table.ops[policy, j]
            mags = torch.as_tensor(table.mag[policy, j])
            for name in sorted(set(table.ops[:, j]) - {""}):
                rows = np.nonzero(gates[:, j] & (names == name))[0]
                op = A.OP_REGISTRY[name]

                def run(sub, idx, op=op, name=name, rows=rows):
                    mag = mags[rows]
                    return op(sub, mag, A.op_value(name, draws["op_u"][idx, j], mag))

                _run_on(img, rows, run)

    if "jitter" in draws:
        img = A.color_jitter(img, draws["jitter"])
    _run_on(img, np.nonzero(flip)[0], lambda sub, idx: sub.flip(2))

    count = max(int(erase_count), 1)
    erasing = np.nonzero(erase)[0]

    def erase_all(sub, idx):
        if "erase_fill" in draws:  # handed in (the TPU package's draws)
            fill = draws["erase_fill"][idx]
        elif seeded:
            fill = erase_fill(host[erasing, 2], count, sub.shape[1], sub.shape[2], sub.device)
        else:
            fill = sub.new_zeros((sub.shape[0], count, 1, 1, 1))
        for i in range(count):
            sub = A.random_erasing(sub, draws["erase_boxes"][idx, i], fill[:, i])
        return sub

    _run_on(img, erasing, erase_all)
    return img


def make_train_augment(
    policy_name: str = "original",
    color_jitter: float = 0.4,
    random_erase_prob: float = 0.25,
    random_erase_mode: str = "pixel",
    random_erase_area: tuple[float, float] = (0.02, 0.4),
    random_erase_aspect: tuple[float, float] = (0.3, 3.3),
    random_erase_count: int = 1,
    hflip_prob: float = 0.5,
) -> Callable:
    """The batched train pipeline (autoaugment -> colour jitter -> flip ->
    erase). Returns ``augment(images, generator=None, draws=None)``: the
    draws are made from ``generator`` unless given; ``augment.draw(n, H, W,
    generator, device)`` makes the draws of a batch of ``n`` alone. Each
    image's result depends on its own row of the draws only (``take_rows``)."""
    table = PolicyTable(policy_name) if policy_name else None
    jitter = float(color_jitter or 0.0)

    def draw(n: int, H: int, W: int, generator: torch.Generator | None,
             device) -> dict[str, torch.Tensor]:
        return draw_augmentation(
            n, H, W, table, jitter, random_erase_count, random_erase_mode == "pixel",
            random_erase_area, random_erase_aspect, hflip_prob, random_erase_prob,
            generator, device)

    def augment(images: torch.Tensor, generator: torch.Generator | None = None,
                draws: AugDraws | None = None) -> torch.Tensor:
        if draws is None:
            n, H, W, _ = images.shape
            draws = draw(n, H, W, generator, images.device)
        return apply_augmentation(images, draws, table, random_erase_count)

    augment.table, augment.draw = table, draw
    return augment


def make_autoaugment(policy_name: str = "original") -> Callable:
    """AutoAugment alone: one random sub-policy of ``policy_name`` per image,
    the same ``augment(images, generator=None, draws=None)`` form as
    :func:`make_train_augment` with jitter, flip and erasing off."""
    return make_train_augment(policy_name, color_jitter=0.0, random_erase_prob=0.0,
                              hflip_prob=0.0)


class AugmentationPipelineFactory:
    """Config-driven construction: ``create(config)`` returns the batched
    pipeline of ``config.AUG`` or None when every augmentation is off."""

    @staticmethod
    def create(config) -> Callable | None:
        aug = config.AUG
        policy = str(aug.AUTOAUG.POLICY or "")
        color_jitter = float(aug.AUTOAUG.COLOR_JITTER or 0.0)
        erase_prob = float(aug.RANDOM_ERASE.PROB or 0.0)
        if not policy and color_jitter <= 0 and erase_prob <= 0:
            return None
        return make_train_augment(
            policy_name=policy,
            color_jitter=color_jitter,
            random_erase_prob=erase_prob,
            random_erase_mode=str(aug.RANDOM_ERASE.MODE),
            random_erase_area=tuple(aug.RANDOM_ERASE.AREA_RANGE),
            random_erase_aspect=tuple(aug.RANDOM_ERASE.ASPECT_RATIO),
            random_erase_count=int(aug.RANDOM_ERASE.COUNT or 1),
        )
