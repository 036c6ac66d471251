"""On-device batch transforms: selective mixup/cutmix and meta-masking.

Port of linnaeus_tpu/data/collate.py. The transforms run on the device
inside the train step, in the order stack -> mixup/cutmix -> full
meta-masking -> partial meta-masking, with the probabilities arriving as
per-step scalars. Where the TPU package selects a branch with ``lax.cond``
on a traced scalar, this port folds the scalar into the per-sample mix mask
instead, so the step never waits for a device value on the host.

Randomness. Every function takes its random draws from an explicit
``torch.Generator`` (on the tensors' device) and also accepts them as
optional operands (``noise``, ``coins``, a ``draws`` dict): a JAX PRNG key
and a torch generator never agree, so a parity test computes the JAX draws
and hands them in. The draws, by key of ``draws``:

  ``gate``       uniform scalar, compared with the mix probability
  ``perm_noise`` uniform [B], orders each group's members
  ``lam``        Beta(alpha, alpha) scalar
  ``meta_pick``  bool [n_chunks, B], the both-nonzero coin of the hard pick
  ``cy``, ``cx`` integer box centre (cutmix only)

Selective-mixing semantics: the partner is an in-group permutation (every
member of a group with >= 2 in-batch members gets a same-group partner that
is not itself; singletons and group id -1 are excluded by the mix mask);
images and soft targets interpolate by lam; metadata takes a chunk-level
hard pick per component (both non-zero: pick one at random; exactly one
non-zero: keep it; both zero: zero); null-labelled samples are optionally
excluded.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import torch

Draws = Mapping[str, torch.Tensor]


class MixConfig(NamedTuple):
    """Static mixing configuration."""

    mixup_alpha: float = 1.0
    cutmix_alpha: float = 1.0
    # optional (min, max) bounds on the cutmix area-ratio lam: the beta
    # sample is affinely rescaled into [min, max]
    cutmix_minmax: tuple[float, float] | None = None
    mixup_enabled: bool = True
    cutmix_enabled: bool = False
    exclude_null: bool = False
    null_task_keys: tuple[str, ...] = ()
    chunk_bounds: tuple[tuple[int, int], ...] = ()


def _uniform(shape, device, generator: torch.Generator | None) -> torch.Tensor:
    if generator is None:
        raise ValueError("collate: pass a torch.Generator or the random draws themselves")
    return torch.rand(shape, generator=generator, device=device)


def _sample_beta(alpha: float, device, generator: torch.Generator | None) -> torch.Tensor:
    """Beta(alpha, alpha) scalar from two gamma draws of ``generator``."""
    if generator is None:
        raise ValueError("collate: pass a torch.Generator or the random draws themselves")
    conc = torch.full((2,), float(alpha), device=device)
    g = torch._standard_gamma(conc, generator=generator)
    return g[0] / (g[0] + g[1])


def ingroup_permutation(
    group_ids: torch.Tensor,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """In-group permutation: sort positions by (group id, uniform noise),
    then rotate by one within each run of equal group ids. Every member of a
    group of size >= 2 gets a same-group partner that is not itself;
    singletons map to themselves."""
    B = group_ids.shape[0]
    dev = group_ids.device
    r = noise if noise is not None else _uniform((B,), dev, generator)
    order = torch.argsort(r, stable=True)
    order = order[torch.argsort(group_ids[order], stable=True)]  # group, then noise
    sg = group_ids[order]
    idx = torch.arange(B, device=dev)
    same_as_prev = sg[1:] == sg[:-1]
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), ~same_as_prev])
    run_start = torch.cummax(torch.where(is_start, idx, torch.zeros_like(idx)), dim=0).values
    next_same = torch.cat([same_as_prev, torch.zeros(1, dtype=torch.bool, device=dev)])
    partner_pos = torch.where(next_same, idx + 1, run_start)
    perm = torch.zeros(B, dtype=idx.dtype, device=dev)
    perm[order] = order[partner_pos]
    return perm


def _mixable_mask(group_ids, perm, targets, cfg: MixConfig) -> torch.Tensor:
    """[B] bool: the sample mixes with its permuted partner."""
    same_group = group_ids == group_ids[perm]
    idx = torch.arange(group_ids.shape[0], device=group_ids.device)
    mask = same_group & (perm != idx) & (group_ids != -1)
    if cfg.exclude_null and cfg.null_task_keys:
        for t in cfg.null_task_keys:
            tgt = targets[t]
            is_null = tgt[:, 0] > 0.5 if tgt.dim() == 2 else tgt == 0
            mask = mask & ~is_null & ~is_null[perm]
    return mask


def mix_targets(targets, perm, lam, mask):
    out = {}
    for t, tgt in targets.items():
        tgt = tgt.float()
        mixed = lam * tgt + (1.0 - lam) * tgt[perm]
        out[t] = torch.where(mask[:, None], mixed, tgt)
    return out


def hard_pick_meta(meta, perm, mask, chunk_bounds, generator=None, picks=None):
    """Chunk-level hard pick between a sample's metadata and its partner's."""
    if meta is None or not chunk_bounds:
        return meta
    partner = meta[perm]
    out = meta.clone()
    for ci, (start, end) in enumerate(chunk_bounds):
        a = meta[:, start:end]
        b = partner[:, start:end]
        a_nz = (a != 0).any(dim=1)
        b_nz = (b != 0).any(dim=1)
        pick_b = (picks[ci].bool() if picks is not None
                  else _uniform(a_nz.shape, meta.device, generator) < 0.5)
        # both non-zero -> random pick; only b -> b; only a / both zero -> a
        use_b = torch.where(a_nz & b_nz, pick_b, (~a_nz) & b_nz)
        out[:, start:end] = torch.where((use_b & mask)[:, None], b, a)
    return out


def _draw(draws: Draws | None, key: str):
    return None if draws is None or key not in draws else draws[key]


class MixPlan(NamedTuple):
    """Who mixes with whom, and how: ``perm`` each row's partner, ``mask``
    the rows that mix, ``lam`` the targets' weight (mixup: the images' too),
    ``box`` the cut box (y1, y2, x1, x2) of cutmix, None for mixup."""

    perm: torch.Tensor
    mask: torch.Tensor
    lam: torch.Tensor
    box: tuple | None


def plan_mixing(
    group_ids: torch.Tensor,
    targets: dict[str, torch.Tensor],
    cfg: MixConfig,
    cutmix: bool,
    size: tuple[int, int],
    generator: torch.Generator | None = None,
    draws: Draws | None = None,
    gate: torch.Tensor | None = None,
) -> MixPlan:
    """The partners, the mix mask and lam of a batch of images of ``size``
    (H, W); draws perm_noise, lam, then cy and cx (cutmix), in that order."""
    dev = group_ids.device
    perm = ingroup_permutation(group_ids, generator, _draw(draws, "perm_noise"))
    mask = _mixable_mask(group_ids, perm, targets, cfg)
    if gate is not None:
        mask = mask & gate
    lam = _draw(draws, "lam")
    if lam is None:
        lam = _sample_beta(cfg.cutmix_alpha if cutmix else cfg.mixup_alpha, dev, generator)
    if not cutmix:
        return MixPlan(perm, mask, lam, None)
    H, W = size
    if cfg.cutmix_minmax is not None:
        lo, hi = float(cfg.cutmix_minmax[0]), float(cfg.cutmix_minmax[1])
        lam = lo + (hi - lo) * lam
    cy, cx = _draw(draws, "cy"), _draw(draws, "cx")
    if cy is None or cx is None:
        if generator is None:
            raise ValueError("collate: pass a torch.Generator or the random draws themselves")
        cy = torch.randint(0, H, (), generator=generator, device=dev)
        cx = torch.randint(0, W, (), generator=generator, device=dev)
    y1, y2, x1, x2 = _rand_bbox(H, W, lam, cy, cx)
    # adjusted lam = 1 - actual box area fraction
    lam_adj = 1.0 - ((y2 - y1) * (x2 - x1)).float() / float(H * W)
    return MixPlan(perm, mask, lam_adj, (y1, y2, x1, x2))


def mix_images(images: torch.Tensor, partner: torch.Tensor, mask: torch.Tensor,
               plan: MixPlan) -> torch.Tensor:
    """``images`` (B, H, W, C) mixed with ``partner`` (each row's partner
    image) where ``mask``: interpolated by lam (mixup) or the partner's box
    pasted (cutmix)."""
    B = images.shape[0]
    if plan.box is None:
        im_mask = mask.reshape((B,) + (1,) * (images.dim() - 1))
        mixed_images = plan.lam * images + (1.0 - plan.lam) * partner
        return torch.where(im_mask, mixed_images.to(images.dtype), images)
    y1, y2, x1, x2 = plan.box
    rows = torch.arange(images.shape[1], device=images.device)[None, :, None, None]
    cols = torch.arange(images.shape[2], device=images.device)[None, None, :, None]
    in_box = (rows >= y1) & (rows < y2) & (cols >= x1) & (cols < x2)
    return torch.where(mask.reshape(B, 1, 1, 1) & in_box, partner, images)


def _selective(cutmix, images, targets, meta, group_ids, cfg, generator, draws, gate):
    plan = plan_mixing(group_ids, targets, cfg, cutmix, tuple(images.shape[1:3]), generator,
                       draws, gate)
    images = mix_images(images, images[plan.perm], plan.mask, plan)
    targets = mix_targets(targets, plan.perm, plan.lam, plan.mask)
    meta = hard_pick_meta(meta, plan.perm, plan.mask, cfg.chunk_bounds, generator,
                           _draw(draws, "meta_pick"))
    return images, targets, meta, plan.mask


def selective_mixup(
    images: torch.Tensor,
    targets: dict[str, torch.Tensor],
    meta: torch.Tensor | None,
    group_ids: torch.Tensor,
    cfg: MixConfig,
    generator: torch.Generator | None = None,
    draws: Draws | None = None,
    gate: torch.Tensor | None = None,
):
    """Returns (images, targets, meta, mixed_mask). ``gate`` is an optional
    bool scalar tensor and-ed into the mask (the scheduled mix decision)."""
    return _selective(False, images, targets, meta, group_ids, cfg, generator, draws, gate)


def _rand_bbox(h: int, w: int, lam, cy, cx):
    """Cut box with area ratio (1 - lam) around the centre (cy, cx)."""
    cut_rat = torch.sqrt(1.0 - lam)
    cut_h = (h * cut_rat).to(torch.int32)
    cut_w = (w * cut_rat).to(torch.int32)
    half_h = torch.div(cut_h, 2, rounding_mode="floor")
    half_w = torch.div(cut_w, 2, rounding_mode="floor")
    y1 = torch.clamp(cy - half_h, 0, h)
    y2 = torch.clamp(cy + half_h, 0, h)
    x1 = torch.clamp(cx - half_w, 0, w)
    x2 = torch.clamp(cx + half_w, 0, w)
    return y1, y2, x1, x2


def selective_cutmix(
    images: torch.Tensor,
    targets: dict[str, torch.Tensor],
    meta: torch.Tensor | None,
    group_ids: torch.Tensor,
    cfg: MixConfig,
    generator: torch.Generator | None = None,
    draws: Draws | None = None,
    gate: torch.Tensor | None = None,
):
    """CutMix variant: paste the partner's box; targets are weighted by the
    true box area. Images are (B, H, W, C)."""
    return _selective(True, images, targets, meta, group_ids, cfg, generator, draws, gate)


def apply_mixing(
    images: torch.Tensor,
    targets: dict[str, torch.Tensor],
    meta: torch.Tensor | None,
    group_ids: torch.Tensor,
    cfg: MixConfig,
    mix_prob: float | torch.Tensor,
    use_cutmix: bool,
    generator: torch.Generator | None = None,
    draws: Draws | None = None,
):
    """Gate mixing by the scheduled probability; pick mixup or cutmix.

    The gate (uniform < ``mix_prob``) is a device scalar and-ed into the mix
    mask: a step that does not mix leaves every sample as it was, exactly as
    the TPU package's unmixed branch does, without the host reading the
    gate. ``use_cutmix`` is a host bool (the schedule decides it on the
    host)."""
    soft = {t: v.float() for t, v in targets.items()}
    if not (cfg.mixup_enabled or cfg.cutmix_enabled):
        none = torch.zeros(images.shape[0], dtype=torch.bool, device=images.device)
        return images, soft, meta, none
    gate_draw = _draw(draws, "gate")
    if gate_draw is None:
        gate_draw = _uniform((), images.device, generator)
    gate = gate_draw < mix_prob
    mix = selective_cutmix if uses_cutmix(cfg, use_cutmix) else selective_mixup
    return mix(images, soft, meta, group_ids, cfg, generator, draws, gate)


def uses_cutmix(cfg: MixConfig, use_cutmix: bool) -> bool:
    """Whether a step mixes by cutmix (else by mixup)."""
    return cfg.cutmix_enabled and (not cfg.mixup_enabled or bool(use_cutmix))


def apply_meta_masking(
    meta: torch.Tensor | None,
    mask_prob: float | torch.Tensor,
    generator: torch.Generator | None = None,
    coins: torch.Tensor | None = None,
):
    """Zero each sample's whole aux vector with probability ``mask_prob``
    (``coins``: uniform [B]). Returns (meta, masked_flags)."""
    if meta is None:
        return meta, None
    if coins is None:
        coins = _uniform((meta.shape[0],), meta.device, generator)
    flags = coins < mask_prob
    return torch.where(flags[:, None], torch.zeros_like(meta), meta), flags


def apply_partial_meta_masking(
    meta: torch.Tensor | None,
    partial_prob: float | torch.Tensor,
    combo_mask: torch.Tensor,
    already_masked: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    coins: torch.Tensor | None = None,
):
    """Zero a whitelisted component combination per sample with probability
    ``partial_prob``. ``combo_mask`` is a [meta_dim] 0/1 vector marking the
    columns of the combination chosen for this step; samples already fully
    masked are skipped."""
    if meta is None:
        return meta
    if coins is None:
        coins = _uniform((meta.shape[0],), meta.device, generator)
    flags = coins < partial_prob
    if already_masked is not None:
        flags = flags & ~already_masked
    zeroed = meta * (1.0 - combo_mask)[None, :].to(meta.dtype)
    return torch.where(flags[:, None], zeroed, meta)
