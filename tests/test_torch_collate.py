"""The port's on-device collate against the TPU package's, draw for draw.

A JAX PRNG key and a torch generator never agree, so each test replays the
key splits of linnaeus_tpu/data/collate.py, computes the JAX draws and
hands them to the port as operands. Inputs come from numpy with a fixed
seed; everything is float32 and must agree to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linnaeus_tpu.data.collate as jc
from linnaeus_tpu_torch.data import collate as tc

BOUNDS = ((0, 2), (2, 5))
ATOL = 1e-6


def _batch(seed=0, B=8, hw=6):
    rng = np.random.default_rng(seed)
    aux = rng.normal(size=(B, 5)).astype(np.float32)
    aux[1, :2] = 0.0  # a zero chunk, a zero row
    aux[4] = 0.0
    labels = {"a": rng.integers(0, 6, B), "b": rng.integers(0, 3, B)}
    return {
        "images": rng.normal(size=(B, hw, hw, 3)).astype(np.float32),
        "targets": {t: np.eye(n, dtype=np.float32)[labels[t]] for t, n in (("a", 6), ("b", 3))},
        "aux": aux,
        "group_ids": np.array([0, 0, 1, 1, 1, 2, -1, -1], np.int32),
    }


def _t(x):
    return {k: _t(v) for k, v in x.items()} if isinstance(x, dict) else torch.tensor(np.asarray(x))


def _meta_picks(r_meta, B, n_chunks):
    return torch.tensor(np.asarray([
        jax.random.bernoulli(jax.random.fold_in(r_meta, ci), 0.5, (B,))
        for ci in range(n_chunks)], dtype=bool).reshape(n_chunks, B))


def mixup_draws(rng, B, alpha, n_chunks):
    """The draws ``selective_mixup`` makes from ``rng``."""
    r_perm, r_lam, r_meta = jax.random.split(rng, 3)
    return {
        "perm_noise": _t(jax.random.uniform(r_perm, (B,))),
        "lam": _t(jax.random.beta(r_lam, alpha, alpha)),
        "meta_pick": _meta_picks(r_meta, B, n_chunks),
    }


def cutmix_draws(rng, B, alpha, n_chunks, h, w):
    r_perm, r_lam, r_box, r_meta = jax.random.split(rng, 4)
    ry, rx = jax.random.split(r_box)
    return {
        "perm_noise": _t(jax.random.uniform(r_perm, (B,))),
        "lam": _t(jax.random.beta(r_lam, alpha, alpha)),
        "cy": _t(jax.random.randint(ry, (), 0, h)),
        "cx": _t(jax.random.randint(rx, (), 0, w)),
        "meta_pick": _meta_picks(r_meta, B, n_chunks),
    }


def mixing_draws(rng, B, cfg, use_cutmix, h, w):
    """The draws ``apply_mixing`` makes from ``rng``."""
    r_gate, r_mix = jax.random.split(rng)
    cut = cfg.cutmix_enabled and (not cfg.mixup_enabled or use_cutmix)
    draws = (cutmix_draws(r_mix, B, cfg.cutmix_alpha, len(cfg.chunk_bounds), h, w) if cut
             else mixup_draws(r_mix, B, cfg.mixup_alpha, len(cfg.chunk_bounds)))
    draws["gate"] = _t(jax.random.uniform(r_gate, ()))
    return draws


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, err_msg=msg)


def _compare(got, want):
    for i, name in enumerate(("images", "targets", "meta", "mask")):
        if isinstance(want[i], dict):
            for t in want[i]:
                _close(got[i][t], want[i][t], f"{name}/{t}")
        else:
            _close(got[i], want[i], name)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ingroup_permutation_matches_jax(seed):
    ids = np.array([3, 0, 3, 1, 0, 3, -1, 7, 1, 0], np.int32)
    key = jax.random.PRNGKey(seed)
    want = jc.ingroup_permutation(key, jnp.asarray(ids))
    got = tc.ingroup_permutation(torch.tensor(ids), noise=_t(jax.random.uniform(key, (10,))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and from a generator: a same-group partner that is not oneself
    perm = tc.ingroup_permutation(torch.tensor(ids), torch.Generator().manual_seed(seed)).numpy()
    assert (ids[perm] == ids).all()
    multi = np.array([np.sum(ids == g) > 1 for g in ids])
    assert (perm[multi] != np.arange(10)[multi]).all() and (perm[~multi] == np.arange(10)[~multi]).all()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("exclude_null", [False, True])
def test_selective_mixup_matches_jax(seed, exclude_null):
    b = _batch(seed)
    jcfg = jc.MixConfig(mixup_alpha=0.8, chunk_bounds=BOUNDS, exclude_null=exclude_null,
                        null_task_keys=("a",))
    tcfg = tc.MixConfig(**jcfg._asdict())
    key = jax.random.PRNGKey(seed + 10)
    want = jc.selective_mixup(jnp.asarray(b["images"]), jax.tree.map(jnp.asarray, b["targets"]),
                              jnp.asarray(b["aux"]), jnp.asarray(b["group_ids"]), key, jcfg)
    got = tc.selective_mixup(_t(b["images"]), _t(b["targets"]), _t(b["aux"]), _t(b["group_ids"]),
                             tcfg, draws=mixup_draws(key, 8, 0.8, 2))
    assert np.asarray(want[3]).any()
    _compare(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("minmax", [None, (0.3, 0.7)])
def test_selective_cutmix_matches_jax(seed, minmax):
    b = _batch(seed, hw=12)
    jcfg = jc.MixConfig(cutmix_alpha=1.0, cutmix_minmax=minmax, chunk_bounds=BOUNDS,
                        cutmix_enabled=True)
    tcfg = tc.MixConfig(**jcfg._asdict())
    key = jax.random.PRNGKey(seed + 20)
    want = jc.selective_cutmix(jnp.asarray(b["images"]), jax.tree.map(jnp.asarray, b["targets"]),
                               jnp.asarray(b["aux"]), jnp.asarray(b["group_ids"]), key, jcfg)
    got = tc.selective_cutmix(_t(b["images"]), _t(b["targets"]), _t(b["aux"]), _t(b["group_ids"]),
                              tcfg, draws=cutmix_draws(key, 8, 1.0, 2, 12, 12))
    _compare(got, want)


@pytest.mark.parametrize("mix_prob", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("enabled", [(True, False, False), (True, True, True), (True, True, False),
                                     (False, True, False), (False, False, False)])
def test_apply_mixing_matches_jax(mix_prob, enabled):
    mixup, cutmix, use_cutmix = enabled
    b = _batch(4, hw=12)
    jcfg = jc.MixConfig(chunk_bounds=BOUNDS, mixup_enabled=mixup, cutmix_enabled=cutmix)
    tcfg = tc.MixConfig(**jcfg._asdict())
    for seed in range(3):  # the gate falls on both sides of 0.5
        key = jax.random.PRNGKey(seed)
        want = jc.apply_mixing(
            jnp.asarray(b["images"]), jax.tree.map(jnp.asarray, b["targets"]),
            jnp.asarray(b["aux"]), jnp.asarray(b["group_ids"]), key, jcfg,
            jnp.float32(mix_prob), jnp.asarray(use_cutmix))
        got = tc.apply_mixing(
            _t(b["images"]), _t(b["targets"]), _t(b["aux"]), _t(b["group_ids"]), tcfg,
            mix_prob, use_cutmix, draws=mixing_draws(key, 8, jcfg, use_cutmix, 12, 12))
        _compare(got, want)


@pytest.mark.parametrize("prob", [0.0, 0.4, 1.0])
def test_meta_masking_matches_jax(prob):
    b = _batch(5)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    combo = np.array([1, 1, 0, 0, 0], np.float32)
    j_meta, j_flags = jc.apply_meta_masking(jnp.asarray(b["aux"]), k1, jnp.float32(prob))
    j_part = jc.apply_partial_meta_masking(j_meta, k2, jnp.float32(0.6), jnp.asarray(combo), j_flags)
    # bernoulli(p) is uniform < p on the same key
    t_meta, t_flags = tc.apply_meta_masking(
        _t(b["aux"]), prob, coins=_t(jax.random.uniform(k1, (8,))))
    t_part = tc.apply_partial_meta_masking(
        t_meta, 0.6, torch.tensor(combo), t_flags, coins=_t(jax.random.uniform(k2, (8,))))
    np.testing.assert_array_equal(t_flags.numpy(), np.asarray(j_flags))
    _close(t_meta, j_meta)
    _close(t_part, j_part)


def test_generator_draws_are_reproducible_and_needed():
    b = _batch(6)
    cfg = tc.MixConfig(mixup_alpha=0.7, chunk_bounds=BOUNDS)
    args = (_t(b["images"]), _t(b["targets"]), _t(b["aux"]), _t(b["group_ids"]), cfg, 1.0, False)
    one = tc.apply_mixing(*args, generator=torch.Generator().manual_seed(5))
    two = tc.apply_mixing(*args, generator=torch.Generator().manual_seed(5))
    other = tc.apply_mixing(*args, generator=torch.Generator().manual_seed(6))
    assert torch.equal(one[0], two[0]) and torch.equal(one[2], two[2])
    assert one[3].any() and not torch.equal(one[0], other[0])
    with pytest.raises(ValueError, match="Generator"):
        tc.apply_mixing(*args)
    lam = torch.stack([tc._sample_beta(0.5, "cpu", torch.Generator().manual_seed(s))
                       for s in range(200)])
    assert ((lam > 0) & (lam < 1)).all() and 0.4 < lam.mean() < 0.6
