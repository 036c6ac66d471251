"""The port's on-device augmentation against the TPU package's.

Mirrors tests/test_augmentation.py. Every op of ``OP_REGISTRY`` runs on a
batch of seeded images (one of them quantised to 1/255 steps) at
magnitudes 0-10, with the TPU package's own random values: each image's
key is handed to the JAX op, and the sign (``_rand_sign``) or sigma
(``jax.random.uniform``) that JAX draws from that key is handed to the
port's op. Pointwise ops agree to 1e-5; the resampling ops (rotate, shear,
translate: ``map_coordinates`` there, ``grid_sample`` here) to 2e-5, the
border included, where the constant 0.5 comes in; equalize leaves no pixel
a 1/255 bin off (it is compared to 1e-6). Colour jitter and random erasing
take JAX's factors, boxes and fill. The policy tables equal the original's.
The whole pipeline (AutoAugment, jitter, flip, erase), and AutoAugment
alone, take every draw of the TPU package's batched functions for one key
and agree to 2e-5; the factory returns None when every augmentation is off.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linnaeus_tpu.data.augmentation.ops as JA
from linnaeus_tpu.configuration.defaults import get_default_config
from linnaeus_tpu.data.augmentation import autoaugment as jaa
from linnaeus_tpu.data.augmentation import policies as jpol
from linnaeus_tpu_torch import configuration as tconf
from linnaeus_tpu_torch.data.augmentation import autoaugment as taa
from linnaeus_tpu_torch.data.augmentation import ops as TA
from linnaeus_tpu_torch.data.augmentation import policies as tpol

N, H, W = 6, 40, 48
MAGS = np.array([0, 3, 5, 7, 9, 10], np.float64)
POINTWISE_TOL = 1e-5
RESAMPLE_TOL = 2e-5
RESAMPLING = {"Rotate", "ShearX", "ShearY", "TranslateXRel", "TranslateYRel"}
POLICIES = ("original", "originalr", "v0r", "3a", "hybrid_v0")


def _images(seed=0, n=N, h=H, w=W):
    imgs = np.random.default_rng(seed).uniform(size=(n, h, w, 3)).astype(np.float32)
    imgs[0] = np.round(imgs[0] * 255) / 255  # a uint8 image, as the loader feeds them
    return imgs


def _keys(seed=1, n=N):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def _jax_value(name, key, mag):
    if name in TA.SIGNED_OPS:
        return float(JA._rand_sign(key))
    if name == "GaussianBlurRand":
        return float(jax.random.uniform(key, (), minval=0.1, maxval=max(2 * mag / 10, 0.1)))
    return None


@pytest.mark.parametrize("name", sorted(JA.OP_REGISTRY))
def test_op_matches_jax_with_its_draws(name):
    imgs, keys = _images(), _keys()
    want = np.stack([np.asarray(JA.OP_REGISTRY[name](jnp.asarray(imgs[i]), float(MAGS[i]),
                                                     keys[i])) for i in range(N)])
    values = [_jax_value(name, keys[i], MAGS[i]) for i in range(N)]
    value = None if values[0] is None else torch.tensor(np.array(values, np.float32))
    got = TA.OP_REGISTRY[name](torch.tensor(imgs), torch.tensor(MAGS), value).numpy()
    tol = RESAMPLE_TOL if name in RESAMPLING else 1e-6 if name == "Equalize" else POINTWISE_TOL
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    if name in RESAMPLING:  # the border, where the 0.5 fill meets the image
        edge = np.zeros((H, W), bool)
        edge[:2], edge[-2:], edge[:, :2], edge[:, -2:] = True, True, True, True
        np.testing.assert_allclose(got[:, edge], want[:, edge], rtol=0, atol=RESAMPLE_TOL)


def test_resampling_fills_outside_with_one_half():
    imgs = _images()
    sign = torch.ones(N)
    out = TA.translate_x_rel(torch.tensor(imgs), torch.full((N,), 10.0), sign).numpy()
    shift = 0.45 * W  # 21.6 px: columns past it sample outside the image
    np.testing.assert_allclose(out[:, :, W - int(shift) + 1:], 0.5, atol=1e-6)
    assert np.abs(out[:, :, : W - int(shift) - 1] - 0.5).max() > 0.1


def test_color_jitter_and_erasing_match_jax():
    imgs, keys = _images(), _keys(2)
    factors = []
    want_cj = []
    for i in range(N):
        want_cj.append(np.asarray(JA.color_jitter(jnp.asarray(imgs[i]), keys[i], 0.4)))
        rb, rc, rs = jax.random.split(keys[i], 3)
        factors.append([float(jax.random.uniform(r, (), minval=0.6, maxval=1.4))
                        for r in (rb, rc, rs)])
    got = TA.color_jitter(torch.tensor(imgs), torch.tensor(factors)).numpy()
    np.testing.assert_allclose(got, np.stack(want_cj), rtol=0, atol=POINTWISE_TOL)

    for mode in ("pixel", "const"):
        want, boxes, fills = [], [], []
        for i in range(N):
            want.append(np.asarray(JA.random_erasing(jnp.asarray(imgs[i]), keys[i], mode=mode)))
            box, fill, _ = _jax_erase_draws(keys[i], mode)
            boxes.append(box)
            fills.append(fill)
        got = TA.random_erasing(torch.tensor(imgs), torch.tensor(np.array(boxes)),
                                torch.tensor(np.stack(fills))).numpy()
        np.testing.assert_array_equal(got, np.stack(want))


def _jax_erase_draws(key, mode="pixel", area_range=(0.02, 0.4), aspect_range=(0.3, 3.3),
                     h=H, w=W):
    """JAX's draws of one ``random_erasing`` call: the box (y0, x0, h, w),
    the fill, and the two uniform draws behind the box's size."""
    r1, r2, r3, r4, r5 = jax.random.split(key, 5)
    area = jax.random.uniform(r1, (), minval=area_range[0], maxval=area_range[1])
    log_ar = jax.random.uniform(r2, (), minval=jnp.log(aspect_range[0]),
                                maxval=jnp.log(aspect_range[1]))
    aspect = jnp.exp(log_ar)
    target = area * h * w
    eh = int(jnp.clip(jnp.sqrt(target * aspect), 1, h - 1).astype(jnp.int32))
    ew = int(jnp.clip(jnp.sqrt(target / aspect), 1, w - 1).astype(jnp.int32))
    y0 = int(jax.random.randint(r3, (), 0, h - eh + 1))
    x0 = int(jax.random.randint(r4, (), 0, w - ew + 1))
    fill = (np.asarray(jax.random.normal(r5, (h, w, 3))) * 0.2 + 0.5 if mode == "pixel"
            else np.zeros((h, w, 3), np.float32))
    raw = [float(jax.random.uniform(r1, ())), float(jax.random.uniform(r2, ()))]
    return [y0, x0, eh, ew], fill.astype(np.float32), raw


def test_erase_box_sizes_match_jax():
    keys = _keys(5, 32)
    raws, sizes = [], []
    for k in keys:
        box, _, raw = _jax_erase_draws(k)
        raws.append(raw + [0.0, 0.0])
        sizes.append(box[2:])
    got = TA.erase_boxes(torch.tensor(raws, dtype=torch.float32), H, W)
    np.testing.assert_array_equal(got[:, 2:].numpy(), np.array(sizes))
    assert (got[:, :2] == 0).all()  # zero corner draws put the box at the origin


@pytest.mark.parametrize("name", POLICIES)
def test_policy_tables_equal_the_original(name):
    assert tpol.get_policy(name) == jpol.get_policy(name)
    table = taa.PolicyTable(name)
    assert table.num == len(jpol.get_policy(name))
    with pytest.raises(ValueError):
        tpol.get_policy("nope")


def jax_pipeline_draws(key, table, n=N, jitter=0.4, count=1, hflip=0.5, erase=0.25, h=H, w=W):
    """Every draw the TPU package's batched train pipeline makes for ``key``,
    by the port's names."""
    out = {k: [] for k in ("policy", "gates", "op_u", "jitter", "flip", "erase",
                           "erase_boxes", "erase_fill")}
    for r in jax.random.split(key, n):
        r_aa, r_cj, r_flip, r_re_gate, r_re = jax.random.split(r, 5)
        r_pick, r_ops = jax.random.split(r_aa)
        k = int(jax.random.randint(r_pick, (), 0, table.num))
        gates, us = [], []
        for j in range(table.slots):
            r_gate, r_op = jax.random.split(jax.random.fold_in(r_ops, j))
            gates.append(bool(jax.random.bernoulli(r_gate, float(table.prob[k, j]))))
            us.append(float(jax.random.uniform(r_op, ())))
        out["policy"].append(k)
        out["gates"].append(gates)
        out["op_u"].append(us)
        out["jitter"].append([float(jax.random.uniform(x, (), minval=1 - jitter,
                                                       maxval=1 + jitter))
                              for x in jax.random.split(r_cj, 3)])
        out["flip"].append(bool(jax.random.bernoulli(r_flip, hflip)))
        out["erase"].append(bool(jax.random.bernoulli(r_re_gate, erase)))
        boxes, fills = zip(*[_jax_erase_draws(jax.random.fold_in(r_re, c), h=h, w=w)[:2]
                             for c in range(count)])
        out["erase_boxes"].append(list(boxes))
        out["erase_fill"].append(np.stack(fills))
    dtypes = {"policy": torch.int64, "gates": torch.bool, "flip": torch.bool,
              "erase": torch.bool, "erase_boxes": torch.int64}
    return {k: torch.tensor(np.array(v), dtype=dtypes.get(k, torch.float32))
            for k, v in out.items()}


@pytest.mark.parametrize("policy, count", [("original", 1), ("3a", 2), ("v0r", 1)])
def test_pipeline_with_jax_draws_matches_jax(policy, count):
    n = 16
    imgs = _images(3, n)
    key = jax.random.PRNGKey(11)
    single = jaa.make_train_augment(policy, 0.4, 0.9, random_erase_count=count)
    want = np.asarray(jaa.make_batched_augment(single)(jnp.asarray(imgs), key))
    table = taa.PolicyTable(policy)
    draws = jax_pipeline_draws(key, table, n, count=count, erase=0.9)
    assert draws["erase"].any() and draws["flip"].any() and draws["gates"].any()
    got = taa.apply_augmentation(torch.tensor(imgs), draws, table, count).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RESAMPLE_TOL)


@pytest.mark.parametrize("policy", ["original", "v0r"])
def test_autoaugment_alone_matches_jax(policy):
    """make_autoaugment: the sub-policy, gates and op draws of JAX's batched
    ``make_autoaugment`` for one key (each image's key is its own r_aa)."""
    n = 12
    imgs = _images(6, n)
    key = jax.random.PRNGKey(13)
    want = np.asarray(jaa.make_batched_augment(jaa.make_autoaugment(policy))(
        jnp.asarray(imgs), key))
    augment = taa.make_autoaugment(policy)
    table = augment.table
    draws = {k: [] for k in ("policy", "gates", "op_u")}
    for r in jax.random.split(key, n):
        r_pick, r_ops = jax.random.split(r)
        k = int(jax.random.randint(r_pick, (), 0, table.num))
        keys = [jax.random.split(jax.random.fold_in(r_ops, j)) for j in range(table.slots)]
        draws["policy"].append(k)
        draws["gates"].append([bool(jax.random.bernoulli(g, float(table.prob[k, j])))
                               for j, (g, _) in enumerate(keys)])
        draws["op_u"].append([float(jax.random.uniform(o, ())) for _, o in keys])
    draws = {"policy": torch.tensor(draws["policy"]), "gates": torch.tensor(draws["gates"]),
             "op_u": torch.tensor(draws["op_u"]), "flip": torch.zeros(n, dtype=torch.bool),
             "erase": torch.zeros(n, dtype=torch.bool)}
    got = augment(torch.tensor(imgs), draws=draws).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RESAMPLE_TOL)
    assert np.abs(want - imgs).max() > 0.1


def test_pipeline_draws_itself_and_stays_in_range():
    imgs = torch.tensor(_images(4, 16))
    augment = taa.make_train_augment()
    g = torch.Generator().manual_seed(0)
    a, b = augment(imgs, g), augment(imgs, g)
    assert a.shape == imgs.shape and float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    assert float((a - imgs).abs().max()) > 0.1 and float((a - b).abs().max()) > 0.1
    again = augment(imgs, torch.Generator().manual_seed(0))
    assert torch.equal(again, a)  # reproducible from the seed
    assert torch.equal(imgs, torch.tensor(_images(4, 16)))  # the input is left alone


def test_factory_returns_none_when_all_disabled():
    for conf in (tconf, None):
        cfg = conf.get_default_config() if conf else get_default_config()
        cfg.defrost()
        cfg.AUG.AUTOAUG.POLICY = ""
        cfg.AUG.AUTOAUG.COLOR_JITTER = 0.0
        cfg.AUG.RANDOM_ERASE.PROB = 0.0
        factory = taa.AugmentationPipelineFactory if conf else jaa.AugmentationPipelineFactory
        assert factory.create(cfg) is None
    cfg = tconf.get_default_config()
    augment = taa.AugmentationPipelineFactory.create(cfg)
    assert augment.table.num == len(jpol.get_policy("original"))
    assert math.isclose(float(cfg.AUG.AUTOAUG.COLOR_JITTER), 0.4)
