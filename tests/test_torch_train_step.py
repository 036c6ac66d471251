"""The port's train and eval steps against the TPU package's.

A narrow mFormerV1 with two blocks in its first ConvNeXt and RoPE stages
(64 px, metadata TEMPORAL(2) + SPATIAL(3)) starts from the same weights on
both sides (seeded numpy noise on a JAX init, bridged with
``state_dict_from_jax``) and sees the same batch (seeded numpy). The JAX
model runs its Pallas kernels in interpret mode (flash attention forward;
the fused ConvNeXt MLP forward and, with ``_FORCE_KERNEL_BWD``, backward);
the port runs K1 and K2 through their autograd Functions (plain route on the
CPU). A JAX key and a torch generator never agree, so the port's step is
handed the JAX step's own draws, replayed from its key splits.

Tolerances, float32: loss and per-task losses 1e-4, gradient norms 1e-3
relative, Adam's first moment (the clipped gradients) 1e-4 of its largest
entry, parameters 2e-5 after three AdamW steps at rate 1e-3, except where the
gradient is float noise (below 1e-7: the bias before a LayerNorm, the key
bias under the softmax), which AdamW normalises to a full step of either
sign. bfloat16 compute over float32 parameters: loss 2e-2, gradient norms
10% (8 mantissa bits through 12 blocks, rounded at other places by the two
frameworks). With the on-device augmentation (JAX's draws for the same
key, tests/test_torch_augmentation.py) the preprocess order and a step
match to the same bars, the images to the augmentation's 2e-5; the
GradNorm step re-forwards exactly what the train step consumed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import linnaeus_tpu.data.collate as jc
import linnaeus_tpu.ops.flash_attention as jfa
import linnaeus_tpu.ops.fused_mlp as jfm
import linnaeus_tpu.train.step as jstep
from linnaeus_tpu.data.augmentation import autoaugment as jaa
from linnaeus_tpu.configuration.defaults import get_default_config
from linnaeus_tpu.loss import soft_target_cross_entropy as j_stce
from linnaeus_tpu.models import MFormerV1 as JMFormerV1
from linnaeus_tpu.optim import build as j_build
from linnaeus_tpu.optim import schedules as j_sched
from linnaeus_tpu.train.state import create_train_state as j_create_state
from linnaeus_tpu_torch.configuration.train_presets import train_preset
from linnaeus_tpu_torch.data import collate as tc
from linnaeus_tpu_torch.data.augmentation import autoaugment as taa
from linnaeus_tpu_torch.loss import gradnorm as tgn
from linnaeus_tpu_torch.loss import soft_target_cross_entropy as t_stce
from linnaeus_tpu_torch.models.build import build_model
from linnaeus_tpu_torch.optim.build import build_optimizer
from linnaeus_tpu_torch.optim.schedules import build_schedule
from linnaeus_tpu_torch.tools import train_bench
from linnaeus_tpu_torch.train.state import TrainState, create_train_state
from linnaeus_tpu_torch.train.step import (
    ScheduleScalars,
    make_eval_step,
    make_gradnorm_step,
    make_preprocess_fn,
    make_train_step,
)
from linnaeus_tpu_torch.utils.convert import adamw_moments_from_optax, state_dict_from_jax
from tests.test_torch_augmentation import jax_pipeline_draws
from tests.test_torch_collate import mixing_draws

TASKS = ("taxa_L10", "taxa_L20")
NC = {"taxa_L10": 7, "taxa_L20": 3}
META = (("TEMPORAL", 2), ("SPATIAL", 3))
BOUNDS = ((0, 2), (2, 5))
DEPTHS, ROPE_DEPTHS = (2, 1, 2, 1), (2, 1)
DIMS = (8, 16, 32, 64)
SPEC = {
    "CONVNEXT": {"DEPTHS": list(DEPTHS), "DIMS": list(DIMS)},
    "ROPE": {"DEPTHS": list(ROPE_DEPTHS), "DIMS": [32, 64], "NUM_HEADS": [2, 2]},
    "DROP_PATH_RATE": 0.0,
}
BRIDGE = (DEPTHS, ROPE_DEPTHS, ("TEMPORAL", "SPATIAL"), TASKS)
B, IMG = 8, 64
SEED_KEY = 7


@pytest.fixture(autouse=True)
def pallas_on_cpu(monkeypatch):
    interpret = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(jfm.pl, "pallas_call", interpret)
    monkeypatch.setattr(jfa.pl, "pallas_call", interpret)
    monkeypatch.setattr(jfm, "_FORCE_KERNEL_BWD", True)


def _batch():
    rng = np.random.default_rng(0)
    labels = {t: rng.integers(0, n, B) for t, n in NC.items()}
    labels["taxa_L10"][:2] = 0  # null-labelled
    return {
        "images": rng.normal(size=(B, IMG, IMG, 3)).astype(np.float32),
        "targets": {t: np.eye(n, dtype=np.float32)[labels[t]] for t, n in NC.items()},
        "aux": rng.normal(size=(B, 5)).astype(np.float32),
        "group_ids": (np.arange(B) // 2).astype(np.int32),
    }


def _tree(x, leaf):
    return {k: _tree(v, leaf) for k, v in x.items()} if isinstance(x, dict) else leaf(x)


def _configs(base_lr=1e-3):
    jcfg, cfg = get_default_config(), train_preset()
    jcfg.defrost()
    cfg.LR_SCHEDULER.BASE_LR, cfg.LR_SCHEDULER.WARMUP_STEPS = base_lr, 0
    for section in ("OPTIMIZER", "LR_SCHEDULER"):
        for k, v in cfg[section].items():
            if k != "PARAMETER_GROUPS":
                jcfg[section][k] = v
    return jcfg, cfg


def _setup(dtype="float32", accum=1, mix=None, base_lr=1e-3, j_kw=None, t_kw=None, **step_kw):
    """(jax step, jax state, torch step, torch state) on shared weights;
    ``j_kw`` / ``t_kw`` go to one side's ``make_train_step`` only."""
    mix = mix or {"chunk_bounds": BOUNDS}
    jm = JMFormerV1(
        img_size=(IMG, IMG), convnext_depths=DEPTHS, convnext_dims=DIMS,
        rope_depths=ROPE_DEPTHS, rope_dims=(32, 64), rope_num_heads=(2, 2),
        drop_path_rate=0.0, meta_components=META, task_keys=TASKS, num_classes=NC,
        head_configs={t: {"TYPE": "Linear"} for t in TASKS},
        use_flash_attn=True, fused_convnext_mlp=True, dtype=getattr(jnp, dtype),
    )
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, IMG, IMG, 3)), jnp.zeros((2, 5)))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)
    jcfg, cfg = _configs(base_lr)
    j_schedule = j_sched.build_schedule(jcfg, 100)
    j_state = j_create_state(jm, jax.tree.map(jnp.asarray, params),
                             j_build.build_optimizer(jcfg, j_schedule), num_tasks=2,
                             rng=jax.random.PRNGKey(SEED_KEY))
    j_step = jax.jit(jstep.make_train_step(
        {t: j_stce for t in TASKS}, TASKS, jc.MixConfig(**mix), clip_grad=5.0,
        accumulation_steps=accum, lr_schedule=j_schedule, **step_kw, **(j_kw or {})))

    model = build_model(SPEC, IMG, NC, META, dtype=getattr(torch, dtype), use_flash_attn=True,
                        fused_convnext_mlp=True, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, *BRIDGE), strict=True)
    schedule = build_schedule(cfg, 100)
    t_state = create_train_state(model, build_optimizer(cfg, schedule, model), num_tasks=2,
                                 generator=torch.Generator().manual_seed(0), lr_schedule=schedule)
    t_step = make_train_step(
        {t: t_stce for t in TASKS}, TASKS, tc.MixConfig(**mix), clip_grad=5.0,
        accumulation_steps=accum, lr_schedule=schedule, **step_kw, **(t_kw or {}))
    return j_step, j_state, t_step, t_state


def _uniform(key, shape=(B,)):
    return torch.tensor(np.asarray(jax.random.uniform(key, shape)))


def step_draws(step, mix_cfg, use_cutmix=False, micro=None, rows=B):
    """The draws the JAX train step makes at ``step`` (for microbatch
    ``micro`` under accumulation), by the port's names."""
    r_pre, r_loss = jstep.train_step_rngs(jax.random.PRNGKey(SEED_KEY), step)
    if micro is not None:
        r_pre, r_loss = jax.random.fold_in(r_pre, micro), jax.random.fold_in(r_loss, micro)
    r_mix, r_meta, r_partial, _ = jax.random.split(r_pre, 4)
    draws = mixing_draws(r_mix, rows, mix_cfg, use_cutmix, IMG, IMG)
    draws["meta_coins"] = _uniform(r_meta, (rows,))
    draws["partial_coins"] = _uniform(r_partial, (rows,))
    _, r_null, _ = jax.random.split(r_loss, 3)
    draws["null_coins"] = {t: _uniform(jax.random.fold_in(r_null, i), (rows,))
                           for i, t in enumerate(TASKS)}
    return draws


def _scalars(case):
    if case == "plain":
        return jstep.ScheduleScalars.zeros(5), ScheduleScalars.zeros(5)
    combo = np.array([1, 1, 0, 0, 0], np.float32)
    kw = dict(mix_prob=1.0, meta_mask_prob=0.5, partial_mask_prob=0.5, null_mask_prob=0.5)
    j = jstep.ScheduleScalars(use_cutmix=jnp.asarray(False), partial_combo_mask=jnp.asarray(combo),
                              **{k: jnp.float32(v) for k, v in kw.items()})
    return j, ScheduleScalars(use_cutmix=False, partial_combo_mask=torch.tensor(combo), **kw)


def _compare_metrics(t_m, j_m, loss_atol, norm_rtol):
    np.testing.assert_allclose(float(t_m["loss"]), float(j_m["loss"]), atol=loss_atol)
    for t in TASKS:
        np.testing.assert_allclose(float(t_m[f"loss/{t}"]), float(j_m[f"loss/{t}"]), atol=loss_atol)
        for k in ("acc1", "acc3"):
            np.testing.assert_allclose(float(t_m[f"{k}/{t}"]), float(j_m[f"{k}/{t}"]), atol=1e-6)
    for k in ("grad_norm_pre_clip", "grad_norm_post_clip"):
        np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), rtol=norm_rtol)
    np.testing.assert_allclose(float(t_m["mixed_frac"]), float(j_m["mixed_frac"]), atol=1e-6)
    np.testing.assert_allclose(float(t_m["lr"]), float(j_m["lr"]), rtol=1e-6)
    assert set(t_m) == set(j_m)


@pytest.mark.parametrize("case", ["plain", "mixed_masked"])
def test_three_train_steps_match_jax(case):
    _three_train_steps(case)


def test_three_train_steps_match_jax_with_the_split_backward(monkeypatch):
    """The same three steps with K1's backward forced onto its split route
    (dQ and dK/dV plain versions) in both RoPE stages of the port. A stage
    past 1024 tokens, where the route is taken by itself, is too slow for the
    CPU; the JAX side takes its plain attention backward either way."""
    import linnaeus_tpu_torch.ops.flash_attention as tfa

    calls = []
    plain_dq = tfa.flash_attention_bwd_dq_reference
    monkeypatch.setattr(tfa, "backward_route", lambda n: "split")
    monkeypatch.setattr(tfa, "flash_attention_bwd_dq_reference",
                        lambda *a: calls.append(a[0].shape[1]) or plain_dq(*a))
    _three_train_steps("mixed_masked")
    # three steps x (two stage-3 blocks at 16 + 3 tokens, one stage-4 block at 4 + 3)
    assert sorted(calls) == [7] * 3 + [19] * 6


def _three_train_steps(case):
    j_step, j_state, t_step, t_state = _setup()
    batch = _batch()
    j_batch, t_batch = _tree(batch, jnp.asarray), _tree(batch, torch.tensor)
    j_scalars, t_scalars = _scalars(case)
    mix_cfg = jc.MixConfig(chunk_bounds=BOUNDS)
    before = {n: p.detach().clone() for n, p in t_state.model.named_parameters()}
    for step in range(3):
        j_state, j_m = j_step(j_state, j_batch, j_scalars)
        t_state, t_m = t_step(t_state, t_batch, t_scalars, draws=step_draws(step, mix_cfg))
        _compare_metrics(t_m, j_m, loss_atol=1e-4, norm_rtol=1e-3)
        assert float(t_m["grad_norm_post_clip"]) <= 5.0 + 1e-4
    if case == "mixed_masked":
        assert float(t_m["mixed_frac"]) == 1.0  # every sample has an in-group partner
    assert t_state.step == int(j_state.step) == 3

    mu, _, count = adamw_moments_from_optax(jax.tree.map(np.asarray, j_state.opt_state), *BRIDGE)
    want = state_dict_from_jax(jax.tree.map(np.asarray, j_state.params), *BRIDGE)
    assert count == 3
    mu_scale = max(float(v.abs().max()) for v in mu.values())
    checked = total = 0
    moved = 0.0
    for name, p in t_state.model.named_parameters():
        got_mu = t_state.optimizer.state[p]["exp_avg"]
        np.testing.assert_allclose(got_mu.numpy(), mu[name].numpy(), rtol=0,
                                   atol=1e-4 * mu_scale, err_msg=f"exp_avg {name}")
        real = mu[name].abs() >= 1e-7  # elsewhere AdamW steps on float noise
        np.testing.assert_allclose(p.detach()[real].numpy(), want[name][real].numpy(),
                                   rtol=0, atol=2e-5, err_msg=name)
        checked, total = checked + int(real.sum()), total + real.numel()
        moved = max(moved, float((p.detach() - before[name]).abs().max()))
    assert checked >= 0.95 * total, (checked, total)
    assert moved > 1e-3  # three steps at rate 1e-3 did move the parameters


def test_accumulation_matches_jax_and_the_full_batch():
    mix_off = {"mixup_enabled": False, "cutmix_enabled": False}
    j_step, j_state, t_step2, t_state2 = _setup(accum=2, mix=mix_off)
    batch = _batch()
    j_batch, t_batch = _tree(batch, jnp.asarray), _tree(batch, torch.tensor)
    j_scalars, t_scalars = _scalars("plain")
    cfg = jc.MixConfig(**mix_off)
    _, j_m = j_step(j_state, j_batch, j_scalars)
    draws = [step_draws(0, cfg, micro=i, rows=B // 2) for i in range(2)]
    _, m2 = t_step2(t_state2, t_batch, t_scalars, draws=draws)
    _compare_metrics(m2, j_m, loss_atol=1e-4, norm_rtol=1e-3)

    # the port's own accum=2 against its full batch, under SGD (the update is
    # linear in the gradient; AdamW would amplify float noise), as the TPU
    # package's test does
    states, metrics = [], []
    for accum in (1, 2):
        _, _, step, state = _setup(accum=accum, mix=mix_off)
        state.optimizer, state.lr_schedule = torch.optim.SGD(state.model.parameters(), lr=0.1), None
        metrics.append(step(state, t_batch, t_scalars,
                            draws=step_draws(0, cfg) if accum == 1 else draws)[1])
        states.append(state)
    m1, m2 = metrics
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-4)
    assert set(m1) == set(m2)
    for t in TASKS:
        np.testing.assert_allclose(float(m1[f"acc1/{t}"]), float(m2[f"acc1/{t}"]), atol=1e-6)
        np.testing.assert_allclose(float(m1[f"loss/{t}"]), float(m2[f"loss/{t}"]), rtol=1e-4)
    for (name, a), (_, b) in zip(states[0].model.named_parameters(),
                                 states[1].model.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=2e-3, atol=2e-5,
                                   err_msg=name)


def test_bf16_compute_over_fp32_parameters_matches_jax():
    j_step, j_state, t_step, t_state = _setup(dtype="bfloat16")
    batch = _batch()
    j_scalars, t_scalars = _scalars("mixed_masked")
    mix_cfg = jc.MixConfig(chunk_bounds=BOUNDS)
    j_state, j_m = j_step(j_state, _tree(batch, jnp.asarray), j_scalars)
    t_state, t_m = t_step(t_state, _tree(batch, torch.tensor), t_scalars,
                          draws=step_draws(0, mix_cfg))
    np.testing.assert_allclose(float(t_m["loss"]), float(j_m["loss"]), atol=2e-2)
    np.testing.assert_allclose(float(t_m["grad_norm_pre_clip"]), float(j_m["grad_norm_pre_clip"]),
                               rtol=0.1)
    for name, p in t_state.model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p).all(), name
    # the K2 weights got their gradient through the bfloat16 cast
    blk = t_state.model.stages[0][0]
    assert blk.pwconv1.weight.grad.abs().max() > 0 and blk.gamma.grad.abs().max() > 0


def test_eval_step_counts_match_jax():
    _, j_state, _, t_state = _setup()
    batch = _batch()
    batch["targets"]["taxa_L20"][3] = 0.0  # an unmapped sample
    j_eval = jax.jit(jstep.make_eval_step({t: j_stce for t in TASKS}, TASKS, null_tasks=("taxa_L10",)))
    t_eval = make_eval_step({t: t_stce for t in TASKS}, TASKS, null_tasks=("taxa_L10",),
                            taxa_selectors={"one": ("taxa_L20", 1)},
                            subset_bins={"taxa_L10": np.array([0, 0, 1, 1, 2, 2, 2])})
    for mask_meta in (False, True):
        combo = np.array([0, 0, 1, 1, 1], np.float32)
        j_m, j_out = j_eval(j_state, _tree(batch, jnp.asarray), jnp.asarray(mask_meta),
                            jnp.asarray(combo))
        t_m, t_out = t_eval(t_state, _tree(batch, torch.tensor), mask_meta, torch.tensor(combo))
        assert float(t_m["count"]) == 8
        for k, v in j_m.items():
            np.testing.assert_allclose(float(t_m[k]), float(v), atol=1e-4, err_msg=k)
        for t in TASKS:
            np.testing.assert_allclose(t_out[t].numpy(), np.asarray(j_out[t]), atol=1e-4)
            assert int(t_m[f"correct3/{t}"]) >= int(t_m[f"correct1/{t}"])
            assert sum(float(v) for k, v in t_m.items()
                       if k.startswith("subset_count/rarity") and k.endswith(t)) in (0.0, 8.0)
    assert float(t_m["valid_count/taxa_L20"]) == 7
    assert not t_state.model.training


def test_drop_path_draws_from_the_step_generator():
    """With stochastic depth on, a step is reproducible from its seed, and
    the fused tail runs without the in-kernel residual under grad."""
    spec = dict(SPEC, DROP_PATH_RATE=0.5)
    losses = []
    for seed in (3, 3, 4):
        model = build_model(spec, IMG, NC, META, fused_convnext_mlp=True, device="cpu", seed=0)
        state = create_train_state(
            model, torch.optim.SGD(model.parameters(), lr=0.0), 2,
            torch.Generator().manual_seed(seed))
        step = make_train_step({t: t_stce for t in TASKS}, TASKS,
                               tc.MixConfig(mixup_enabled=False), num_classes=NC)
        labels = {t: torch.tensor(np.argmax(v, -1)) for t, v in _batch()["targets"].items()}
        batch = dict(_tree(_batch(), torch.tensor), targets=labels)
        _, m = step(state, batch, ScheduleScalars.zeros(5))
        losses.append(float(m["loss"]))
        assert model.stages[0][1].pwconv1.weight.grad is not None
    assert losses[0] == losses[1] != losses[2]


def test_unported_paths_raise_and_the_entry_point_needs_a_card():
    with pytest.raises(NotImplementedError, match="MoE"):
        make_train_step({}, TASKS, tc.MixConfig(), moe_aux_weight=0.01)
    model = torch.nn.Sequential(torch.nn.BatchNorm1d(3))
    state = TrainState(0, model, torch.optim.SGD(model.parameters(), lr=0.1), None,
                       torch.Generator())
    with pytest.raises(NotImplementedError, match="BatchNorm"):
        make_train_step({}, (), tc.MixConfig())(state, {}, ScheduleScalars.zeros(1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_bench.build_step(2, 32, arch=SPEC)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_bench.main(["--batch", "2", "--img", "32"])
    out = train_bench.measure(4, 32, arch=SPEC, num_classes=NC, meta_components=META,
                              device="cpu", steps=2)
    assert out["device"] == "cpu" and out["final_step"] == 3
    assert all(np.isfinite(out["loss"])) and all(np.isfinite(out["grad_norm_pre_clip"]))


def _augmenters(erase=0.5):
    return (jaa.make_batched_augment(jaa.make_train_augment("original", 0.4, erase)),
            taa.make_train_augment("original", 0.4, erase))


def _uint8_batch():
    batch = _batch()
    batch["images"] = np.random.default_rng(4).integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
    return batch


def _augment_draws(step, table, erase=0.5):
    r_pre, _ = jstep.train_step_rngs(jax.random.PRNGKey(SEED_KEY), step)
    r_aug = jax.random.split(r_pre, 4)[3]
    return jax_pipeline_draws(r_aug, table, B, erase=erase, h=IMG, w=IMG)


def test_preprocess_order_with_augmentation_matches_jax():
    """uint8 -> [0, 1] -> AutoAugment, jitter, flip, erase -> mixing ->
    meta-masking, with every draw of the JAX key, to the augmentation's bar."""
    jaug, taug = _augmenters()
    mix_cfg = jc.MixConfig(chunk_bounds=BOUNDS)
    batch = _uint8_batch()
    j_scalars, t_scalars = _scalars("mixed_masked")
    jpre = jstep.make_preprocess_fn(mix_cfg, has_meta=True, augment_fn=jaug)
    tpre = make_preprocess_fn(tc.MixConfig(chunk_bounds=BOUNDS), has_meta=True, augment_fn=taug)
    r_pre, _ = jstep.train_step_rngs(jax.random.PRNGKey(SEED_KEY), 0)
    want = jpre(dict(_tree(batch, jnp.asarray), _scalars=j_scalars), r_pre)
    draws = dict(step_draws(0, mix_cfg), augment=_augment_draws(0, taug.table))
    got = tpre(_tree(batch, torch.tensor), t_scalars, None, draws)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=2e-5)
    for t in TASKS:
        np.testing.assert_allclose(got[1][t].numpy(), np.asarray(want[1][t]), atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-6)
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    plain = tpre(_tree(batch, torch.tensor), t_scalars, None, step_draws(0, mix_cfg))
    assert float((plain[0] - got[0]).abs().max()) > 0.1  # the augmentation did act


def test_train_step_with_augmentation_matches_jax():
    jaug, taug = _augmenters()
    j_step, j_state, t_step, t_state = _setup(j_kw={"augment_fn": jaug},
                                              t_kw={"augment_fn": taug})
    batch = _uint8_batch()
    j_scalars, t_scalars = _scalars("mixed_masked")
    mix_cfg = jc.MixConfig(chunk_bounds=BOUNDS)
    for step in range(2):
        j_state, j_m = j_step(j_state, _tree(batch, jnp.asarray), j_scalars)
        draws = dict(step_draws(step, mix_cfg), augment=_augment_draws(step, taug.table))
        t_state, t_m = t_step(t_state, _tree(batch, torch.tensor), t_scalars, draws=draws)
        _compare_metrics(t_m, j_m, loss_atol=1e-4, norm_rtol=1e-3)


def _gradnorm_setup(accum, zero_aux):
    _, _, _, state = _setup(accum=accum)
    _, taug = _augmenters()
    step = make_train_step({t: t_stce for t in TASKS}, TASKS, tc.MixConfig(chunk_bounds=BOUNDS),
                           accumulation_steps=accum, augment_fn=taug, keep_collated=True)
    trunk = [n for n, _ in state.model.named_parameters() if not n.startswith(("head", "meta_"))]
    update = tgn.make_gradnorm_update_fn({t: t_stce for t in TASKS}, TASKS, trunk, alpha=1.5,
                                         zero_aux_info=zero_aux, remat=True)
    return state, step, make_gradnorm_step(update)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("zero_aux", [True, False])
def test_gradnorm_reforwards_what_the_step_consumed(accum, zero_aux):
    """The GradNorm step's re-forward sees the augmented, mixed and
    meta-masked tensors of the last train step (microbatches joined), in
    the compute dtype, with the metadata zeroed under ZERO_AUX_INFO; its
    criteria see the mixed soft targets."""
    state, step, gradnorm_step = _gradnorm_setup(accum, zero_aux)
    seen = []
    hook = state.model.register_forward_pre_hook(
        lambda mod, args, kwargs: seen.append((args[0].detach().clone(),
                                              None if args[1] is None else args[1].clone(),
                                              kwargs.get("gradnorm_mode", False))),
        with_kwargs=True)
    _, t_scalars = _scalars("mixed_masked")
    _, m = step(state, _tree(_uint8_batch(), torch.tensor), t_scalars,
                draws=None if accum == 1 else [None] * accum)
    consumed = seen[:]
    seen.clear()
    state, gm = gradnorm_step(state)
    hook.remove()
    images = torch.cat([c[0] for c in consumed])
    meta = torch.cat([c[1] for c in consumed])
    assert len(consumed) == accum and len(seen) == len(TASKS)
    assert float(m["mixed_frac"]) > 0 and float((meta - _tree(_batch(), torch.tensor)["aux"])
                                                .abs().max()) > 0
    for imgs, mta, mode in seen:
        assert mode is True
        assert torch.equal(imgs, images.to(state.model.dtype))
        assert torch.equal(mta, torch.zeros_like(meta) if zero_aux else meta)
    assert torch.isfinite(gm["gradnorm/norms"]).all() and (gm["gradnorm/norms"] > 0).all()
    np.testing.assert_allclose(float(state.gradnorm.task_weights.sum()), len(TASKS), rtol=1e-6)
    assert bool(state.gradnorm.has_initted)
    assert state.model.training is False or state.model.gradient_checkpointing is False
