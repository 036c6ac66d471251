"""The port's abstention fine-tuning (linnaeus_tpu_torch/rl/) against the TPU package's.

Every module gets the same inputs through both packages, made from a numpy
seed (JAX's and torch's random streams never agree, so the rollout's
actions and batches are handed in as operands):

- rewards and verifier on the same episodes: equal;
- the provider over the same loader batches (numpy for JAX, torch tensors
  for the port, which normalises them where they lie): images to 1e-7
  (float32 x / 255 both ways), targets and ground truth equal;
- the environment in both modes, with gymnasium and (module loaded with
  gymnasium hidden) without it: the same observations, rewards, infos;
- ``collect_rollout`` and ``compute_gae_and_returns``: equal arrays;
- the policy on a tiny mFormerV1 (the DIMS of
  tests/test_parity_reference.py:39-42 over four stages) with weights
  carried across by ``utils/convert.py::policy_state_dict_from_jax``:
  logits, value and ``evaluate_actions`` at the model bar (ROADMAP.md: ~4e-5
  on logits) in float32; the abstain-prior bias equal;
- ``warm_start_actor_heads``, ``evaluate_abstention``: equal;
- one ``make_ppo_update`` step on the same parameters and batch, with K1
  and K2 on (Pallas in interpret mode on the JAX side, the wrappers' plain
  versions on the port's): the loss terms to 1e-4 relative (the
  advantages' population std: Bessel's correction would move the policy
  loss by 7% at 8 rows); each parameter's step (new - old) of the backbone,
  actors and critic to 1e-7 where JAX's gradient is well above Adam's eps
  (98% of the elements), and the rest, whose gradient is zero but for
  rounding, within the step's bound lr = 3e-5;
- ``python -m linnaeus_tpu_torch.rl.train_abstention --device cpu`` end to
  end from a checkpoint of the port's CLI on a tiny hybrid dataset: every
  key of the JAX receipt, and the saved policy loads back.
"""

import copy
import functools
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as pl

import linnaeus_tpu.ops.flash_attention as jfa
import linnaeus_tpu.ops.fused_mlp as jfm
import linnaeus_tpu.rl as jrl
import linnaeus_tpu_torch.rl as trl
from linnaeus_tpu.models import MFormerV1 as JMFormerV1
from linnaeus_tpu.rl import ppo as jppo
from linnaeus_tpu.rl import provider as jprovider
from linnaeus_tpu.rl import train_abstention as jtrain
from linnaeus_tpu_torch.models.build import build_model
from linnaeus_tpu_torch.rl import ppo as tppo
from linnaeus_tpu_torch.rl import provider as tprovider
from linnaeus_tpu_torch.rl import train_abstention as ttrain
from linnaeus_tpu_torch.utils.convert import policy_state_dict_from_jax
from tests.test_torch_train_run_receipt import tiny_phase1

TASKS = ("taxa_L10", "taxa_L20")
NC = {"taxa_L10": 7, "taxa_L20": 3}
META = (("TEMPORAL", 2), ("SPATIAL", 3))
IMG, B = 32, 8
SPEC = {
    "CONVNEXT": {"DEPTHS": [1, 1, 1, 1], "DIMS": [8, 16, 32, 64]},
    "ROPE": {"DEPTHS": [1, 1], "DIMS": [32, 64], "NUM_HEADS": [2, 2]},
    "DROP_PATH_RATE": 0.0,
}
LOGIT_ATOL = 4e-5  # the model bar (ROADMAP.md, "How a slice is held against JAX")
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-7  # a few float32 ulps of a parameter near 1
GRAD_RTOL = 2e-5  # of each gradient's largest magnitude (measured: up to 4.5e-6)
GRAD_ZERO_ATOL = 1e-6  # gradients zero but for rounding read ~1e-7 (the aggregation's bias)
PRIOR = 0.2


class Tree:
    """The taxonomy tree as the environment and provider read it."""

    task_keys = list(TASKS)
    num_classes = dict(NC)


def _batches(n_batches=3, rows=4, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        out.append({
            "images": rng.integers(0, 256, (rows, IMG, IMG, 3)).astype(np.uint8),
            "aux": rng.normal(size=(rows, 5)).astype(np.float32),
            "targets": {t: rng.integers(0, n, rows).astype(np.int32) for t, n in NC.items()},
        })
    return out


def _as_torch(batch):
    return {"images": torch.from_numpy(batch["images"]), "aux": torch.from_numpy(batch["aux"]),
            "targets": {t: torch.from_numpy(v) for t, v in batch["targets"].items()}}


class Loader(list):
    """A loader of fixed batches (iterating it again starts over)."""


# ---------------------------------------------------------------- pure parts
def test_rewards_and_verifier_match_jax():
    rng = np.random.default_rng(0)
    kinds = [(jrl.SimpleAbstentionReward(), trl.SimpleAbstentionReward()),
             (jrl.EpisodeOutcomeReward(), trl.EpisodeOutcomeReward()),
             (jrl.SimpleAbstentionReward(2.0, 0.3, -2.0, -0.7, -1.5),
              trl.SimpleAbstentionReward(2.0, 0.3, -2.0, -0.7, -1.5))]
    for _ in range(200):
        gt = {t: (None if rng.random() < 0.3 else int(rng.integers(1, NC[t]))) for t in TASKS}
        pred = {t: (None if rng.random() < 0.3 else int(rng.integers(1, NC[t]))) for t in TASKS}
        if rng.random() < 0.3:
            pred = dict(gt)
        for jr, tr in kinds:
            assert jr.compute_reward(pred, gt) == tr.compute_reward(pred, gt)
            assert (jrl.TaxonomicRLVerifier(Tree(), jr).verify(pred, gt)
                    == trl.TaxonomicRLVerifier(Tree(), tr).verify(pred, gt))


def test_gae_matches_jax():
    rng = np.random.default_rng(1)
    for T in (1, 7, 128):
        r, v = rng.normal(size=T).astype(np.float32), rng.normal(size=T).astype(np.float32)
        d = rng.random(T) < 0.5
        for kw in ({}, {"gamma": 0.9, "gae_lambda": 0.8, "last_value": 0.5}):
            for a, b in zip(tppo.compute_gae_and_returns(r, v, d, **kw),
                            jppo.compute_gae_and_returns(r, v, d, **kw)):
                np.testing.assert_array_equal(a, b)
    assert tppo.PPOConfig() == jppo.PPOConfig()


def test_provider_matches_jax_over_batches_and_wraparound():
    batches = _batches()
    jp = jrl.LinnaeusRLProblemProvider(Loader(batches), Tree())
    tp = trl.LinnaeusRLProblemProvider(Loader([_as_torch(b) for b in batches]), Tree())
    for _ in range(3 * 4 + 5):  # every sample, then around again
        (jobs, jgt), (tobs, tgt) = jp.reset(), tp.reset()
        assert jgt == tgt
        assert isinstance(tobs["image"], torch.Tensor) and tobs["image"].dtype == torch.float32
        np.testing.assert_allclose(tobs["image"].numpy(), jobs["image"], rtol=0, atol=1e-7)
        np.testing.assert_array_equal(tobs["aux"].numpy(), jobs["aux"])
    np.testing.assert_array_equal(
        tprovider.normalize_host_images(batches[0]["images"]),
        jprovider.normalize_host_images(batches[0]["images"]))


def _env_module(package: str, with_gym: bool):
    """``<package>.rl.env`` as imported with gymnasium present or hidden."""
    if with_gym:
        return importlib.import_module(f"{package}.rl.env")
    name = f"{package}.rl._env_without_gym"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(importlib.import_module(f"{package}.rl").__file__),
                           "env.py"))
    module = importlib.util.module_from_spec(spec)
    saved = sys.modules.get("gymnasium")
    sys.modules["gymnasium"] = None  # import gymnasium raises ImportError
    try:
        spec.loader.exec_module(module)
    finally:
        if saved is None:
            del sys.modules["gymnasium"]
        else:
            sys.modules["gymnasium"] = saved
    return module


@pytest.mark.parametrize("with_gym", [True, False])
@pytest.mark.parametrize("mode", ["multitask", "sequential"])
def test_env_matches_jax_with_and_without_gymnasium(with_gym, mode):
    jenv_mod, tenv_mod = _env_module("linnaeus_tpu", with_gym), _env_module(
        "linnaeus_tpu_torch", with_gym)
    assert jenv_mod._GYM == tenv_mod._GYM == with_gym
    batches = _batches(seed=2)
    jenv = jenv_mod.TaxonomicClassificationEnv(Loader(batches), Tree(), mode=mode,
                                               image_shape=(IMG, IMG, 3))
    tenv = tenv_mod.TaxonomicClassificationEnv(Loader([_as_torch(b) for b in batches]), Tree(),
                                               mode=mode, image_shape=(IMG, IMG, 3))
    assert (getattr(jenv, "abstain_action_index", None)
            == getattr(tenv, "abstain_action_index", None))
    if with_gym:
        assert jenv.action_space == tenv.action_space
        assert jenv.observation_space == tenv.observation_space
    rng = np.random.default_rng(3)
    for _ in range(6):
        (jo, ji), (to, ti) = jenv.reset(), tenv.reset()
        assert ji["ground_truth"] == ti["ground_truth"]
        np.testing.assert_allclose(to["image"].numpy(), jo["image"], atol=1e-7, rtol=0)
        done = False
        while not done:
            if mode == "multitask":
                action = [int(rng.integers(0, NC[t] + 1)) for t in TASKS]
            else:
                action = int(rng.integers(0, max(NC.values()) + 1))
            jout, tout = jenv.step(action), tenv.step(action)
            done = jout[2]
            assert jout[1:4] == tout[1:4]
            assert {k: v for k, v in jout[4].items()} == tout[4]
            assert jout[0].get("current_rank_index") == tout[0].get("current_rank_index")
    with pytest.raises(RuntimeError, match="reset"):
        tenv_mod.TaxonomicClassificationEnv(Loader([]), Tree()).step(0)


def test_collect_rollout_matches_jax():
    batches = _batches(seed=4)
    jenv = jrl.TaxonomicClassificationEnv(Loader(batches), Tree(), mode="multitask",
                                          image_shape=(IMG, IMG, 3))
    tenv = trl.TaxonomicClassificationEnv(Loader([_as_torch(b) for b in batches]), Tree(),
                                          mode="multitask", image_shape=(IMG, IMG, 3))
    rng = np.random.default_rng(5)
    draws = [({t: int(rng.integers(0, NC[t] + 1)) for t in TASKS}, float(rng.normal()),
              float(rng.normal())) for _ in range(10)]
    it_j, it_t = iter(draws), iter(draws)
    j = jppo.collect_rollout(jenv, lambda obs, info: next(it_j), 10)
    t = tppo.collect_rollout(tenv, lambda obs, info: next(it_t), 10)
    assert isinstance(t["images"], torch.Tensor) and isinstance(t["aux"], torch.Tensor)
    np.testing.assert_allclose(t["images"].numpy(), j["images"], atol=1e-7, rtol=0)
    np.testing.assert_array_equal(t["aux"].numpy(), j["aux"])
    for k in ("actions", "old_log_prob", "values", "rewards", "dones"):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


# ------------------------------------------------------------ the policy
def _jax_model(kernels: bool):
    return JMFormerV1(
        img_size=(IMG, IMG), convnext_depths=(1, 1, 1, 1), convnext_dims=(8, 16, 32, 64),
        rope_depths=(1, 1), rope_dims=(32, 64), rope_num_heads=(2, 2), drop_path_rate=0.0,
        meta_components=META, task_keys=TASKS, num_classes=NC,
        head_configs={t: {"TYPE": "Linear"} for t in TASKS},
        use_flash_attn=kernels, fused_convnext_mlp=kernels, dtype=jnp.float32,
    )


def _policies(kernels: bool):
    """(JAX policy, its init variables, the variables perturbed off the
    init, the port's policy holding the perturbed weights)."""
    jpol = jrl.LinnaeusPolicyWrapper(backbone=_jax_model(kernels), task_keys=TASKS,
                                     num_classes=NC, abstain_prior=PRIOR)
    init = jax.jit(jpol.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)),
                              jnp.zeros((1, 5)))
    rng = np.random.default_rng(6)
    variables = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), init)
    model = build_model(SPEC, IMG, NC, META, dtype=torch.float32, use_flash_attn=kernels,
                        fused_convnext_mlp=kernels, device="cpu")
    tpol = trl.LinnaeusPolicyWrapper(model, TASKS, NC, abstain_prior=PRIOR)
    missing, unexpected = tpol.load_state_dict(policy_state_dict_from_jax(variables, tpol),
                                               strict=False)
    assert not unexpected and missing and all(k.startswith("backbone.head.") for k in missing)
    return jpol, init, variables, tpol.eval()


@pytest.fixture(scope="module")
def plain_policies():
    jpol, init, variables, tpol = _policies(kernels=False)
    return jpol, variables, tpol, init


def _inputs(rows=B, seed=7):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (rows, IMG, IMG, 3)).astype(np.float32) / 255.0
    return images, rng.normal(size=(rows, 5)).astype(np.float32)


def test_policy_init_matches_jax(plain_policies):
    params = plain_policies[3]["params"]
    model = build_model(SPEC, IMG, NC, META, dtype=torch.float32, device="cpu")
    tpol = trl.LinnaeusPolicyWrapper(model, TASKS, NC, abstain_prior=PRIOR)
    for t in TASKS:
        actor, jactor = tpol.actor(t), params[f"actor_{t}"]
        assert actor.weight.shape == jactor["kernel"].shape[::-1]
        np.testing.assert_allclose(actor.bias.detach().numpy(), np.asarray(jactor["bias"]),
                                   rtol=1e-6, atol=0)
        # trunc-normal at std 0.02, cut at two deviations, as the JAX init
        assert float(actor.weight.detach().abs().max()) <= 2 * 0.02 + 1e-7
    assert tpol.critic.weight.shape == (1, 64) and float(tpol.critic.bias) == 0.0
    bare = trl.LinnaeusPolicyWrapper(model, TASKS, NC)
    assert all(float(bare.actor(t).bias.abs().max()) == 0.0 for t in TASKS)


def test_policy_logits_value_and_evaluate_actions_match_jax(plain_policies):
    jpol, variables, tpol, _ = plain_policies
    images, aux = _inputs()
    jlogits, jvalue = jax.jit(jpol.apply)(variables, jnp.asarray(images), jnp.asarray(aux))
    with torch.no_grad():
        logits, value = tpol(torch.from_numpy(images), torch.from_numpy(aux))
    for t in TASKS:
        assert logits[t].dtype == torch.float32 and logits[t].shape == (B, NC[t] + 1)
        np.testing.assert_allclose(logits[t].numpy(), np.asarray(jlogits[t]),
                                   atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), atol=LOGIT_ATOL, rtol=0)
    rng = np.random.default_rng(8)
    actions = {t: rng.integers(0, NC[t] + 1, B) for t in TASKS}
    jout = jax.jit(functools.partial(jpol.apply, method=jpol.evaluate_actions))(
        variables, jnp.asarray(images), jnp.asarray(aux),
        {t: jnp.asarray(a) for t, a in actions.items()})
    with torch.no_grad():
        tout = tpol.evaluate_actions(torch.from_numpy(images), torch.from_numpy(aux),
                                     {t: torch.from_numpy(a) for t, a in actions.items()})
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=LOGIT_ATOL, rtol=0)


def test_sample_actions_follow_the_logits():
    logits = {"a": torch.tensor([[0.0, 50.0, 0.0]] * 4), "b": torch.zeros(4, 5)}
    g = torch.Generator().manual_seed(0)
    actions, log_prob = trl.sample_actions(logits, g)
    assert actions["a"].tolist() == [1] * 4
    np.testing.assert_allclose(log_prob.numpy(), np.full(4, np.log(1 / 5)), atol=1e-5)
    again, _ = trl.sample_actions(logits, torch.Generator().manual_seed(0))
    assert torch.equal(again["b"], actions["b"])


def test_warm_start_actor_heads_matches_jax(plain_policies):
    jpol, variables, tpol, _ = plain_policies
    rng = np.random.default_rng(9)
    heads = {f"head_{t}": {"Dense_0": {"kernel": rng.normal(size=(64, NC[t])).astype(np.float32),
                                       "bias": rng.normal(size=NC[t]).astype(np.float32)}}
             for t in TASKS}
    heads["head_taxa_L20"]["Dense_0"]["kernel"] = rng.normal(size=(64, 9)).astype(np.float32)
    heads["head_taxa_L20"]["Dense_0"]["bias"] = rng.normal(size=9).astype(np.float32)
    jparams = {"params": dict(variables["params"])}
    jwarm = jtrain.warm_start_actor_heads(jparams, {"head": heads}, TASKS)
    state = {f"head.{t}.fc.weight": torch.from_numpy(heads[f"head_{t}"]["Dense_0"]["kernel"].T)
             for t in TASKS}
    state.update({f"head.{t}.fc.bias": torch.from_numpy(heads[f"head_{t}"]["Dense_0"]["bias"])
                  for t in TASKS})
    before = {k: v.clone() for k, v in tpol.state_dict().items()}
    twarm = ttrain.warm_start_actor_heads(tpol, state, TASKS)
    assert twarm == jwarm == ["taxa_L10"]  # taxa_L20's head has another class count
    got = tpol.state_dict()
    want = policy_state_dict_from_jax(jparams, tpol)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    tpol.load_state_dict(before)


def test_load_backbone_leaves_out_heads_of_another_class_count():
    model = build_model(SPEC, IMG, NC, META, device="cpu", seed=0)
    phase1 = build_model(SPEC, IMG, {"taxa_L10": 9, "taxa_L20": 3}, META, device="cpu", seed=1)
    state = phase1.state_dict()
    skipped = ttrain.load_backbone(model, state)
    assert skipped == ["head.taxa_L10.fc.weight", "head.taxa_L10.fc.bias"]
    got = model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in state.items() if k not in skipped)
    assert got["head.taxa_L10.fc.weight"].shape == (NC["taxa_L10"], 64)  # its own, kept
    missing = {k: v for k, v in state.items() if not k.startswith("stages.0.")}
    with pytest.raises(ValueError, match="does not fit"):
        ttrain.load_backbone(model, missing)


def test_evaluate_abstention_matches_jax(plain_policies):
    jpol, variables, tpol, _ = plain_policies
    batches = _batches(n_batches=3, rows=4, seed=10)
    for b in batches:
        b["targets"]["taxa_L10"][:2] = 0  # null rows at the leaf
    jout = jtrain.evaluate_abstention(jpol, variables, Loader(batches), TASKS, NC, 8)
    tout = ttrain.evaluate_abstention(tpol, Loader([_as_torch(b) for b in batches]), TASKS,
                                      NC, 8)
    p_keys = ("mean_p_abstain_on_null", "mean_p_abstain_on_known")
    assert {k: v for k, v in tout.items() if k not in p_keys} == {
        k: v for k, v in jout.items() if k not in p_keys}
    for k in p_keys:  # means of float32 softmaxes, each rounded to 4 places
        assert abs(tout[k] - jout[k]) <= 1e-4


# --------------------------------------------------- one PPO update, kernels on
@pytest.fixture
def pallas_on_cpu(monkeypatch):
    interpret = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(jfm.pl, "pallas_call", interpret)
    monkeypatch.setattr(jfa.pl, "pallas_call", interpret)
    monkeypatch.setattr(jfm, "_FORCE_KERNEL_BWD", True)


def _ppo_batch(seed: int) -> dict:
    images, aux = _inputs(seed=seed)
    rng = np.random.default_rng(seed + 1)
    actions = np.stack([rng.integers(0, NC[t] + 1, B) for t in TASKS], 1)
    return {"images": images, "aux": aux, "actions": actions,
            "old_log_prob": rng.normal(-3.0, 0.5, B).astype(np.float32),
            "advantages": rng.normal(size=B).astype(np.float32),
            "returns": rng.normal(size=B).astype(np.float32)}


def _ppo_updates(jpol, tpol, cfg):
    """JAX's jitted update over optax.adam and the port's over its Adam."""
    def japply(p, im, a, act):
        return jpol.apply(p, im, a, {t: act[:, i] for i, t in enumerate(TASKS)},
                          method=jpol.evaluate_actions)

    def tapply(im, a, act):
        return tpol.evaluate_actions(im, a, {t: act[:, i] for i, t in enumerate(TASKS)})

    tx = optax.adam(cfg.lr)
    return (tx, jppo.make_ppo_update(japply, tx, cfg),
            tppo.make_ppo_update(tapply, tppo.make_adam(tpol.parameters(), cfg), cfg))


def test_one_ppo_update_matches_optax_adam(pallas_on_cpu):
    jpol, _, variables, tpol = _policies(kernels=True)
    cfg = jppo.PPOConfig()
    batch = _ppo_batch(11)

    tx, jupdate, update = _ppo_updates(jpol, tpol, cfg)
    jparams = jax.tree.map(jnp.asarray, variables)
    jnew, jstate, jmetrics = jupdate(
        jparams, tx.init(jparams), {k: jnp.asarray(v) for k, v in batch.items()})
    tmetrics = update({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(tmetrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)
    # The gradients, by value: optax.adam's first moment after one step is
    # (1 - b1) * g, and the port's step leaves each parameter's .grad.
    jgrads = jax.tree.map(lambda m: np.asarray(m) / 0.1, jstate[0].mu)
    want_grads = policy_state_dict_from_jax(jgrads, tpol)
    grads = {k: p.grad.numpy() for k, p in tpol.named_parameters() if p.grad is not None}
    assert set(grads) == set(want_grads)  # all but the backbone's unused task heads
    worst_grad = 0.0
    for k, g in grads.items():
        w = want_grads[k].numpy()
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_RTOL * scale + GRAD_ZERO_ATOL,
                                   err_msg=k)
        if scale > 1e-4:
            worst_grad = max(worst_grad, float(np.abs(g - w).max()) / scale)
    # Adam's first step is lr * g / (|g| + 1e-8), lr * sign(g) where |g| >>
    # 1e-8. Where the gradient is zero but for rounding (~1e-7: the key
    # projection's bias, since softmax ignores a shift of a row's scores; the
    # aggregation's bias, which the final LayerNorm removes) the step is
    # rounding amplified, and only its bound holds.
    old = policy_state_dict_from_jax(variables, tpol)
    got, want = tpol.state_dict(), policy_state_dict_from_jax(jax.device_get(jnew), tpol)
    conditioned = total = 0
    worst = 0.0
    for k, w in want.items():
        step_jax = (w - old[k]).numpy()
        step_port = (got[k] - old[k]).numpy()
        sure = np.abs(step_jax) > 0.999 * cfg.lr  # |g| > 1e-5 on the JAX side
        np.testing.assert_allclose(step_port[sure], step_jax[sure], atol=PARAM_ATOL, rtol=0,
                                   err_msg=k)
        # the step's bound, up to the rounding of the stored parameter
        assert (np.abs(step_port) <= cfg.lr + 2 * np.spacing(np.abs(old[k].numpy()))).all(), k
        worst = max(worst, float(np.abs(step_port[sure] - step_jax[sure]).max(initial=0.0)))
        conditioned += int(sure.sum())
        total += sure.size
    assert conditioned > 0.9 * total, (conditioned, total)
    print(f"PPO update: {conditioned} of {total} parameters conditioned; worst step gap "
          f"{worst:.3e}; worst gradient gap {worst_grad:.3e} of its tensor's largest")


def test_second_ppo_update_matches_optax_adam(plain_policies):
    """Adam's second step weighs the two batches' gradients against each
    other through both moments, with the bias correction of count 2."""
    jpol, variables, tpol, _ = plain_policies
    tpol = copy.deepcopy(tpol)
    cfg = jppo.PPOConfig()
    tx, jupdate, update = _ppo_updates(jpol, tpol, cfg)
    jparams = jax.tree.map(jnp.asarray, variables)
    jstate = tx.init(jparams)
    old = policy_state_dict_from_jax(variables, tpol)
    moments = []  # JAX's first moment after each step
    for seed in (21, 23):
        batch = _ppo_batch(seed)
        jparams, jstate, jmetrics = jupdate(
            jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        moments.append(policy_state_dict_from_jax(jax.device_get(jstate[0].mu), tpol))
        tmetrics = update({k: torch.from_numpy(v) for k, v in batch.items()})
        for k in jmetrics:
            np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]),
                                       rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    got, want = tpol.state_dict(), policy_state_dict_from_jax(jax.device_get(jparams), tpol)
    conditioned = total = 0
    worst = 0.0
    for k, w in want.items():
        step_jax, step_port = (w - old[k]).numpy(), (got[k] - old[k]).numpy()
        # both gradients well above their rounding (as in the one-step test)
        g1 = moments[0][k].numpy() / 0.1
        g2 = (moments[1][k].numpy() - 0.9 * moments[0][k].numpy()) / 0.1
        sure = np.minimum(np.abs(g1), np.abs(g2)) > 1e-5
        np.testing.assert_allclose(step_port[sure], step_jax[sure], atol=2 * PARAM_ATOL, rtol=0,
                                   err_msg=k)
        worst = max(worst, float(np.abs(step_port[sure] - step_jax[sure]).max(initial=0.0)))
        conditioned += int(sure.sum())
        total += sure.size
    assert conditioned > 0.9 * total, (conditioned, total)
    print(f"two PPO updates: {conditioned} of {total} parameters conditioned; worst step gap "
          f"{worst:.3e} (steps up to {2 * cfg.lr:.0e})")


# --------------------------------------------------- the CLI, end to end
def test_train_abstention_cli_on_a_port_checkpoint(tmp_path):
    run = tiny_phase1(str(tmp_path), null_frac=0.25)
    out = tmp_path / "rl.json"
    result = ttrain.main([
        "--cfg", run["cfg"], "--checkpoint", run["ckpt_dir"], "--iterations", "2",
        "--rollout-steps", "8", "--eval-samples", "8", "--abstain-prior", "0.2",
        "--receipt", str(out), "--device", "cpu",
        "--opts", "EXPERIMENT.NAME", "rl", "MODEL.DROP_PATH_RATE", "0.0",
    ])
    receipt = json.loads(out.read_text())
    want_keys = {"device", "backend", "mode", "iterations", "steps_per_rollout",
                 "abstain_prior", "warm_start", "reward_curve", "reward_first", "reward_last",
                 "ppo_metrics_last", "eval_before", "eval_after"}
    assert want_keys <= set(receipt) and receipt == result.receipt
    assert receipt["device"] == "cpu" and receipt["warm_start"].startswith(run["ckpt_dir"])
    assert [i for i, _ in receipt["reward_curve"]] == [0, 1]
    assert all(np.isfinite(v) for v in receipt["ppo_metrics_last"].values())
    # JAX's keys; the port's timings stay out of the receipt
    assert set(receipt["ppo_metrics_last"]) == {"mean_reward", "policy_loss", "value_loss",
                                               "entropy", "approx_kl", "total_loss"}
    assert [set(t) for t in result.timings] == [
        {"rollout_ms_per_action", "update_ms_per_epoch"}] * 2
    for key in ("eval_before", "eval_after"):
        ev = receipt[key]
        assert ev["samples"] >= 8 and set(ev["per_rank"]) == set(
            ["taxa_L10", "taxa_L20", "taxa_L30", "taxa_L40"])
    assert os.path.basename(result.policy_path) == "abstention_policy.pt"
    state = torch.load(result.policy_path, map_location="cpu", weights_only=True)
    fresh = copy.deepcopy(result.policy)
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    fresh.load_state_dict(state, strict=True)
    assert all(torch.equal(fresh.state_dict()[k], v)
               for k, v in result.policy.state_dict().items())
