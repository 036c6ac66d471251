"""The port's train step on two ranks against the TPU package's on its mesh.

The tiny mFormerV1 of tests/test_torch_train_step.py (float32, K1 and K2 on
their plain routes) starts from the same weights on both sides. The JAX
step runs under ``jit`` on the 8-device CPU mesh, the batch sharded over
'data'; the port's
step runs in two gloo processes (tests/test_torch_ranks.py::run_ranks),
each handed its four rows of the same global batch of eight, with JAX's
draws for the global batch handed in, as the one-process tests do. The
groups are (0, 4), (1, 5), ... so that every mixing partner sits on the
other rank. Bars, those of tests/test_torch_train_step.py: loss and per-task losses 1e-4, gradient norms
1e-3 relative, parameters 2e-5 after the AdamW steps (where the gradient is
no float noise, as there).

Cases: 'replicated' and 'fsdp' over two steps with mixing and
meta-masking; accumulation 2; mFormerV0 with its BatchNorm statistics
(reduced over the global batch: the running statistics to 1e-6); the
GradNorm update (replicated and FSDP) against JAX's on the same collated
batch; a Muon step under FSDP against the replicated one (the update
orthogonalised whole); ``reshard_train_state`` from replicated to FSDP. All
share one start of the two processes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.sharding import Mesh as JMesh

import linnaeus_tpu.data.collate as jc
import linnaeus_tpu.ops.flash_attention as jfa
import linnaeus_tpu.ops.fused_mlp as jfm
from linnaeus_tpu.parallel import mesh as jmesh
from linnaeus_tpu_torch.utils.convert import (
    adamw_moments_from_optax,
    state_dict_from_jax,
    state_dict_from_variables,
    v0_state_dict_from_jax,
)
from tests import test_torch_train_step as ts
from tests.test_torch_ranks import run_ranks

STEPS = 2
GROUPS = np.arange(ts.B, dtype=np.int32) % (ts.B // 2)  # partners 4 rows apart


@pytest.fixture(autouse=True, scope="module")
def pallas_on_cpu():
    interpret = functools.partial(pl.pallas_call, interpret=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfm.pl, "pallas_call", interpret)
        mp.setattr(jfa.pl, "pallas_call", interpret)
        mp.setattr(jfm, "_FORCE_KERNEL_BWD", True)
        yield


def _batch():
    batch = ts._batch()
    batch["group_ids"] = GROUPS
    return batch


def _jax_mesh():
    return JMesh(np.asarray(jax.devices()).reshape(-1, 1), (jmesh.DATA_AXIS, jmesh.MODEL_AXIS))


def _jax_run(accum, steps):
    """The JAX step on the 8-device mesh: metrics by step and the state."""
    j_step, j_state, _, _ = ts._setup(accum=accum)
    mesh = _jax_mesh()
    j_batch = jmesh.shard_batch(ts._tree(_batch(), jnp.asarray), mesh)
    j_scalars, _ = ts._scalars("mixed_masked")
    metrics = []
    for _ in range(steps):
        j_state, m = j_step(j_state, j_batch, j_scalars)
        metrics.append(jax.tree.map(np.asarray, m))
    return metrics, j_state


def _draws(steps, accum):
    mix_cfg = jc.MixConfig(chunk_bounds=ts.BOUNDS)
    if accum == 1:
        return [ts.step_draws(s, mix_cfg) for s in range(steps)]
    return [[ts.step_draws(s, mix_cfg, micro=i, rows=ts.B // accum) for i in range(accum)]
            for s in range(steps)]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """What the ranks read: the weights, the batch, JAX's draws, the
    mFormerV0's variables and the collated GradNorm batch."""
    d = tmp_path_factory.mktemp("dp")
    _, j_state, _, _ = ts._setup()
    params = jax.tree.map(np.asarray, j_state.params)
    jm0, variables, *_ = ts._v0_setup()
    payload = {
        "v1": state_dict_from_jax(params, *ts.BRIDGE),
        "batch": ts._tree(_batch(), torch.tensor),
        "draws": _draws(STEPS, 1), "draws_accum": _draws(1, 2),
        "v0": variables,
        "scalars": ts._scalars("mixed_masked")[1],
    }
    torch.save(payload, d / "inputs.pt")
    return d, params, variables


# --------------------------------------------------------------- the ranks
def _port_state(payload, mesh, mode, accum=1, v0=False, moe=None, remat=False, optimizer=None,
                **shard_kw):
    from linnaeus_tpu_torch.data import collate as tc
    from linnaeus_tpu_torch.loss import soft_target_cross_entropy as t_stce
    from linnaeus_tpu_torch.models.build import build_model
    from linnaeus_tpu_torch.models.mformer_v0 import MFormerV0
    from linnaeus_tpu_torch.optim.build import build_optimizer
    from linnaeus_tpu_torch.optim.schedules import build_schedule
    from linnaeus_tpu_torch.parallel.model import apply_fsdp, shard_model
    from linnaeus_tpu_torch.train.state import create_train_state
    from linnaeus_tpu_torch.train.step import make_train_step
    from linnaeus_tpu_torch.utils.convert import load_jax_variables

    _, cfg = ts._configs()
    if optimizer is not None:
        from linnaeus_tpu_torch.configuration import get_default_config

        cfg.OPTIMIZER.NAME = optimizer
        cfg.OPTIMIZER.MUON = get_default_config().OPTIMIZER.MUON
    if v0:
        model = MFormerV0(**ts.V0_KW)
        load_jax_variables(model, payload["v0"])
        mix = tc.MixConfig(mixup_enabled=False, cutmix_enabled=False)
    else:
        spec = ts.SPEC if moe is None else dict(ts.SPEC, MOE=moe)
        model = build_model(spec, ts.IMG, ts.NC, ts.META, use_flash_attn=True,
                            fused_convnext_mlp=True, device="cpu")
        model.load_state_dict(payload["v1" if moe is None else "moe"], strict=True)
        mix = tc.MixConfig(chunk_bounds=ts.BOUNDS)
    model.gradient_checkpointing = remat
    split = shard_model(model, mesh, mode, **shard_kw)
    if mode == "fsdp":
        apply_fsdp(model, mesh)
    schedule = build_schedule(cfg, 100)
    state = create_train_state(model, build_optimizer(cfg, schedule, model), num_tasks=2,
                               generator=torch.Generator().manual_seed(0), lr_schedule=schedule)
    aux = {} if moe is None else {"moe_aux_weight": 0.01, "moe_z_weight": 0.001}
    step = make_train_step({t: t_stce for t in ts.TASKS}, ts.TASKS, mix, clip_grad=5.0,
                           accumulation_steps=accum, lr_schedule=schedule, mesh=mesh,
                           model_split=split, **aux)
    return state, step


def _full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().clone()


def _run(payload, mesh, mode, accum=1, v0=False, steps=STEPS, **kw):
    """``steps`` train steps of this rank on its rows: the metrics, the
    whole state_dict and Adam's first moments."""
    from linnaeus_tpu_torch.parallel.mesh import shard_batch
    from linnaeus_tpu_torch.train.step import ScheduleScalars

    state, step = _port_state(payload, mesh, mode, accum, v0, **kw)
    batch = shard_batch(payload["batch"], mesh)
    scalars = ScheduleScalars.zeros(5) if v0 else payload["scalars"]
    draws = payload["draws_accum"] if accum > 1 else payload["draws"]
    metrics = []
    for s in range(steps):
        state, m = step(state, batch, scalars, draws=None if v0 else draws[s])
        metrics.append({k: (v.detach().clone() if isinstance(v, torch.Tensor) else v)
                        for k, v in m.items()})
    from linnaeus_tpu_torch.parallel.model import whole, whole_state_dict

    model = whole_state_dict(state.model)
    mu = {}
    for n, p in state.model.named_parameters():
        if "exp_avg" in state.optimizer.state[p]:
            m = state.optimizer.state[p]["exp_avg"]
            mu[n] = whole(m, p.share) if getattr(p, "share", None) is not None else _full(m)
    held = sum(p.to_local().numel() if hasattr(p, "to_local") else p.numel()
               for p in state.model.parameters())
    return {"metrics": metrics, "model": model, "mu": mu, "held": held}


def _gradnorm(payload, mesh, mode):
    """JAX's GradNorm update on the raw batch of every rank (collated =
    the batch: no augmentation, no mixing)."""
    from linnaeus_tpu_torch.loss import gradnorm as tgn
    from linnaeus_tpu_torch.loss import soft_target_cross_entropy as t_stce
    from linnaeus_tpu_torch.parallel.mesh import shard_batch
    from linnaeus_tpu_torch.parallel.model import apply_fsdp, shard_model
    from linnaeus_tpu_torch.models.build import build_model
    from linnaeus_tpu_torch.loss.gradnorm import init_gradnorm_state

    model = build_model(ts.SPEC, ts.IMG, ts.NC, ts.META, use_flash_attn=True,
                        fused_convnext_mlp=True, device="cpu")
    model.load_state_dict(payload["v1"], strict=True)
    trunk = [n for n, _ in model.named_parameters() if not n.startswith(("head", "meta_"))]
    split = shard_model(model, mesh, mode)
    if mode == "fsdp":
        apply_fsdp(model, mesh)
    update = tgn.make_gradnorm_update_fn({t: t_stce for t in ts.TASKS}, ts.TASKS, trunk,
                                         alpha=1.5, mesh=mesh, model_split=split)
    b = shard_batch(payload["batch"], mesh)
    state, m = update(model.train(), b["images"], b["targets"], b["aux"], init_gradnorm_state(2))
    return {"weights": state.task_weights.clone(), "norms": m["gradnorm/norms"].clone(),
            "losses": m["gradnorm/losses"].clone()}


def _reshard(payload, mesh):
    """A replicated state after one step, re-placed under FSDP2 with a new
    optimizer (``reshard_train_state``): the same parameters, sharded, the
    EMA sharded as they are, the optimizer's state re-initialised."""
    from linnaeus_tpu_torch.optim.build import build_optimizer
    from linnaeus_tpu_torch.optim.schedules import build_schedule
    from linnaeus_tpu_torch.parallel.mesh import reshard_train_state, shard_batch
    from linnaeus_tpu_torch.parallel.model import whole_state_dict

    state, step = _port_state(payload, mesh, "replicated")
    state.ema_params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    state, _ = step(state, shard_batch(payload["batch"], mesh), payload["scalars"],
                    draws=payload["draws"][0])
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    _, cfg = ts._configs()
    state = reshard_train_state(
        state, mesh, lambda m: build_optimizer(cfg, build_schedule(cfg, 100), m), "fsdp")
    after = whole_state_dict(state.model)
    return {"same": all(torch.equal(before[k], after[k]) for k in before),
            "sharded": all(hasattr(p, "device_mesh") for p in state.model.parameters()),
            "ema_sharded": all(hasattr(v, "device_mesh") for v in state.ema_params.values()),
            "fresh_optimizer": len(state.optimizer.state) == 0, "step": state.step}


def _regen(payload, mesh):
    """One replicated step on this rank's rows, the generator drawing (the
    partners sit on the other rank); the batch collated again
    (``train_step.collated``) against what the forward consumed."""
    from linnaeus_tpu_torch.parallel.mesh import shard_batch

    state, step = _port_state(payload, mesh, "replicated")
    seen = []
    hook = state.model.register_forward_pre_hook(
        lambda mod, args: seen.append((args[0].detach().clone(), args[1].clone())))
    batch = shard_batch(payload["batch"], mesh)
    _, m = step(state, batch, payload["scalars"])
    hook.remove()
    images, _, meta = step.collated(state, batch, payload["scalars"])
    return {"same": torch.equal(images, seen[0][0]) and torch.equal(meta, seen[0][1]),
            "rows": images.shape[0], "mixed_frac": float(m["mixed_frac"])}


def dp_body(rank, world, out):
    from linnaeus_tpu_torch.parallel.mesh import create_mesh

    payload = torch.load(f"{out}/../inputs.pt", weights_only=False)
    mesh = create_mesh(device_type="cpu")
    from linnaeus_tpu_torch.optim import muon

    muon.NS_DTYPE = torch.float32  # as tests/test_torch_moe_step.py compares Muon
    return {
        "muon_replicated": _run(payload, mesh, "replicated", steps=1, optimizer="muon"),
        "muon_fsdp": _run(payload, mesh, "fsdp", steps=1, optimizer="muon"),
        "reshard": _reshard(payload, mesh),
        "replicated": _run(payload, mesh, "replicated"),
        "fsdp": _run(payload, mesh, "fsdp"),
        "accum": _run(payload, mesh, "replicated", accum=2, steps=1),
        "v0": _run(payload, mesh, "replicated", v0=True, steps=1),
        "gradnorm": {mode: _gradnorm(payload, mesh, mode) for mode in ("replicated", "fsdp")},
        "regen": _regen(payload, mesh),
    }


# --------------------------------------------------------------- the tests
@pytest.fixture(scope="module")
def ranks(inputs):
    d, _, _ = inputs
    return run_ranks(__file__, "dp_body", 2, d, timeout=240)


def _compare(got, j_metrics, j_state, bridge=ts.BRIDGE, bridge_fn=state_dict_from_jax):
    for t_m, j_m in zip(got["metrics"], j_metrics):
        ts._compare_metrics(t_m, j_m, loss_atol=1e-4, norm_rtol=1e-3)
    mu, _, _ = adamw_moments_from_optax(jax.tree.map(np.asarray, j_state.opt_state), *bridge,
                                        bridge=bridge_fn)
    mu_scale = max(float(v.abs().max()) for v in mu.values())
    return mu, mu_scale


def _params(got, j_state, mu):
    want = state_dict_from_jax(jax.tree.map(np.asarray, j_state.params), *ts.BRIDGE)
    for name, value in want.items():
        real = mu[name].abs() >= 1e-7
        np.testing.assert_allclose(got["model"][name][real].numpy(), value[real].numpy(),
                                   rtol=0, atol=2e-5, err_msg=name)


@pytest.fixture(scope="module")
def jax_steps():
    return _jax_run(1, STEPS)


@pytest.mark.parametrize("mode", ["replicated", "fsdp"])
def test_two_ranks_match_the_jax_mesh(ranks, jax_steps, mode):
    """Both modes against JAX's step over the mesh (its FSDP placement
    changes where XLA reduces, not what: one reference serves both)."""
    j_metrics, j_state = jax_steps
    for r, res in enumerate(ranks):
        got = res[mode]
        mu, mu_scale = _compare(got, j_metrics, j_state)
        for name in mu:
            np.testing.assert_allclose(got["mu"][name].numpy(), mu[name].numpy(), rtol=0,
                                       atol=1e-4 * mu_scale, err_msg=f"exp_avg {name}")
        _params(got, j_state, mu)
        assert float(got["metrics"][-1]["mixed_frac"]) == 1.0  # partners on the other rank
    # both ranks hold the same state, bit for bit
    for key, value in ranks[0][mode]["model"].items():
        assert torch.equal(value, ranks[1][mode]["model"][key]), key


def test_accumulation_two_on_two_ranks(ranks):
    j_metrics, j_state = _jax_run(2, 1)
    for res in ranks:
        mu, _ = _compare(res["accum"], j_metrics, j_state)
        _params(res["accum"], j_state, mu)


def test_mformer_v0_batchnorm_over_the_global_batch(ranks):
    jm, variables, j_step, j_state, *_ = ts._v0_setup()
    j_scalars, _ = ts._scalars("plain")
    j_state, j_m = j_step(j_state, ts._tree(_batch(), jnp.asarray), j_scalars)
    want = state_dict_from_variables(_v0_model(), {
        "params": jax.tree.map(np.asarray, j_state.params),
        "batch_stats": jax.tree.map(np.asarray, j_state.batch_stats)})
    mu, _, _ = adamw_moments_from_optax(jax.tree.map(np.asarray, j_state.opt_state),
                                        *ts.V0_BRIDGE, bridge=v0_state_dict_from_jax)
    for res in ranks:
        got = res["v0"]
        ts._compare_metrics(got["metrics"][0], jax.tree.map(np.asarray, j_m), loss_atol=1e-4,
                            norm_rtol=1e-3)
        stats = [k for k in want if "running" in k]
        assert stats
        for key in stats:
            np.testing.assert_allclose(got["model"][key].numpy(), want[key].numpy(),
                                       rtol=ts.STATS_TOL, atol=ts.STATS_TOL, err_msg=key)
        for name in mu:
            real = mu[name].abs() >= 1e-7
            np.testing.assert_allclose(got["model"][name][real].numpy(),
                                       want[name][real].numpy(), rtol=0, atol=2e-5,
                                       err_msg=name)


def _v0_model():
    from linnaeus_tpu_torch.models.mformer_v0 import MFormerV0

    return MFormerV0(**ts.V0_KW)


def jax_gradnorm(params):
    """JAX's GradNorm update on the batch over the mesh: (state, metrics)."""
    jm = ts.JMFormerV1(
        img_size=(ts.IMG, ts.IMG), convnext_depths=ts.DEPTHS, convnext_dims=ts.DIMS,
        rope_depths=ts.ROPE_DEPTHS, rope_dims=(32, 64), rope_num_heads=(2, 2),
        drop_path_rate=0.0, meta_components=ts.META, task_keys=ts.TASKS, num_classes=ts.NC,
        head_configs={t: {"TYPE": "Linear"} for t in ts.TASKS},
        use_flash_attn=True, fused_convnext_mlp=True)

    def apply_fn(p, imgs, mta, deterministic=True, gradnorm_mode=True, batch_stats=None):
        return jm.apply({"params": p}, imgs, mta, deterministic=deterministic,
                        gradnorm_mode=gradnorm_mode)

    jtrunk = lambda p: {k: jax.tree.map(  # noqa: E731
        lambda a: jnp.asarray(0.0 if k == "head" or k.startswith("meta_") else 1.0), v)
        for k, v in p.items()}
    batch = _batch()
    mesh = _jax_mesh()
    j_batch = jmesh.shard_batch(ts._tree(batch, jnp.asarray), mesh)
    return jax.jit(ts.jgn_update(apply_fn, jtrunk))(
        jax.tree.map(jnp.asarray, params), j_batch["images"], j_batch["targets"],
        j_batch["aux"], ts.jgn_state())


def check_gradnorm(results, params):
    jstate, jm_ = jax_gradnorm(params)
    for mode, got in results:
        np.testing.assert_allclose(got["norms"].numpy(), np.asarray(jm_["gradnorm/norms"]),
                                   rtol=1e-4, err_msg=mode)
        np.testing.assert_allclose(got["losses"].numpy(), np.asarray(jm_["gradnorm/losses"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(got["weights"].numpy(), np.asarray(jstate.task_weights),
                                   rtol=1e-4)


def test_gradnorm_update_on_two_ranks_matches_jax(ranks, inputs):
    _, params, _ = inputs
    check_gradnorm([(mode, got) for res in ranks for mode, got in res["gradnorm"].items()],
                   params)


def test_gradnorm_batch_collated_again_on_two_ranks(ranks):
    """The GradNorm re-forward's batch, collated again on each rank from the
    step's saved generator states, partners fetched from the other rank
    again: bit for bit the rank's rows the step's forward consumed."""
    for res in ranks:
        assert res["regen"] == {"same": True, "rows": ts.B // 2, "mixed_frac": 1.0}


def test_muon_under_fsdp_orthogonalises_the_whole_update(ranks):
    """Muon's Newton-Schulz runs on each parameter's whole update (float32
    here, as tests/test_torch_moe_step.py holds it to JAX's): gathered from
    the shards under FSDP and sharded back, it equals the replicated step's."""
    for res in ranks:
        rep, fsdp = res["muon_replicated"]["model"], res["muon_fsdp"]["model"]
        for key, value in rep.items():
            np.testing.assert_allclose(fsdp[key].numpy(), value.numpy(), rtol=0, atol=2e-6,
                                       err_msg=key)
        ts._compare_metrics(res["muon_fsdp"]["metrics"][0], res["muon_replicated"]["metrics"][0],
                            loss_atol=1e-6, norm_rtol=1e-5)


def test_reshard_train_state_keeps_the_parameters(ranks):
    for res in ranks:
        assert res["reshard"] == {"same": True, "sharded": True, "ema_sharded": True,
                                  "fresh_optimizer": True, "step": 1}


def test_grad_norm_under_fsdp_on_one_rank_is_the_one_process_bits(tmp_path):
    """parallel/model.py::grad_norm, which the clip and GradNorm read: FSDP2
    on one rank (a unit a block, each leaf sharded along its plan's axis)
    gives torch's ``get_total_norm`` of the one-process gradients to the
    bit; on one process it is that ``get_total_norm``."""
    import copy

    import torch.distributed as dist

    from linnaeus_tpu_torch.models.build import build_model
    from linnaeus_tpu_torch.parallel.mesh import create_mesh
    from linnaeus_tpu_torch.parallel.model import apply_fsdp, grad_norm

    spec = {"CONVNEXT": {"DEPTHS": [1, 1, 1, 1], "DIMS": [8, 16, 32, 64]},
            "ROPE": {"DEPTHS": [1, 1], "DIMS": [32, 64], "NUM_HEADS": [2, 2]},
            "DROP_PATH_RATE": 0.0}
    model = build_model(spec, 32, {"taxa_L10": 11, "taxa_L20": 5},
                        (("TEMPORAL", 2), ("SPATIAL", 3)), device="cpu")
    sharded = copy.deepcopy(model)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.uniform(size=(4, 32, 32, 3)).astype(np.float32))
    aux = torch.tensor(rng.normal(size=(4, 5)).astype(np.float32))

    def backward(m):
        sum(v.square().mean() for v in m(x, aux).values()).backward()
        return [(p, p.grad) for p in m.parameters()]

    want = torch.nn.utils.get_total_norm([g for _, g in backward(model)], norm_type=2.0)
    assert torch.equal(grad_norm([(p, p.grad) for p in model.parameters()], None), want)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = create_mesh(device_type="cpu")
        apply_fsdp(sharded, mesh)
        pairs = backward(sharded)
        assert all(hasattr(g, "to_local") for _, g in pairs)
        assert torch.equal(grad_norm(pairs, mesh.group("data")), want)
    finally:
        dist.destroy_process_group()
