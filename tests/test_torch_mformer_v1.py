"""The port's mFormerV1 against the TPU package's on the same weights.

The tiny model of tests/test_parity_reference.py (DIMS [8, 16, 32, 64],
RoPE [32, 64], 2 heads, 64 px, metadata TEMPORAL(2) + SPATIAL(3)) is
initialised in JAX from PRNGKey(0), its params are perturbed with seeded
numpy noise so every branch contributes, bridged with
``state_dict_from_jax`` and loaded strict. fp32 logits agree to 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import linnaeus_tpu.ops.fused_mlp as jfm
from linnaeus_tpu.models import MFormerV1 as JMFormerV1
from linnaeus_tpu.utils.pretrained import export_reference_mformer_v1
from linnaeus_tpu_torch.models.build import build_model
from linnaeus_tpu_torch.models.mformer_v1 import MFormerV1
from linnaeus_tpu_torch.utils.convert import state_dict_from_jax

TASKS = ("taxa_L10", "taxa_L20")
NC = {"taxa_L10": 7, "taxa_L20": 3}
META = (("TEMPORAL", 2), ("SPATIAL", 3))
DEPTHS, ROPE_DEPTHS = (1, 1, 1, 1), (1, 1)
SPEC = {
    "CONVNEXT": {"DEPTHS": list(DEPTHS), "DIMS": [8, 16, 32, 64]},
    "ROPE": {"DEPTHS": list(ROPE_DEPTHS), "DIMS": [32, 64], "NUM_HEADS": [2, 2]},
    "DROP_PATH_RATE": 0.0,
}
ATOL = 1e-4


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(
        jfm.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _inputs():
    rng = np.random.default_rng(0)
    images = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    meta = rng.normal(size=(2, 5)).astype(np.float32)
    return images, meta


def _jax_model(**kw):
    return JMFormerV1(
        img_size=(64, 64), convnext_depths=DEPTHS, convnext_dims=(8, 16, 32, 64),
        rope_depths=ROPE_DEPTHS, rope_dims=(32, 64), rope_num_heads=(2, 2),
        drop_path_rate=0.0, meta_components=META, task_keys=TASKS,
        num_classes=NC, head_configs={t: {"TYPE": "Linear"} for t in TASKS}, **kw,
    )


def _perturbed_params(model, images, meta):
    params = model.init(
        jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(meta))["params"]
    rng = np.random.default_rng(1)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params
    )


def _port_logits(params, images, meta, **kw):
    model = build_model(SPEC, 64, NC, META, device="cpu", **kw)
    model.load_state_dict(
        state_dict_from_jax(params, DEPTHS, ROPE_DEPTHS, ("TEMPORAL", "SPATIAL"), TASKS),
        strict=True,
    )
    with torch.no_grad():
        out = model(torch.tensor(images), torch.tensor(meta))
    assert all(out[t].dtype == torch.float32 for t in TASKS)
    return {t: out[t].numpy() for t in TASKS}


@pytest.mark.parametrize("act_exact", [False, True])
def test_logits_match_jax(act_exact):
    images, meta = _inputs()
    jm = _jax_model(act_exact=act_exact)
    params = _perturbed_params(jm, images, meta)
    ref = jm.apply({"params": params}, jnp.asarray(images), jnp.asarray(meta))
    # every port route: plain modules, K1's and K2's plain versions
    for flash, fused in ((False, False), (True, None), (True, True)):
        out = _port_logits(params, images, meta, act_exact=act_exact,
                           use_flash_attn=flash, fused_convnext_mlp=fused)
        for t in TASKS:
            np.testing.assert_allclose(out[t], np.asarray(ref[t]), atol=ATOL,
                                       err_msg=f"{t} flash={flash} fused={fused}")


@pytest.mark.parametrize("fp32_softmax", [True, False])
def test_logits_match_jax_attn_fp32_softmax(fp32_softmax):
    """``attn_fp32_softmax`` goes from build_model down to the plain
    attention of both RoPE stages, as in the TPU package; in float32 both
    settings are the same math. The K1 route ignores it."""
    images, meta = _inputs()
    jm = _jax_model(attn_fp32_softmax=fp32_softmax)
    params = _perturbed_params(jm, images, meta)
    ref = jm.apply({"params": params}, jnp.asarray(images), jnp.asarray(meta))
    for flash in (False, True):
        out = _port_logits(params, images, meta, attn_fp32_softmax=fp32_softmax,
                           use_flash_attn=flash, fused_convnext_mlp=False)
        for t in TASKS:
            np.testing.assert_allclose(out[t], np.asarray(ref[t]), atol=ATOL)
    model = build_model(SPEC, 64, NC, META, device="cpu", attn_fp32_softmax=fp32_softmax)
    flags = [blk.attn.attn_fp32_softmax for stage in model.stages[2:] for blk in stage]
    assert flags == [fp32_softmax] * sum(ROPE_DEPTHS)


def test_bf16_logits_follow_the_score_dtype_as_in_jax():
    """bf16 compute over float32 parameters, plain attention: the port with
    bf16 scores is held to JAX with bf16 scores, and likewise with float32
    scores. Tolerance 0.05: random-init logits below 1 in magnitude after a
    dozen bf16 layers rounded at other places by the two frameworks."""
    images, meta = _inputs()
    for fp32_softmax in (False, True):
        jm = _jax_model(attn_fp32_softmax=fp32_softmax, dtype=jnp.bfloat16)
        params = _perturbed_params(_jax_model(), images, meta)
        ref = jm.apply({"params": params}, jnp.asarray(images), jnp.asarray(meta))
        out = _port_logits(params, images, meta, attn_fp32_softmax=fp32_softmax,
                           dtype=torch.bfloat16, fused_convnext_mlp=False)
        for t in TASKS:
            np.testing.assert_allclose(out[t], np.asarray(ref[t], np.float32), atol=0.05)


def test_logits_match_jax_fused_kernel_route():
    """JAX with its Pallas fused MLP (interpret mode) against the port's K2
    route, and absent metadata on both sides."""
    images, meta = _inputs()
    jm = _jax_model(fused_convnext_mlp=True)
    params = _perturbed_params(jm, images, meta)
    for m in (meta, None):
        ref = jm.apply({"params": params}, jnp.asarray(images),
                       None if m is None else jnp.asarray(m))
        model = build_model(SPEC, 64, NC, META, fused_convnext_mlp=True, device="cpu")
        model.load_state_dict(
            state_dict_from_jax(params, DEPTHS, ROPE_DEPTHS, ("TEMPORAL", "SPATIAL"), TASKS))
        with torch.no_grad():
            out = model(torch.tensor(images), None if m is None else torch.tensor(m))
        for t in TASKS:
            np.testing.assert_allclose(out[t].numpy(), np.asarray(ref[t]), atol=ATOL)


def test_state_dict_from_jax_equals_reference_export():
    images, meta = _inputs()
    jm = _jax_model()
    params = jm.init(
        jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(meta))["params"]
    ours = state_dict_from_jax(
        jax.tree.map(np.asarray, params), DEPTHS, ROPE_DEPTHS, ("TEMPORAL", "SPATIAL"), TASKS)
    theirs = export_reference_mformer_v1(
        params, DEPTHS, ROPE_DEPTHS, ("TEMPORAL", "SPATIAL"), TASKS)
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
    # and it is exactly the port's own layout
    port = build_model(SPEC, 64, NC, META, device="cpu")
    assert set(port.state_dict()) == set(ours)
    port.load_state_dict(ours, strict=True)


@pytest.mark.parametrize("kw", [
    {"moe_num_experts": 4}, {"ring_attention": True}, {"pipeline_stages": 2},
    {"gradient_checkpointing": True}, {"aggregation": "Concatenation"},
    {"drop_rate": 0.1}, {"attn_drop_rate": 0.1},
])
def test_unported_options_raise(kw):
    """MoE, ring attention, pipelining and other aggregations raise.
    Gradient checkpointing and dropout, once here, are ported: such a model
    builds, trains and gives gradients (test_remat_* and
    tests/test_torch_build.py hold what they compute)."""
    build = functools.partial(MFormerV1, img_size=(64, 64), convnext_dims=(8, 16, 32, 64),
                              rope_dims=(32, 64), **kw)
    if set(kw) & {"gradient_checkpointing", "drop_rate", "attn_drop_rate"}:
        model = build().train()
        model.forward_features(torch.zeros(1, 64, 64, 3)).sum().backward()
        assert model.training and all(p.grad is not None for p in model.stem.parameters())
        return
    with pytest.raises(NotImplementedError):
        build().train()


REMAT_POLICIES = ("full", "dots", "dots_no_batch")


def _remat_grads(params, images, meta, remat, policy="dots", **kw):
    """Logits and gradients of a training-mode forward (drop path 0.3 drawn
    from one seeded generator) with per-block checkpointing on or off."""
    model = build_model(SPEC, 64, NC, META, device="cpu", drop_path_rate=0.3, **kw)
    model.load_state_dict(
        state_dict_from_jax(params, DEPTHS, ROPE_DEPTHS, ("TEMPORAL", "SPATIAL"), TASKS),
        strict=True)
    model.gradient_checkpointing, model.remat_policy = remat, policy
    gen = torch.Generator().manual_seed(5)
    for m in model.modules():
        if hasattr(m, "rate"):
            m.generator = gen
    model.train()
    out = model(torch.tensor(images), torch.tensor(meta))
    sum((v * (i + 1)).square().mean() for i, v in enumerate(out.values())).backward()
    return ({t: v.detach() for t, v in out.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()}, gen.get_state())


@pytest.fixture(scope="module")
def remat_inputs():
    images, meta = _inputs()
    return _perturbed_params(_jax_model(), images, meta), images, meta


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernel_routes"])
@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_remat_outputs_and_gradients_are_bit_identical(policy, kernels, remat_inputs):
    """Every ConvNeXt and RoPE block checkpointed: the same logits and
    gradients, bit for bit, under each policy, on the plain modules and on
    K1's and K2's routes (their plain versions on the CPU); the recompute
    draws the same drop-path masks and leaves the generator where the
    forward left it."""
    params, images, meta = remat_inputs
    kw = {"use_flash_attn": True, "fused_convnext_mlp": True} if kernels else {}
    out0, grads0, gen0 = _remat_grads(params, images, meta, False, **kw)
    out1, grads1, gen1 = _remat_grads(params, images, meta, True, policy, **kw)
    for t in TASKS:
        assert torch.equal(out0[t], out1[t]), t
    for n in grads0:
        assert torch.equal(grads0[n], grads1[n]), n
    assert torch.equal(gen0, gen1)


def test_remat_recomputes_and_keeps_what_the_policy_names(monkeypatch, remat_inputs):
    """The blocks are recomputed in the backward (each forward op runs
    twice), and 'dots' keeps the products the recompute would redo."""
    import linnaeus_tpu_torch.models.utils as mu

    saved = []
    plain = mu._save_products

    def spy(ops, ctx, op, *a, **k):
        policy = plain(ops, ctx, op, *a, **k)
        saved.append((str(op), policy.name))
        return policy

    monkeypatch.setattr(mu, "_save_products", spy)
    params, images, meta = remat_inputs
    _remat_grads(params, images, meta, True, "dots")
    kept = {op for op, policy in saved if policy == "MUST_SAVE"}
    assert {"aten.addmm.default", "aten.bmm.default"} <= kept
    assert not any("convolution" in op for op in kept)
    saved.clear()
    _remat_grads(params, images, meta, True, "dots_no_batch")
    assert {op for op, policy in saved if policy == "MUST_SAVE"} == {"aten.addmm.default"}


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat policy"):
        MFormerV1(img_size=(64, 64), convnext_dims=(8, 16, 32, 64), rope_dims=(32, 64),
                  gradient_checkpointing=True, remat_policy="offload")
    model = MFormerV1(img_size=(64, 64), convnext_dims=(8, 16, 32, 64), rope_dims=(32, 64),
                      remat_policy="offload").train()
    model.gradient_checkpointing = True
    with pytest.raises(ValueError, match="remat policy"):
        model(torch.zeros(1, 64, 64, 3))


def test_gradnorm_mode_returns_the_base_logits_as_in_jax():
    from linnaeus_tpu.utils.taxonomy import TaxonomyTree as JTree
    from linnaeus_tpu_torch.utils.taxonomy import TaxonomyTree

    hierarchy = {"taxa_L10": {1: 1, 2: 1, 3: 2, 4: 2, 5: 2, 6: 1}}
    heads = {"taxa_L10": {"TYPE": "HierarchicalSoftmax"}, "taxa_L20": {"TYPE": "Linear"}}
    images, meta = _inputs()
    jm = _jax_model()
    jm = jm.clone(head_configs=heads, hierarchy_matrices=JTree(
        hierarchy, list(TASKS), dict(NC)).build_hierarchy_matrices())
    params = _perturbed_params(jm, images, meta)
    model = build_model(SPEC, 64, NC, META, device="cpu", head_configs=heads,
                        taxonomy_tree=TaxonomyTree(hierarchy, list(TASKS), dict(NC)))
    model.load_state_dict(
        state_dict_from_jax(params, DEPTHS, ROPE_DEPTHS, ("TEMPORAL", "SPATIAL"), TASKS),
        strict=True)
    for mode in (False, True):
        ref = jm.apply({"params": params}, jnp.asarray(images), jnp.asarray(meta),
                       gradnorm_mode=mode)
        with torch.no_grad():
            out = model(torch.tensor(images), torch.tensor(meta), gradnorm_mode=mode)
        for t in TASKS:
            np.testing.assert_allclose(out[t].numpy(), np.asarray(ref[t]), atol=ATOL)
    assert not torch.allclose(out["taxa_L10"], model(torch.tensor(images), torch.tensor(meta))[
        "taxa_L10"].detach())


def test_conv1d_head_and_only_last_cls_match_jax():
    images, meta = _inputs()
    heads = {"taxa_L10": {"TYPE": "Conv1d", "KERNEL_SIZE": 3}, "taxa_L20": {"TYPE": "Linear"}}
    jm = JMFormerV1(
        img_size=(64, 64), convnext_depths=DEPTHS, convnext_dims=(8, 16, 32, 64),
        rope_depths=ROPE_DEPTHS, rope_dims=(32, 64), rope_num_heads=(2, 2),
        drop_path_rate=0.0, meta_components=META, task_keys=TASKS, num_classes=NC,
        head_configs=heads, only_last_cls=True,
    )
    params = _perturbed_params(jm, images, meta)
    ref = jm.apply({"params": params}, jnp.asarray(images), jnp.asarray(meta))
    model = MFormerV1(
        img_size=(64, 64), convnext_depths=DEPTHS, convnext_dims=(8, 16, 32, 64),
        rope_depths=ROPE_DEPTHS, rope_dims=(32, 64), rope_num_heads=(2, 2),
        meta_components=META, task_keys=TASKS, num_classes=NC, head_configs=heads,
        only_last_cls=True,
    ).eval()
    model.load_state_dict(
        state_dict_from_jax(params, DEPTHS, ROPE_DEPTHS, ("TEMPORAL", "SPATIAL"), TASKS),
        strict=True,
    )
    with torch.no_grad():
        out = model(torch.tensor(images), torch.tensor(meta))
    for t in TASKS:
        np.testing.assert_allclose(out[t].numpy(), np.asarray(ref[t]), atol=ATOL)


def test_default_device_is_the_card_and_raises_without_one():
    """The entry points run on the GPU unless the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the default then succeeds")
    for device in (None, "auto"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(SPEC, 64, NC, META, device=device)
    model = build_model(SPEC, 64, NC, META, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
