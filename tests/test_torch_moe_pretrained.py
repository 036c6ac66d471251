"""Sparse upcycling, the export back to the reference layout and serving of
an MoE mFormerV1, against the TPU package.

The same trees (a tiny MoE mFormerV1 and its dense twin, JAX inits bridged
with ``state_dict_from_jax``) and the same seeded checkpoint files
(tests/test_torch_pretrained.py's) go through the JAX functions and the
port's:

* ``densify_moe_params``, ``upcycle_dense_to_moe`` bit for bit,
  ``average_experts_into_dense`` to rtol 1e-6 (two summation orders);
* ``load_pretrained`` of stitched files into the MoE model bit for bit, the
  loaders' reports equal, every expert of every bank the dense MLP, the
  routers untouched;
* ``export_reference_mformer_v1`` and ``tools/export_torch.py`` on a port
  checkpoint directory: the keys of JAX's export, bit for bit for a dense
  model, rtol 1e-6 for averaged banks; the export loads ``strict=True`` into
  the dense port model;
* serving: the handler serves a JAX MoE bundle's ``weights.msgpack`` with
  JAX's results (logits within 4e-5), and an MoE training checkpoint
  directory bit for bit against the model it holds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import linnaeus_tpu.utils.pretrained as jpre
from linnaeus_tpu.models import MFormerV1 as JMFormerV1
from linnaeus_tpu_torch.inference.handler import LinnaeusInferenceHandler
from linnaeus_tpu_torch.models.mformer_v1 import MFormerV1
from linnaeus_tpu_torch.tools import export_torch
from linnaeus_tpu_torch.utils import pretrained as tpre
from linnaeus_tpu_torch.utils.checkpoint import STATE_DIR, STATE_FILE
from linnaeus_tpu_torch.utils.convert import jax_layouts, state_dict_from_jax
from tests.test_torch_handler import (  # noqa: F401  (bundle, tiny_preset: fixtures)
    TASKS as BUNDLE_TASKS,
    _copy_bundle,
    _load_pair,
    _requests,
    bundle,
    tiny_preset,
)
from tests.test_torch_pretrained import (
    DEPTHS,
    META,
    ROPE_DEPTHS,
    TASKS,
    arch,
    as_flax,
    assert_same_weights,
    configs,
    convnext_sd,
    jax_load,
    jax_mismatch_keys,
    ropevit_sd,
    to_port,
)
from tests.test_trainer_e2e import data_dir  # noqa: F401  (a fixture)

MOE = dict(moe_num_experts=2, moe_every_n=1, moe_capacity_factor=2.0)
META_NAMES = tuple(n for n, _ in META)


def jax_init(**kw):
    jmodel = JMFormerV1(**arch(head_configs={t: {"TYPE": "Linear"} for t in TASKS}, **kw))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                  jnp.zeros((1, 5)))["params"]
    rng = np.random.default_rng(1)
    return jmodel, jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params)


@pytest.fixture(scope="module")
def trees():
    """(JAX MoE model, its params, JAX dense twin's params)."""
    jmodel, moe = jax_init(**MOE)
    _, dense = jax_init()
    return jmodel, moe, dense


def test_densify_average_and_upcycle_match_jax(trees):
    _, moe, dense = trees
    moe_sd, dense_sd = to_port(moe), to_port(dense)
    assert tpre._is_moe_params(moe_sd) and not tpre._is_moe_params(dense_sd)
    assert jpre._is_moe_params(moe) and not jpre._is_moe_params(dense)

    got = tpre.densify_moe_params(moe_sd)
    want = to_port(jax.tree.map(np.asarray, jpre.densify_moe_params(moe)))
    assert_same_weights_dict(got, want)
    assert not any(k.endswith(".router") for k in got)
    assert float(got["stages.2.0.mlp.fc1.weight"].abs().sum()) == 0.0

    got = tpre.average_experts_into_dense(moe_sd)
    want = to_port(jax.tree.map(np.asarray, jpre.average_experts_into_dense(moe)))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, atol=0, err_msg=k)

    got = tpre.upcycle_dense_to_moe(dense_sd, moe_sd)
    want = to_port(jax.tree.map(np.asarray, jpre.upcycle_dense_to_moe(dense, moe)))
    assert_same_weights_dict(got, want)
    for e in range(2):
        assert torch.equal(got["stages.2.0.mlp.wi"][e], dense_sd["stages.2.0.mlp.fc1.weight"].t())
    assert torch.equal(got["stages.2.0.mlp.router"], moe_sd["stages.2.0.mlp.router"])
    bad = dict(dense_sd)
    del bad["stages.2.0.mlp.fc1.weight"]
    with pytest.raises(KeyError, match="dense source missing"):
        tpre.upcycle_dense_to_moe(bad, moe_sd)


def assert_same_weights_dict(got, want):
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_upcycled_forward_equals_the_dense_twin(trees):
    """Identical experts, normalised gates, ample capacity: the upcycled
    model's logits are the dense model's (JAX's own invariant)."""
    _, moe, dense = trees
    dense_model = MFormerV1(**arch())
    dense_model.load_state_dict(to_port(dense), strict=True)
    moe_model = MFormerV1(**arch(**MOE))
    moe_model.load_state_dict(tpre.upcycle_dense_to_moe(to_port(dense), to_port(moe)),
                              strict=True)
    x = torch.tensor(np.random.default_rng(3).normal(size=(2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        a, b = moe_model.eval()(x), dense_model.eval()(x)
    for t in TASKS:
        np.testing.assert_allclose(a[t].numpy(), b[t].numpy(), rtol=0, atol=1e-5)


def test_stitched_files_into_an_moe_model_match_jax(trees, tmp_path, monkeypatch):
    jmodel, moe, _ = trees
    cn, rv = tmp_path / "convnext.pth", tmp_path / "ropevit.pth"
    torch.save({"model": convnext_sd(1)}, cn)
    torch.save(ropevit_sd(2, "{src}.attn.freqs"), rv)
    jcfg, tcfg = configs(PRETRAINED_CONVNEXT=str(cn), PRETRAINED_ROPEVIT=str(rv))
    jparams, jreports = jax_load(jcfg, jmodel, moe, monkeypatch)
    model = MFormerV1(**arch(**MOE))
    model.load_state_dict(to_port(moe), strict=True)
    reports = tpre.load_pretrained(tcfg, model)
    assert_same_weights(model, to_port(jparams))
    # the reports name the dense twin's tensors, as JAX's name its template's
    layouts = jax_layouts(MFormerV1(**arch()))
    assert sorted(reports) == sorted(jreports) == ["ConvNeXt", "RoPE-ViT"]
    for name in reports:
        assert as_flax(reports[name], layouts) == jax_mismatch_keys(jreports[name]), name
    rsd = ropevit_sd(2, "{src}.attn.freqs")
    bank = model.stages[2][0].mlp.wi
    for e in range(bank.shape[0]):  # every expert holds the dense file's MLP
        assert torch.equal(bank[e], rsd["blocks.0.mlp.fc1.weight"].t())
    assert torch.equal(model.stages[2][0].mlp.router, to_port(moe)["stages.2.0.mlp.router"])


def _jax_export(params):
    out = jpre.export_reference_mformer_v1(params, DEPTHS[:2], ROPE_DEPTHS, META_NAMES, TASKS)
    return {k: torch.tensor(np.asarray(v)) for k, v in out.items()}


def _write_checkpoint(d, state):
    (d / STATE_DIR).mkdir(parents=True)
    torch.save({"model": state, "step": 3}, d / STATE_DIR / STATE_FILE)
    return str(d)


def _export_config(moe: bool):
    _, cfg = configs()
    cfg.MODEL.CONVNEXT_STAGES.DEPTHS = list(DEPTHS)
    cfg.MODEL.ROPE_STAGES.DEPTHS = list(ROPE_DEPTHS)
    cfg.DATA.TASK_KEYS_H5 = list(TASKS)
    for name in ("TEMPORAL", "SPATIAL"):
        cfg.DATA.META.COMPONENTS[name].ENABLED = True
    cfg.DATA.META.COMPONENTS.TEMPORAL.DIM = 2
    cfg.DATA.META.COMPONENTS.SPATIAL.DIM = 3
    cfg.DATA.META.COMPONENTS.ELEVATION.ENABLED = False
    cfg.MODEL.MOE.ENABLED = moe
    return cfg


@pytest.mark.parametrize("moe", [False, True])
def test_export_matches_jax_and_loads_into_the_dense_model(trees, tmp_path, moe):
    _, moe_params, dense_params = trees
    params = moe_params if moe else dense_params
    state = to_port(params)
    want = _jax_export(jpre.average_experts_into_dense(params) if moe else params)
    direct = tpre.export_reference_mformer_v1(
        tpre.average_experts_into_dense(state) if moe else state, DEPTHS[:2], ROPE_DEPTHS,
        META_NAMES, TASKS)
    out = tmp_path / "model.pth"
    tool = export_torch.export_checkpoint(_export_config(moe),
                                          _write_checkpoint(tmp_path / "ckpt", state), str(out))
    saved = torch.load(out, weights_only=True)
    for got in (direct, tool, saved):
        assert got.keys() == want.keys()
        for k in got:
            if moe and ".mlp." in k:
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, atol=0,
                                           err_msg=k)
            else:
                assert torch.equal(got[k], want[k]), k
    dense = MFormerV1(**arch())
    dense.load_state_dict(saved, strict=True)
    with torch.no_grad():
        logits = dense.eval()(torch.zeros(1, 32, 32, 3), torch.zeros(1, 5))
    assert all(torch.isfinite(v).all() for v in logits.values())
    if moe:
        assert not any(k.endswith((".router", ".wi")) for k in saved)
    else:  # every tensor of the dense model, as it is
        assert_same_weights(dense, state)


MOE_VARIANT = {"MODEL": {"MOE": {"ENABLED": True, "NUM_EXPERTS": 2, "EVERY_N": 1,
                                 "CAPACITY_FACTOR": 2.0}}}


def _moe_bundle(bundle, d):  # noqa: F811
    """The tiny bundle with the MoE variant and a JAX MoE model's
    ``weights.msgpack``."""
    from flax.serialization import to_bytes

    from linnaeus_tpu.inference.config import InferenceConfig
    from linnaeus_tpu.inference.model_utils import build_config_for_inference
    from linnaeus_tpu.models.build import build_model as j_build_model
    from linnaeus_tpu.utils.taxonomy import TaxonomyTree

    config_path = _copy_bundle(bundle, d, variant=MOE_VARIANT)
    inf = InferenceConfig(**yaml.safe_load(config_path.read_text()))
    jcfg = build_config_for_inference(inf)
    tree = TaxonomyTree.load(str(d / "taxonomy.json"))
    jm = j_build_model(jcfg, num_classes={"taxa_L10": 5, "taxa_L20": 3}, taxonomy_tree=tree)
    assert jm.moe_num_experts == 2
    variables = jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.zeros((1, 32, 32, 3)),
                                 jnp.zeros((1, 11)))
    rng = np.random.default_rng(5)
    variables = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        variables)
    (d / "weights.msgpack").write_bytes(to_bytes(variables))
    return config_path


def test_the_handler_serves_a_jax_moe_bundle(bundle, tmp_path, tiny_preset):  # noqa: F811
    ours, theirs = _load_pair(_moe_bundle(bundle, tmp_path / "b"))
    assert ours.model.moe_num_experts == 2
    assert all(b.use_moe for s in (2, 3) for b in ours.model.stages[s])
    images, metas = _requests(5, seed=40)
    x = torch.tensor(np.stack(images)).float()
    with torch.no_grad():
        got = ours.model(x, torch.zeros(5, 11))
    want = theirs.model.apply(theirs.variables, jnp.asarray(np.stack(images), jnp.float32),
                              jnp.zeros((5, 11)))
    for t in BUNDLE_TASKS:
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]), rtol=0, atol=4e-5)
    a, b = ours.predict(images, metas), theirs.predict(images, metas)
    for r1, r2 in zip(a, b):
        for t1, t2 in zip(r1.tasks, r2.tasks):
            assert [i for i, _ in t1.predictions] == [i for i, _ in t2.predictions]
            np.testing.assert_allclose([p for _, p in t1.predictions],
                                       [p for _, p in t2.predictions], rtol=0, atol=1e-4)


def test_the_handler_serves_an_moe_checkpoint_directory(bundle, tmp_path, tiny_preset):  # noqa: F811,E501
    """A port training checkpoint directory as ``weights_path``: the
    handler's model holds its tensors and gives the logits of the model
    they came from, bit for bit."""
    from_msgpack = LinnaeusInferenceHandler.load_from_artifacts(
        _moe_bundle(bundle, tmp_path / "b"))
    state = {k: v + 0.01 for k, v in from_msgpack.model.state_dict().items()}
    from_msgpack.model.load_state_dict(state)
    ckpt = _write_checkpoint(tmp_path / "ckpt", from_msgpack.model.state_dict())
    config_path = _copy_bundle(tmp_path / "b", tmp_path / "c", weights_path=ckpt)
    served = LinnaeusInferenceHandler.load_from_artifacts(config_path)
    assert_same_weights(served.model, from_msgpack.model.state_dict())
    images, _ = _requests(3, seed=41)
    x = torch.tensor(np.stack(images)).float()
    with torch.no_grad():
        a = served.model(x, torch.zeros(3, 11))
        b = from_msgpack.model(x, torch.zeros(3, 11))
    assert all(torch.equal(a[t], b[t]) for t in BUNDLE_TASKS)


@pytest.fixture(autouse=True)
def fresh_registry():
    import linnaeus_tpu_torch.utils.hpc as thpc

    thpc._registry = None
    yield
    thpc._registry = None


def e2e_ropevit_sd(seed):
    """A RoPE-ViT file at the end-to-end config's stage-3 width (32, MLP
    ratio 2): one block, for stage 3's MoE block."""
    from tests.test_torch_pretrained import Seeded

    t, dim, p = Seeded(seed), 32, "blocks.0"
    return {f"{p}.norm1.weight": t(dim), f"{p}.norm1.bias": t(dim),
            f"{p}.attn.qkv.weight": t(3 * dim, dim), f"{p}.attn.qkv.bias": t(3 * dim),
            f"{p}.attn.proj.weight": t(dim, dim), f"{p}.attn.proj.bias": t(dim),
            f"{p}.norm2.weight": t(dim), f"{p}.norm2.bias": t(dim),
            f"{p}.mlp.fc1.weight": t(2 * dim, dim), f"{p}.mlp.fc1.bias": t(2 * dim),
            f"{p}.mlp.fc2.weight": t(dim, 2 * dim), f"{p}.mlp.fc2.bias": t(dim),
            f"{p}.attn.freqs": t(2, 2, dim // 2 // 2)}


def test_the_trainer_upcycles_into_an_moe_model_logs_its_statistics_and_resume_wins(
        tmp_path, data_dir):  # noqa: F811
    """The Trainer on the end-to-end dataset with MODEL.MOE on every RoPE
    block: the RoPE-ViT file's MLP in every expert before the first step,
    the router untouched; one epoch with the statistics in the step log's
    rows and the epoch's train summary; a second run on the same directory resumes
    instead of loading the file again."""
    from linnaeus_tpu_torch.metrics.tracker import MetricsTracker
    from linnaeus_tpu_torch.train.loop import Trainer
    from tests.test_torch_pretrained import tiny_trainer_config
    from tests.test_torch_trainer import step_rows

    rv = tmp_path / "ropevit.pth"
    sd = e2e_ropevit_sd(6)
    torch.save(sd, rv)
    out = tmp_path / "out"

    def config():
        cfg = tiny_trainer_config(data_dir, out, PRETRAINED_ROPEVIT=str(rv))
        cfg.MODEL.MOE.ENABLED = True
        cfg.MODEL.MOE.NUM_EXPERTS = 2
        cfg.MODEL.MOE.EVERY_N = 1
        cfg.SCHEDULE.METRICS.CONSOLE_INTERVAL = 1
        cfg.SCHEDULE.METRICS.WANDB_INTERVAL = 1
        return cfg

    trainer = Trainer(config(), device="cpu")
    assert trainer.pretrained_reports["RoPE-ViT"]["loaded"]
    bank = trainer.model.stages[2][0].mlp
    for e in range(2):  # every expert holds the file's MLP before the first step
        assert torch.equal(bank.wi[e], sd["blocks.0.mlp.fc1.weight"].t())
        assert torch.equal(bank.bo[e], sd["blocks.0.mlp.fc2.bias"])
    router = bank.router.detach().clone()
    assert float(router.abs().sum()) > 0  # its fresh init: the file has none
    trainer.train()
    assert not torch.equal(bank.router, router)
    summary = trainer.metrics.phase_summary(MetricsTracker.TRAIN)
    assert {"moe_aux", "moe_z", "moe_drop_frac"} <= set(summary)
    assert all(np.isfinite(summary[k]) for k in ("moe_aux", "moe_z", "moe_drop_frac"))
    trained = bank.wi.detach().clone()
    trainer.close()
    # the step log's rows (the wandb mirror): every step's carries them
    rows = step_rows(trainer.config.ENV.OUTPUT.DIRS.LOGS)
    assert sorted(rows) == list(range(1, trainer.progress.global_step + 1))
    assert all(np.isfinite(row[f"train/{k}"]) for row in rows.values()
               for k in ("moe_aux", "moe_z", "moe_drop_frac"))
    again = Trainer(config(), device="cpu")
    assert again.pretrained_reports == {}
    assert again.try_resume()
    assert torch.equal(again.model.stages[2][0].mlp.wi, trained)
    again.close()
