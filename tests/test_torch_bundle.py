"""From a checkpoint to a served bundle, and the port's tools, against the
TPU package's.

``prepare_inference_bundle``: the TPU package's tool on an Orbax checkpoint
of a tiny mFormerV1's params and the port's tool on a port checkpoint of
the same params (``utils/convert.py``), from the same run assets, write the
same ``class_map.json``, ``taxonomy.json`` and ``config.yaml`` (apart from
``weights_path``), with and without metadata heads; with the same
architecture variant file and ``device: cpu`` set in both, the port's
``load_from_artifacts`` serves float32 logits from the two bundles equal bit
for bit. ``--ema`` bundles the EMA. ``inspect_checkpoints`` and the
throughput test run on the CPU and give the TPU package's result keys.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from linnaeus_tpu.configuration import get_default_config as j_default
from linnaeus_tpu.data.processor import DatasetProcessor, process_and_save_dataset_metadata
from linnaeus_tpu.evaluation.throughput import throughput_test as j_throughput_test
from linnaeus_tpu.models import MFormerV1 as JMFormerV1
from linnaeus_tpu.tools.inspect_checkpoints import inspect_checkpoint as j_inspect
from linnaeus_tpu.tools.prepare_inference_bundle import prepare_bundle as j_prepare
from linnaeus_tpu.train.state import create_train_state as j_state
from linnaeus_tpu.utils import checkpoint as jckpt
from linnaeus_tpu_torch.evaluation.throughput import throughput_test
from linnaeus_tpu_torch.inference.handler import LinnaeusInferenceHandler
from linnaeus_tpu_torch.models.mformer_v1 import MFormerV1
from linnaeus_tpu_torch.tools import inspect_checkpoints, prepare_inference_bundle
from linnaeus_tpu_torch.train import main as tmain
from linnaeus_tpu_torch.train.state import create_train_state
from linnaeus_tpu_torch.utils import checkpoint as tckpt
from linnaeus_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_tools import labels_h5  # noqa: F401  (a fixture)

TASKS = ("taxa_L10", "taxa_L20")
META = (("TEMPORAL", 2), ("SPATIAL", 3))
ARCH = dict(img_size=(32, 32), convnext_depths=(1, 1, 1, 1), convnext_dims=(8, 16, 32, 64),
            rope_depths=(1, 1), rope_dims=(32, 64), rope_num_heads=(2, 2), drop_path_rate=0.0)
VARIANT = {"MODEL": {"TYPE": "mFormerV1", "DROP_PATH_RATE": 0.0,
                     "CONVNEXT_STAGES": {"DEPTHS": [1, 1, 1, 1], "DIMS": [8, 16, 32, 64]},
                     "ROPE_STAGES": {"DEPTHS": [1, 1], "DIMS": [32, 64], "NUM_HEADS": [2, 2],
                                     "MLP_RATIO": [4.0, 4.0]}},
           "TRAIN": {"AMP_OPT_LEVEL": "O0", "MIXED_PRECISION": {"ENABLED": False}}}


@pytest.fixture(scope="module")
def assets(labels_h5, tmp_path_factory):  # noqa: F811
    """The run assets of the labels of tests/test_tools.py, written by the
    TPU package's processor."""
    cfg = j_default()
    cfg.DATA.TASK_KEYS_H5 = list(TASKS)
    cfg.DATA.PARTIAL.LEVELS = True
    cfg.DATA.META.ACTIVE = False
    proc = DatasetProcessor(cfg)
    proc.process_single_file(labels_h5, 0.8, 0)
    out = str(tmp_path_factory.mktemp("assets"))
    process_and_save_dataset_metadata(proc, out)
    return out, dict(proc.num_classes)


def checkpoints(tmp_path, num_classes, meta):
    """A JAX Orbax checkpoint of a tiny mFormerV1's params and a port
    checkpoint of the same params (its EMA the params plus one)."""
    jmodel = JMFormerV1(**ARCH, meta_components=meta, task_keys=TASKS, num_classes=num_classes,
                        head_configs={t: {"TYPE": "Linear"} for t in TASKS})
    aux = jnp.zeros((1, sum(d for _, d in meta))) if meta else None
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), aux)["params"]
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax_ckpts"),
                                  j_state(jmodel, params, optax.sgd(0.1), num_tasks=2,
                                          rng=jax.random.PRNGKey(0)))
    model = MFormerV1(**ARCH, meta_components=meta, task_keys=TASKS, num_classes=num_classes)
    state_dict = state_dict_from_jax(jax.tree.map(np.asarray, params), (1, 1), (1, 1),
                                     tuple(n for n, _ in meta), TASKS)
    model.load_state_dict(state_dict, strict=True)
    state = create_train_state(model, torch.optim.SGD(model.parameters(), lr=0.1), num_tasks=2,
                               generator=torch.Generator().manual_seed(0), ema=True)
    for v in state.ema_params.values():
        v.add_(1.0)
    tpath = tckpt.save_checkpoint(str(tmp_path / "port_ckpts"), state)
    return jpath, tpath, state


def on_cpu_with_variant(bundle: str, variant: str) -> str:
    path = os.path.join(bundle, "config.yaml")
    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg["model"]["architecture_variant_config_path"] = variant
    cfg["inference_options"]["device"] = "cpu"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return path


def read(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("meta", [(), META], ids=["no_meta", "temporal_spatial"])
def test_the_ports_bundle_is_the_jax_tools_bundle(assets, tmp_path, meta):
    assets_dir, num_classes = assets
    jpath, tpath, state = checkpoints(tmp_path, num_classes, meta)
    args = (assets_dir, "tiny", list(TASKS), [num_classes[t] for t in TASKS])
    jb = j_prepare(jpath, assets_dir, str(tmp_path / "jax_bundle"), *args[1:], image_size=32)
    tb = prepare_inference_bundle.prepare_bundle(tpath, assets_dir, str(tmp_path / "port_bundle"),
                                                 *args[1:], image_size=32)
    for name in ("class_map.json", "taxonomy.json"):
        assert read(os.path.join(jb, name)) == read(os.path.join(tb, name)), name
    jcfg, tcfg = (yaml.safe_load(read(os.path.join(b, "config.yaml"))) for b in (jb, tb))
    assert (jcfg["model"].pop("weights_path"), tcfg["model"].pop("weights_path")) == (
        "weights.msgpack", "weights.pt")
    assert jcfg == tcfg
    assert tcfg["metadata_preprocessing"]["use_temporal"] is bool(meta)
    assert tcfg["model"]["expected_aux_vector_length"] == sum(d for _, d in meta)

    variant = str(tmp_path / "variant.yaml")
    with open(variant, "w") as f:
        yaml.safe_dump(VARIANT, f)
    handlers = [LinnaeusInferenceHandler.load_from_artifacts(on_cpu_with_variant(b, variant))
                for b in (jb, tb)]
    g = torch.Generator().manual_seed(3)
    x = torch.rand((4, 32, 32, 3), generator=g)
    a = torch.randn((4, sum(d for _, d in meta)), generator=g)
    with torch.inference_mode():
        logits = [h.model(x, a) for h in handlers]
    assert all(p.dtype == torch.float32 for p in handlers[1].model.parameters())
    for t in TASKS:
        assert logits[0][t].dtype == torch.float32 and torch.equal(logits[0][t], logits[1][t]), t

    # --ema: the EMA's values; without an EMA in the checkpoint it raises
    ema = prepare_inference_bundle.prepare_bundle(tpath, assets_dir, str(tmp_path / "ema"),
                                                  *args[1:], image_size=32, use_ema=True)
    weights = torch.load(os.path.join(ema, "weights.pt"), weights_only=True)
    assert weights.keys() == state.ema_params.keys()
    assert all(torch.equal(weights[k], v) for k, v in state.ema_params.items())
    state.ema_params = None
    plain = tckpt.save_checkpoint(str(tmp_path / "plain_ckpts"), state)
    with pytest.raises(ValueError, match="--ema"):
        prepare_inference_bundle.prepare_bundle(plain, assets_dir, str(tmp_path / "x"),
                                                *args[1:], use_ema=True)


def test_inspect_checkpoints_gives_the_jax_tools_keys(assets, tmp_path, capsys):
    assets_dir, num_classes = assets
    jpath, tpath, state = checkpoints(tmp_path, num_classes, ())
    j_info, t_info = j_inspect(jpath), inspect_checkpoints.inspect_checkpoint(tpath)
    assert j_info.keys() == t_info.keys()
    assert {k: v for k, v in j_info.items() if k != "path"} == {
        k: v for k, v in t_info.items() if k != "path"}
    j_full = j_inspect(jpath, show_params=True)
    t_full = inspect_checkpoints.inspect_checkpoint(tpath, show_params=True)
    assert set(t_full) == set(j_full) | {"num_params"}
    model = state.model.state_dict()
    assert t_full["tree"] == {k: list(v.shape) for k, v in model.items()}
    assert t_full["num_params"] == sum(v.numel() for v in model.values())
    inspect_checkpoints.main([os.path.dirname(tpath), "--params"])
    printed = json.loads(capsys.readouterr().out)
    assert printed["step"] == 0 and printed["num_params"] == t_full["num_params"]


def test_throughput_tests_give_the_jax_keys(tmp_path):
    jmodel = JMFormerV1(**ARCH, meta_components=META, task_keys=TASKS,
                        num_classes={"taxa_L10": 5, "taxa_L20": 3},
                        head_configs={t: {"TYPE": "Linear"} for t in TASKS})
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                  jnp.zeros((1, 5)))["params"]
    want = j_throughput_test(model=jmodel, params=params, batch_sizes=[2, 4], warmup=1, iters=2)
    model = MFormerV1(**ARCH, meta_components=META, task_keys=TASKS,
                      num_classes={"taxa_L10": 5, "taxa_L20": 3})
    got = throughput_test(model=model, batch_sizes=[2, 4], warmup=1, iters=2)
    assert list(got) == list(want) == [2, 4]
    assert all(got[b].keys() == want[b].keys() and all(v > 0 for v in got[b].values())
               for b in got)

    # the CLI's --throughput on the CPU builds the config's model
    cfg = {**VARIANT, "MODEL": {**VARIANT["MODEL"], "IMG_SIZE": 32, "NUM_CLASSES": [5, 3]},
           "DATA": {"TASK_KEYS_H5": list(TASKS), "IMG_SIZE": 32},
           "ENV": {"OUTPUT": {"BASE_DIR": str(tmp_path / "out")}}}
    path = str(tmp_path / "tput.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    results = tmain.main(["--cfg", path, "--device", "cpu", "--throughput"])
    assert list(results) == [32, 64, 128, 256]
    assert all(r.keys() == want[2].keys() for r in results.values())



V0_ARCH = dict(img_size=(32, 32), stage_dims=(8, 12, 24, 32, 64), mbconv_depths=(1, 1),
               attn_depths=(1, 1), num_heads=(2, 2), drop_path_rate=0.0)
V0_VARIANT = {"MODEL": {"TYPE": "mFormerV0", "DROP_PATH_RATE": 0.0,
                        "STAGES": {"DIMS": [8, 12, 24, 32, 64], "MBCONV_DEPTHS": [1, 1],
                                   "ATTN_DEPTHS": [1, 1], "NUM_HEADS": [2, 2],
                                   "MLP_RATIO": [4.0, 4.0]}},
              "TRAIN": {"AMP_OPT_LEVEL": "O0", "MIXED_PRECISION": {"ENABLED": False}}}


def v0_checkpoints(tmp_path, num_classes, meta):
    """A JAX Orbax checkpoint of a tiny mFormerV0's params and moved running
    statistics, and a port checkpoint of the same variables."""
    from linnaeus_tpu.models import MFormerV0 as JMFormerV0
    from linnaeus_tpu_torch.models.mformer_v0 import MFormerV0
    from linnaeus_tpu_torch.utils.convert import load_jax_variables

    jmodel = JMFormerV0(**V0_ARCH, meta_components=meta, task_keys=TASKS,
                        num_classes=num_classes,
                        head_configs={t: {"TYPE": "Linear"} for t in TASKS})
    aux = jnp.zeros((1, sum(d for _, d in meta)))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), aux)
    rng = np.random.default_rng(5)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) + (0.5 if path[-1].key == "var" else 0.1)
        * np.abs(rng.normal(size=a.shape)).astype(np.float32), variables["batch_stats"])
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax_ckpts"), j_state(
        jmodel, variables["params"], optax.sgd(0.1), num_tasks=2, rng=jax.random.PRNGKey(0),
        batch_stats=jax.tree.map(jnp.asarray, stats)))
    model = MFormerV0(**V0_ARCH, meta_components=meta, task_keys=TASKS, num_classes=num_classes)
    load_jax_variables(model, {"params": jax.tree.map(np.asarray, variables["params"]),
                               "batch_stats": stats})
    state = create_train_state(model, torch.optim.SGD(model.parameters(), lr=0.1), num_tasks=2,
                               generator=torch.Generator().manual_seed(0))
    return jpath, tckpt.save_checkpoint(str(tmp_path / "port_ckpts"), state), state


def with_weights(config_path: str, weights_path: str, out: str) -> str:
    with open(config_path) as f:
        cfg = yaml.safe_load(f)
    cfg["model"]["weights_path"] = weights_path
    with open(out, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return out


@pytest.mark.parametrize("family", ["mFormerV1", "mFormerV0"])
def test_a_training_checkpoint_directory_serves_as_its_bundle(assets, tmp_path, family):
    """F8: the handler loads the port's training checkpoint directory
    (``state/state.pt``, running statistics included) and gives the logits
    of the ``weights.pt`` the bundle tool writes from it, bit for bit; the
    JAX package's Orbax directory raises by name. For mFormerV0 the JAX
    tool's ``weights.msgpack`` (``params`` and ``batch_stats``) serves the
    same bits, and the JAX handler on it agrees to the model bar."""
    from linnaeus_tpu.inference import LinnaeusInferenceHandler as JHandler
    from linnaeus_tpu_torch.inference.model_utils import load_weights

    assets_dir, num_classes = assets
    if family == "mFormerV1":
        jpath, tpath, state = checkpoints(tmp_path, num_classes, META)
        variant_cfg = VARIANT
    else:
        jpath, tpath, state = v0_checkpoints(tmp_path, num_classes, META)
        variant_cfg = V0_VARIANT
    args = ("tiny", list(TASKS), [num_classes[t] for t in TASKS])
    tb = prepare_inference_bundle.prepare_bundle(tpath, assets_dir, str(tmp_path / "port_bundle"),
                                                 *args, image_size=32)
    variant = str(tmp_path / "variant.yaml")
    with open(variant, "w") as f:
        yaml.safe_dump(variant_cfg, f)
    from_pt = on_cpu_with_variant(tb, variant)
    from_dir = with_weights(from_pt, os.path.abspath(tpath), os.path.join(tb, "from_dir.yaml"))
    handlers = {name: LinnaeusInferenceHandler.load_from_artifacts(path)
                for name, path in (("pt", from_pt), ("dir", from_dir))}
    assert type(handlers["dir"].model).__name__ == family.replace("mF", "MF")
    g = torch.Generator().manual_seed(4)
    x = torch.rand((4, 32, 32, 3), generator=g)
    a = torch.randn((4, 5), generator=g)
    with torch.inference_mode():
        logits = {name: h.model(x, a) for name, h in handlers.items()}
    for t in TASKS:
        assert torch.equal(logits["pt"][t], logits["dir"][t]), t
    want = {k: v for k, v in state.model.state_dict().items()}
    got = handlers["dir"].model.state_dict()
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(NotImplementedError, match="Orbax"):
        load_weights(handlers["dir"].model, jpath)
    with pytest.raises(FileNotFoundError, match="No checkpoint state"):
        load_weights(handlers["dir"].model, str(tmp_path))
    if family == "mFormerV1":
        return
    jb = j_prepare(jpath, assets_dir, str(tmp_path / "jax_bundle"), *args, image_size=32)
    from_msgpack = LinnaeusInferenceHandler.load_from_artifacts(on_cpu_with_variant(jb, variant))
    theirs = JHandler.load_from_artifacts(os.path.join(jb, "config.yaml"))
    assert "batch_stats" in theirs.variables
    with torch.inference_mode():
        ours = from_msgpack.model(x, a)
    ref = theirs.model.apply(theirs.variables, jnp.asarray(x.numpy()), jnp.asarray(a.numpy()))
    for t in TASKS:
        assert torch.equal(ours[t], logits["dir"][t]), t
        np.testing.assert_allclose(ours[t].numpy(), np.asarray(ref[t]), atol=4e-5, rtol=0)
