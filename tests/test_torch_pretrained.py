"""The port's pretrained initialisation against the TPU package's.

The same seeded checkpoint files (the official ConvNeXt layout wrapped as
``{"model": ...}``, the RoPE-ViT layout with its frequencies under each of
the three spellings, the reference framework's own mFormerV1 layout) go
through ``linnaeus_tpu.utils.pretrained.load_pretrained`` (then
``utils/convert.py::state_dict_from_jax``) and through the port's
``load_pretrained``, both from the same initial weights of a tiny
mFormerV1. Every tensor must come out equal bit for bit and the loaders'
reports (loaded / missing / shape_mismatch, the port's keys taken to Flax
paths through ``jax_layouts``) equal. Every source tensor holds distinct
seeded values, so a swapped pair cannot pass. Then the Trainer: resume wins
over pretrained init, the EMA and the optimizer start from the loaded
weights, and configs/experiments/generic_mformer_example.yaml at tiny
widths builds a port Trainer from local files; what waits raises by name.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linnaeus_tpu.utils.pretrained as jpre
import linnaeus_tpu_torch.utils.hpc as thpc
from linnaeus_tpu.configuration import get_default_config as j_default
from linnaeus_tpu.models import MFormerV1 as JMFormerV1
from linnaeus_tpu_torch.configuration import build_config
from linnaeus_tpu_torch.configuration import get_default_config as t_default
from linnaeus_tpu_torch.models.mformer_v1 import MFormerV1
from linnaeus_tpu_torch.train.loop import Trainer
from linnaeus_tpu_torch.utils import pretrained as tpre
from linnaeus_tpu_torch.utils.convert import jax_layouts, state_dict_from_jax
from tests.test_torch_trainer import REPO, port_config, time_limit
from tests.test_trainer_e2e import data_dir, make_config  # noqa: F401  (data_dir: a fixture)

DEPTHS = (1, 2, 1, 1)
DIMS = (8, 16, 32, 64)
ROPE_DEPTHS = (2, 1)
ROPE_DIMS = (32, 64)
META = (("TEMPORAL", 2), ("SPATIAL", 3))
TASKS = ("t1", "t2")
NUM_CLASSES = {"t1": 5, "t2": 3}


def arch(**kw):
    return dict(img_size=(32, 32), convnext_depths=DEPTHS, convnext_dims=DIMS,
                rope_depths=ROPE_DEPTHS, rope_dims=ROPE_DIMS, rope_num_heads=(2, 2),
                drop_path_rate=0.0, meta_components=META, task_keys=TASKS,
                num_classes=NUM_CLASSES, **kw)


@pytest.fixture(scope="module")
def initial():
    """The JAX model, its initial params, and the port model holding them."""
    jmodel = JMFormerV1(**arch(head_configs={t: {"TYPE": "Linear"} for t in TASKS}))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                  jnp.zeros((1, 5)))
    params = jax.tree.map(np.asarray, params["params"])
    return jmodel, params


def port_model(params) -> MFormerV1:
    model = MFormerV1(**arch())
    model.load_state_dict(to_port(params), strict=True)
    return model


def to_port(params) -> dict[str, torch.Tensor]:
    return state_dict_from_jax(params, DEPTHS[:2], ROPE_DEPTHS, tuple(n for n, _ in META), TASKS)


class Seeded:
    """Distinct seeded normal values for every tensor asked for."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def __call__(self, *shape) -> torch.Tensor:
        return torch.tensor(self.rng.normal(size=shape).astype(np.float32))


def convnext_sd(seed: int, stem_out: int = DIMS[0]) -> dict[str, torch.Tensor]:
    """Official ConvNeXt layout at the tiny widths, one block more in stage
    1 than the model holds, a head the map ignores."""
    t = Seeded(seed)
    sd = {"downsample_layers.0.0.weight": t(stem_out, 3, 4, 4),
          "downsample_layers.0.0.bias": t(stem_out),
          "downsample_layers.0.1.weight": t(DIMS[0]), "downsample_layers.0.1.bias": t(DIMS[0])}
    for s in (0, 1):
        dim = DIMS[s]
        for j in range(DEPTHS[s] + 1):
            p = f"stages.{s}.{j}"
            sd.update({f"{p}.dwconv.weight": t(dim, 1, 7, 7), f"{p}.dwconv.bias": t(dim),
                       f"{p}.norm.weight": t(dim), f"{p}.norm.bias": t(dim),
                       f"{p}.pwconv1.weight": t(4 * dim, dim), f"{p}.pwconv1.bias": t(4 * dim),
                       f"{p}.pwconv2.weight": t(dim, 4 * dim), f"{p}.pwconv2.bias": t(dim),
                       f"{p}.gamma": t(dim)})
    for i in (1, 2, 3):
        din, dout = DIMS[i - 1], DIMS[i]
        sd.update({f"downsample_layers.{i}.0.weight": t(din),
                   f"downsample_layers.{i}.0.bias": t(din),
                   f"downsample_layers.{i}.1.weight": t(dout, din, 2, 2),
                   f"downsample_layers.{i}.1.bias": t(dout)})
    sd.update({"norm.weight": t(DIMS[3]), "head.weight": t(10, DIMS[3])})
    return sd


def ropevit_sd(seed: int, freq_spelling: str) -> dict[str, torch.Tensor]:
    """RoPE-ViT layout, DeiT-like: four blocks all ROPE_DIMS[0] wide, so
    stage 4's block (64 wide) meets shape mismatches; the frequencies under
    ``freq_spelling`` ('{src}.attn.freqs', 'freqs_{i}' or '{src}.freqs')."""
    t = Seeded(seed)
    dim, sd = ROPE_DIMS[0], {}
    for i in range(4):
        p = f"blocks.{i}"
        sd.update({f"{p}.norm1.weight": t(dim), f"{p}.norm1.bias": t(dim),
                   f"{p}.attn.qkv.weight": t(3 * dim, dim), f"{p}.attn.qkv.bias": t(3 * dim),
                   f"{p}.attn.proj.weight": t(dim, dim), f"{p}.attn.proj.bias": t(dim),
                   f"{p}.norm2.weight": t(dim), f"{p}.norm2.bias": t(dim),
                   f"{p}.mlp.fc1.weight": t(4 * dim, dim), f"{p}.mlp.fc1.bias": t(4 * dim),
                   f"{p}.mlp.fc2.weight": t(dim, 4 * dim), f"{p}.mlp.fc2.bias": t(dim)})
        sd[freq_spelling.format(src=p, i=i)] = t(2, 2, dim // 2 // 2)
    del sd["blocks.1.norm2.bias"]  # a source key the file lacks
    return sd


def configs(**model):
    """The TPU package's default config and the port's, mFormerV1, with
    ``model`` set under MODEL."""
    out = []
    for cfg in (j_default(), t_default()):
        cfg.MODEL.TYPE = "mFormerV1"
        for key, value in model.items():
            cfg.MODEL[key] = value
        out.append(cfg)
    return out


def jax_load(cfg, jmodel, params, monkeypatch):
    """JAX's load_pretrained and the reports it logs, by loader name."""
    reports = {}
    original = jpre._log_report

    def capture(name, report):
        reports[name] = {k: list(v) for k, v in report.items()}
        original(name, report)

    monkeypatch.setattr(jpre, "_log_report", capture)
    out, _ = jpre.load_pretrained(cfg, jmodel, params, None)
    return jax.tree.map(np.asarray, out), reports


def as_flax(report, layouts):
    """A port report with its keys taken to Flax paths; shape mismatches
    compared by key (their shapes are in each package's layout)."""
    def path(entry):
        return entry if entry.startswith("src:") else layouts[entry].path

    return {"loaded": [path(k) for k in report["loaded"]],
            "missing": [path(k) for k in report["missing"]],
            "shape_mismatch": [path(m.split(":")[0]) for m in report["shape_mismatch"]]}


def jax_mismatch_keys(report):
    return {**report, "shape_mismatch": [m.split(":")[0] for m in report["shape_mismatch"]]}


def assert_same_weights(model, want):
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("freq_spelling", ["{src}.attn.freqs", "freqs_{i}", "{src}.freqs"])
def test_stitched_init_matches_jax(initial, tmp_path, monkeypatch, freq_spelling):
    jmodel, params = initial
    cn, rv = tmp_path / "convnext.pth", tmp_path / "ropevit.pth"
    torch.save({"model": convnext_sd(1)}, cn)
    torch.save(ropevit_sd(2, freq_spelling), rv)
    jcfg, tcfg = configs(PRETRAINED_SOURCE="stitched_convnext_ropevit",
                         PRETRAINED_CONVNEXT=str(cn), PRETRAINED_ROPEVIT=str(rv))
    jparams, jreports = jax_load(jcfg, jmodel, params, monkeypatch)
    model = port_model(params)
    reports = tpre.load_pretrained(tcfg, model)
    assert_same_weights(model, to_port(jparams))
    layouts = jax_layouts(model)
    assert sorted(reports) == sorted(jreports) == ["ConvNeXt", "RoPE-ViT"]
    for name in reports:
        assert as_flax(reports[name], layouts) == jax_mismatch_keys(jreports[name]), name
    rope = reports["RoPE-ViT"]
    assert "src:blocks.1.norm2.bias" in rope["missing"]
    assert "stages.2.0.attn.freqs" in rope["loaded"] and "stages.3.0.attn.freqs" in [
        m.split(":")[0] for m in rope["shape_mismatch"]]
    # the official stem and downsamplers land one index down, and every
    # mapped tensor holds its source's values
    sd = convnext_sd(1)
    assert torch.equal(model.stem[0].weight, sd["downsample_layers.0.0.weight"])
    assert torch.equal(model.downsample_layers[0].norm.weight, sd["downsample_layers.1.0.weight"])
    assert torch.equal(model.downsample_layers[2].conv.weight, sd["downsample_layers.3.1.weight"])
    assert len(reports["ConvNeXt"]["loaded"]) == 4 + 9 * (DEPTHS[0] + DEPTHS[1]) + 12


def test_a_shape_mismatch_is_skipped_and_reported(initial, tmp_path, monkeypatch):
    jmodel, params = initial
    cn = tmp_path / "convnext.pth"
    torch.save(convnext_sd(3, stem_out=99), cn)
    jcfg, tcfg = configs(PRETRAINED_CONVNEXT=str(cn))
    jparams, jreports = jax_load(jcfg, jmodel, params, monkeypatch)
    model = port_model(params)
    reports = tpre.load_pretrained(tcfg, model)
    assert_same_weights(model, to_port(jparams))
    assert as_flax(reports["ConvNeXt"], jax_layouts(model)) == jax_mismatch_keys(
        jreports["ConvNeXt"])
    assert reports["ConvNeXt"]["shape_mismatch"] == [
        "stem.0.weight: (99, 3, 4, 4) -> expected (8, 3, 4, 4)",
        "stem.0.bias: (99,) -> expected (8,)"]
    assert torch.equal(model.stem[0].weight, to_port(params)["stem.0.weight"])


def test_reference_source_matches_jax(initial, tmp_path, monkeypatch):
    """The reference's own layout, the source inferred from MODEL.TYPE: the
    map is the identity for the port; JAX converts every layout."""
    jmodel, params = initial
    source = MFormerV1(**arch())
    with torch.no_grad():
        t = Seeded(4)
        for p in source.parameters():
            p.copy_(t(*p.shape))
    sd = {f"module.{k}": v for k, v in source.state_dict().items()}
    del sd["module.final_norm.bias"]
    path = tmp_path / "reference.pth"
    torch.save({"state_dict": sd}, path)
    jcfg, tcfg = configs(PRETRAINED=str(path))
    jparams, jreports = jax_load(jcfg, jmodel, params, monkeypatch)
    model = port_model(params)
    reports = tpre.load_pretrained(tcfg, model)
    assert_same_weights(model, to_port(jparams))
    assert list(reports) == list(jreports) == ["reference-mFormerV1"]
    report = reports["reference-mFormerV1"]
    assert as_flax(report, jax_layouts(model)) == jax_mismatch_keys(jreports["reference-mFormerV1"])
    assert report["missing"] == ["src:final_norm.bias"] and not report["shape_mismatch"]
    assert len(report["loaded"]) == len(model.state_dict()) - 1


def test_nothing_configured_loads_nothing_and_what_waits_raises(initial, tmp_path):
    model = port_model(initial[1])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert tpre.load_pretrained(t_default(), model) == {}
    assert_same_weights(model, before)
    for key, value, error, match in (
        ("PRETRAINED", "hf://org/repo/w.pth", NotImplementedError, r"MODEL\.PRETRAINED 'hf://"),
        # b2:// resolves through utils/remote_sync.py, which needs b2sdk (absent here)
        ("PRETRAINED_ROPEVIT", "b2://bucket/w.pth", RuntimeError,
         r"MODEL\.PRETRAINED_ROPEVIT 'b2://.*b2sdk"),
    ):
        _, cfg = configs(**{key: value})
        with pytest.raises(error, match=match):
            tpre.load_pretrained(cfg, model)
    _, cfg = configs(PRETRAINED=str(tmp_path / "w.pth"), PRETRAINED_SOURCE="other")
    with pytest.raises(ValueError, match="Unknown MODEL.PRETRAINED_SOURCE 'other'"):
        tpre.load_pretrained(cfg, model)
    # MoE is ported (sparse upcycling, tests/test_torch_moe_pretrained.py): the
    # model's own tensors decide, as the params tree does in the JAX package,
    # so MODEL.MOE with a dense model loads it as a dense one
    torch.save(model.state_dict(), tmp_path / "w.pth")
    _, cfg = configs(PRETRAINED=str(tmp_path / "w.pth"))
    cfg.MODEL.MOE.ENABLED = True
    reports = tpre.load_pretrained(cfg, model)
    assert len(reports["reference-mFormerV1"]["loaded"]) == len(before)
    assert_same_weights(model, before)
    with pytest.raises(NotImplementedError, match="hf://"):
        tpre.load_torch_state_dict("hf://org/repo/w.pth")


@pytest.fixture(autouse=True)
def fresh_registry():
    thpc._registry = None
    yield
    thpc._registry = None


def tiny_trainer_config(data_dir, out, **model):  # noqa: F811
    cfg = port_config(make_config(data_dir, out, epochs=1))
    cfg.TRAIN.EMA.ENABLED = True
    for key, value in model.items():
        cfg.MODEL[key] = value
    return cfg


def e2e_convnext_sd(seed):
    """convnext_sd at make_config's depths (1, 1, 1, 1)."""
    sd = convnext_sd(seed)
    return {k: v for k, v in sd.items() if not k.startswith(("stages.0.1.", "stages.1.1.",
                                                              "stages.1.2."))}


@time_limit(180)
def test_trainer_loads_pretrained_before_the_optimizer_and_resume_wins(data_dir, tmp_path):  # noqa: F811
    cn = tmp_path / "convnext.pth"
    sd = e2e_convnext_sd(5)
    torch.save({"model": sd}, cn)
    out = tmp_path / "out"
    trainer = Trainer(tiny_trainer_config(data_dir, out, PRETRAINED_CONVNEXT=str(cn)),
                      device="cpu")
    report = trainer.pretrained_reports["ConvNeXt"]
    assert not report["shape_mismatch"] and len(report["loaded"]) == 4 + 9 * 2 + 12
    stem = trainer.model.stem[0].weight
    assert torch.equal(stem, sd["downsample_layers.0.0.weight"])
    # the optimizer holds the loaded parameters and the EMA starts from them
    assert any(p is stem for g in trainer.state.optimizer.param_groups for p in g["params"])
    assert torch.equal(trainer.state.ema_params["stem.0.weight"], stem)
    trainer.train()
    trained = trainer.model.stem[0].weight.detach().clone()
    assert not torch.equal(trained, sd["downsample_layers.0.0.weight"])
    trainer.close()
    # a second run on the same output directory resumes: no pretrained init
    again = Trainer(tiny_trainer_config(data_dir, out, PRETRAINED_CONVNEXT=str(cn)),
                    device="cpu")
    assert again.pretrained_reports == {}
    assert again.try_resume()
    assert torch.equal(again.model.stem[0].weight, trained)
    again.close()


@time_limit(180)
def test_the_example_config_builds_a_trainer_from_local_files(data_dir, tmp_path,  # noqa: F811
                                                               monkeypatch):
    """configs/experiments/generic_mformer_example.yaml (stitched init,
    ConditionalClassifier heads with soft routing, the heads' group) at
    make_config's tiny widths and data; its MODEL.BASE resolves under
    $CONFIG_DIR, the repository's root."""
    monkeypatch.setenv("CONFIG_DIR", REPO)
    cn, rv = tmp_path / "convnext.pth", tmp_path / "ropevit.pth"
    torch.save({"model": e2e_convnext_sd(6)}, cn)
    rope = ropevit_sd(7, "{src}.attn.freqs")
    torch.save(rope, rv)
    tiny = make_config(data_dir, tmp_path / "out", epochs=1)
    opts = ["MODEL.PRETRAINED_CONVNEXT", str(cn), "MODEL.PRETRAINED_ROPEVIT", str(rv)]
    for key in ("MODEL.IMG_SIZE", "DATA.IMG_SIZE", "DATA.BATCH_SIZE", "DATA.BATCH_SIZE_VAL",
                "DATA.TASK_KEYS_H5", "DATA.H5.LABELS_PATH", "DATA.H5.IMAGES_PATH",
                "DATA.H5.TRAIN_VAL_SPLIT_RATIO", "ENV.OUTPUT.BASE_DIR", "SCHEDULE.MIX.GROUP_LEVELS",
                "MODEL.CONVNEXT_STAGES.DEPTHS", "MODEL.CONVNEXT_STAGES.DIMS",
                "MODEL.ROPE_STAGES.DEPTHS", "MODEL.ROPE_STAGES.DIMS",
                "MODEL.ROPE_STAGES.NUM_HEADS", "TRAIN.EPOCHS"):
        node = tiny
        for part in key.split("."):
            node = node[part]
        opts += [key, repr(list(node)) if isinstance(node, (list, tuple)) else str(node)]
    cfg = build_config(os.path.join(REPO, "configs/experiments/generic_mformer_example.yaml"),
                       opts=opts)
    trainer = Trainer(cfg, device="cpu")
    heads = trainer.model.head
    assert all(heads.head_configs[t]["TYPE"] == "ConditionalClassifier" for t in heads.task_keys)
    reports = trainer.pretrained_reports
    assert sorted(reports) == ["ConvNeXt", "RoPE-ViT"]
    assert len(reports["ConvNeXt"]["loaded"]) == 4 + 9 * 2 + 12
    assert torch.equal(trainer.model.stages[2][0].attn.qkv.weight, rope["blocks.0.attn.qkv.weight"])
    trainer.close()


# ------------------------------------------------------------------ mFormerV0
V0_KW = dict(img_size=(64, 64), stage_dims=(8, 12, 24, 32, 64), mbconv_depths=(1, 1),
             attn_depths=(1, 1), num_heads=(2, 2), drop_path_rate=0.0, meta_components=META,
             task_keys=TASKS, num_classes=NUM_CLASSES)


def metafg_sd(model, seed: int) -> dict[str, torch.Tensor]:
    """A MetaFG-layout file for the tiny mFormerV0, every tensor seeded and
    distinct: running variances positive, MetaFG's ``num_batches_tracked``,
    ``relative_position_index`` and 1000-class ``head`` beside them, task
    t1's head present and t2's absent, a bias of stage 4 missing, and two
    tensors of another geometry (a 32 px stage-3 bias table, a temporal
    head with hour columns)."""
    t = Seeded(seed)
    sd = {}
    for key, value in model.state_dict().items():
        sd[key] = t(*value.shape)
        if key.endswith("running_var"):
            sd[key] = sd[key].abs() + 0.5
            sd[key.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    for name, module in model.named_modules():
        if hasattr(module, "relative_position_index"):
            sd[f"{name}.relative_position_index"] = module.relative_position_index
    sd.update({"head.weight": t(1000, 64), "head.bias": t(1000)})
    del sd["head.t2.fc.weight"], sd["head.t2.fc.bias"], sd["stage_4.0.mlp.fc2.bias"]
    sd["stage_3.0.attn.relative_position_bias_table"] = t(3 * 3 + 1, 2)
    sd["meta_temporal_head_1.0.weight"] = t(32, 4)
    return sd


def test_metaformer_init_of_mformer_v0_matches_jax(tmp_path, monkeypatch):
    """The same seeded MetaFG file through the TPU package's
    ``load_pretrained`` (source inferred from MODEL.TYPE mFormerV0) and the
    port's: parameters and running statistics bit for bit, and the same
    reports, the port's keys taken to Flax paths."""
    from linnaeus_tpu.models import MFormerV0 as JMFormerV0
    from linnaeus_tpu_torch.models.mformer_v0 import MFormerV0
    from linnaeus_tpu_torch.utils.convert import (
        JaxLayout,
        _v0_stat_entries,
        load_jax_variables,
        state_dict_from_variables,
    )

    jmodel = JMFormerV0(**V0_KW, head_configs={t: {"TYPE": "Linear"} for t in TASKS})
    variables = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 5))))
    model = MFormerV0(**V0_KW)
    load_jax_variables(model, variables)
    path = tmp_path / "metafg.pth"
    torch.save({"model": metafg_sd(model, 7)}, path)

    jreports = {}
    original = jpre._log_report

    def capture(name, report):
        jreports[name] = {k: list(v) for k, v in report.items()}
        original(name, report)

    monkeypatch.setattr(jpre, "_log_report", capture)
    jcfg, tcfg = configs(PRETRAINED=str(path))
    for cfg in (jcfg, tcfg):
        cfg.MODEL.TYPE = "mFormerV0"
    jparams, jstats = jpre.load_pretrained(jcfg, jmodel, variables["params"],
                                           variables["batch_stats"])
    reports = tpre.load_pretrained(tcfg, model)
    want = state_dict_from_variables(model, {"params": jax.tree.map(np.asarray, jparams),
                                             "batch_stats": jax.tree.map(np.asarray, jstats)})
    assert_same_weights(model, want)
    assert list(reports) == list(jreports) == ["MetaFormer", "MetaFormer/bn-stats"]
    layouts = jax_layouts(model) | {k: JaxLayout("/".join(p), None, None)
                                    for k, p, _ in _v0_stat_entries(variables["params"], (1, 1))}
    for name in reports:
        assert as_flax(reports[name], layouts) == jax_mismatch_keys(jreports[name]), name
    report = reports["MetaFormer"]
    assert sorted(report["missing"]) == ["src:head.t2.fc.bias", "src:head.t2.fc.weight",
                                        "src:stage_4.0.mlp.fc2.bias"]
    assert sorted(m.split(":")[0] for m in report["shape_mismatch"]) == [
        "meta_temporal_head_1.0.weight", "stage_3.0.attn.relative_position_bias_table"]
    assert len(reports["MetaFormer/bn-stats"]["loaded"]) == 18
    source = tpre.load_torch_state_dict(str(path))
    for key in report["loaded"] + reports["MetaFormer/bn-stats"]["loaded"]:
        assert torch.equal(model.state_dict()[key], source[key]), key
