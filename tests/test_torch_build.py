"""The config form of the port's ``build_model`` against the JAX package's.

One config, read by both packages' ``build_model``: the module's fields
(dtype, flash attention, fp32 scores, exact GELU, RoPE fidelity, the fused
ConvNeXt MLP switch, drop-path, metadata components, heads) must say the
same, and what the port does not have must raise by name: another
``MODEL.TYPE``, MoE, a non-default aggregation. Gradient checkpointing
(with its policy) and dropout in training mode, once unported, now follow
the config.
"""

import numpy as np
import pytest
import torch

from linnaeus_tpu import configuration as jconf
from linnaeus_tpu.configuration import archs as jarchs
from linnaeus_tpu.models.build import build_model as jbuild_model
from linnaeus_tpu.models.build import resolve_compute_dtype as jresolve
from linnaeus_tpu_torch import configuration as tconf
from linnaeus_tpu_torch.configuration import archs as tarchs
from linnaeus_tpu_torch.models.blocks.convnext import ConvNeXtBlock
from linnaeus_tpu_torch.models.blocks.rope_mhsa import RoPE2DMHSABlock
from linnaeus_tpu_torch.models.build import build_model, resolve_compute_dtype

TASKS = ["taxa_L10", "taxa_L20"]
NC = {"taxa_L10": 7, "taxa_L20": 3}


def _config(conf, archs, **model):
    cfg = conf.get_default_config()
    archs.apply_arch(cfg, "mFormerV1_sm")
    cfg.set_new_allowed(True)
    cfg.merge_from_other_cfg({
        "DATA": {"TASK_KEYS_H5": TASKS},
        "MODEL": {"IMG_SIZE": 64,
                  "CONVNEXT_STAGES": {"DEPTHS": [1, 1, 1, 1], "DIMS": [8, 16, 32, 64]},
                  "ROPE_STAGES": {"DEPTHS": [1, 1], "DIMS": [32, 64], "NUM_HEADS": [2, 2]},
                  **model},
        "TRAIN": {"GRADIENT_CHECKPOINTING": {"ENABLED_NORMAL_STEPS": False}},
    })
    return cfg


def _both(**model):
    return _config(tconf, tarchs, **model), _config(jconf, jarchs, **model)


@pytest.mark.parametrize("model", [
    {},
    {"USE_FLASH_ATTN": True, "ATTN_FP32_SOFTMAX": True, "FUSED_CONVNEXT_MLP": "off"},
    {"ACT_EXACT_GELU": True, "ROPE_FIDELITY": "reference_cos", "FUSED_CONVNEXT_MLP": "on",
     "DROP_PATH_RATE": 0.3},
    {"FUSED_CONVNEXT_MLP": "AUTO", "ONLY_LAST_CLS": True, "IN_CHANS": 1},
])
def test_config_fields_match_jax(model):
    tcfg, jcfg = _both(**model)
    ours = build_model(tcfg, NC, device="cpu")
    theirs = jbuild_model(jcfg, NC)
    assert ours.dtype == {"bfloat16": torch.bfloat16}[np.dtype(theirs.dtype).name]
    assert ours.only_last_cls == theirs.only_last_cls
    assert ours.meta_components == theirs.meta_components == (("TEMPORAL", 2), ("SPATIAL", 3))
    assert ours.stem[0].in_channels == theirs.in_chans
    conv = [m for m in ours.modules() if isinstance(m, ConvNeXtBlock)]
    rope = [m for m in ours.modules() if isinstance(m, RoPE2DMHSABlock)]
    assert len(conv) == 2 and len(rope) == 2
    assert all(b.fused_mlp == theirs.fused_convnext_mlp for b in conv)
    assert all(b.act_exact == theirs.act_exact for b in conv)
    for b in rope:
        assert b.attn.use_flash_attn == theirs.use_flash_attn
        assert b.attn.attn_fp32_softmax == theirs.attn_fp32_softmax
        assert b.attn.rope_fidelity == theirs.rope_fidelity
    # drop-path grows linearly over the four blocks to the config's rate
    rates = [m.drop_path.rate for m in conv + rope]
    np.testing.assert_allclose(rates, np.linspace(0.0, theirs.drop_path_rate, 4))
    assert not ours.training


@pytest.mark.parametrize("train", [
    {"MIXED_PRECISION": {"ENABLED": True, "DTYPE": "float32"}},
    {"MIXED_PRECISION": {"ENABLED": True, "DTYPE": "float16"}},
    {"MIXED_PRECISION": {"ENABLED": False}, "AMP_OPT_LEVEL": "O0"},
    {"MIXED_PRECISION": {"ENABLED": False}, "AMP_OPT_LEVEL": "O2"},
])
def test_compute_dtype_matches_jax(train):
    tcfg, jcfg = _both()
    tcfg.merge_from_other_cfg({"TRAIN": train})
    jcfg.merge_from_other_cfg({"TRAIN": train})
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16"}
    assert names[resolve_compute_dtype(tcfg)] == np.dtype(jresolve(jcfg)).name


def test_num_classes_from_the_config():
    tcfg, jcfg = _both(NUM_CLASSES=[7, 3])
    assert dict(build_model(tcfg, device="cpu").head.items()).keys() == set(TASKS)
    assert jbuild_model(jcfg).num_classes == NC
    tcfg.MODEL.NUM_CLASSES = [7]
    with pytest.raises(ValueError, match="MODEL.NUM_CLASSES"):
        build_model(tcfg, device="cpu")


@pytest.mark.parametrize("change, error, name", [
    ({"MODEL": {"TYPE": "mFormerV0"}}, NotImplementedError, "MODEL.TYPE"),
    ({"MODEL": {"TYPE": "resnet"}}, ValueError, "Unknown MODEL.TYPE"),
    ({"MODEL": {"MOE": {"ENABLED": True, "EVERY_N": 1}}}, NotImplementedError,
     "MODEL.MOE.ENABLED"),
    ({"MODEL": {"AGGREGATION": {"TYPE": "Concatenation"}}}, NotImplementedError,
     "MODEL.AGGREGATION.TYPE"),
    ({"TRAIN": {"GRADIENT_CHECKPOINTING": {"ENABLED_NORMAL_STEPS": True}}},
     NotImplementedError, "gradient_checkpointing"),
])
def test_unported_config_raises_by_name(change, error, name):
    tcfg, jcfg = _both()
    tcfg.merge_from_other_cfg(change)
    if name in ("MODEL.TYPE", "MODEL.AGGREGATION.TYPE", "MODEL.MOE.ENABLED"):
        # ported since (tests/test_torch_mformer_v0.py, tests/test_torch_model_zoo.py,
        # tests/test_torch_moe.py): the config builds the model the JAX package builds
        jcfg.merge_from_other_cfg(change)
        ours, theirs = build_model(tcfg, NC, device="cpu"), jbuild_model(jcfg, NC)
        assert type(ours).__name__ == type(theirs).__name__
        if name == "MODEL.MOE.ENABLED":
            assert ours.moe_num_experts == theirs.moe_num_experts == 8
            assert all(b.use_moe for s in (2, 3) for b in ours.stages[s])
        if name == "MODEL.AGGREGATION.TYPE":
            assert theirs.aggregation == "Concatenation"
            assert type(ours.aggregate_alt).__name__ == "ConcatenationAggregation"
        return
    if name == "gradient_checkpointing":
        # ported: the config's remat setting and policy reach the model, as
        # they reach the JAX package's
        jcfg.merge_from_other_cfg(change)
        for policy in ("dots", "full"):
            for cfg in (tcfg, jcfg):
                cfg.TRAIN.GRADIENT_CHECKPOINTING.POLICY = policy
            ours, theirs = build_model(tcfg, NC, device="cpu"), jbuild_model(jcfg, NC)
            assert ours.gradient_checkpointing is theirs.gradient_checkpointing is True
            assert ours.remat_policy == theirs.remat_policy == policy
        tcfg.TRAIN.GRADIENT_CHECKPOINTING.POLICY = "offload"
        with pytest.raises(ValueError, match="remat policy"):
            build_model(tcfg, NC, device="cpu")
        return
    with pytest.raises(error, match=name):
        build_model(tcfg, NC, device="cpu")


@pytest.mark.parametrize("key", ["DROP_RATE", "ATTN_DROP_RATE"])
def test_dropout_serves_in_eval_and_raises_in_training(key):
    """Dropout, once unported, now acts in training: eval is unchanged by
    it, training draws its masks from the generator (two draws differ, the
    same seed repeats), at the rate the config gives; on K1's route the
    attention dropout is off, as in the JAX package."""
    tcfg, _ = _both(DROP_PATH_RATE=0.0, **{key: 0.1})
    model = build_model(tcfg, NC, device="cpu")
    plain = build_model(_both(DROP_PATH_RATE=0.0)[0], NC, device="cpu")
    assert not model.training
    x, m = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(0)), torch.zeros(2, 5)
    with torch.no_grad():
        out = model(x, m)
        assert all(torch.equal(out[t], plain(x, m)[t]) for t in TASKS)
    drops = [mod for mod in model.modules() if type(mod).__name__ == "Dropout" and mod.rate > 0]
    assert drops and all(mod.rate == 0.1 for mod in drops)
    model.train()
    for mod in drops:
        mod.generator = torch.Generator().manual_seed(1)
    with torch.no_grad():
        a, b = model(x, m), model(x, m)
        for mod in drops:
            mod.generator.manual_seed(1)
        again = model(x, m)
    assert not torch.equal(a["taxa_L10"], b["taxa_L10"])
    assert torch.equal(a["taxa_L10"], again["taxa_L10"])
    flash = build_model(_both(USE_FLASH_ATTN=True, **{key: 0.1})[0], NC, device="cpu")
    attn = [blk.attn.attn_drop.rate for stage in flash.stages[2:] for blk in stage]
    assert attn == [0.0] * len(attn)
    model.eval()


def test_config_form_defaults_to_the_card():
    tcfg, _ = _both()
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the default then succeeds")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(tcfg, NC)
