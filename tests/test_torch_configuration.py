"""The port's copy of the configuration package against the JAX package's.

``linnaeus_tpu_torch/configuration/`` (``cfg_node``, ``defaults``, ``utils``,
``archs``) and ``utils/meta.py`` are copies: the port imports nothing of
the JAX package. Every yaml under ``configs/`` loads through both, with the
working directory and ``$CONFIG_DIR`` at the repository root (the in-file
``MODEL.BASE`` paths start with ``configs/``): both raise the same error or
give equal ``to_dict()``.
"""

from pathlib import Path

import pytest

from linnaeus_tpu import configuration as jconf
from linnaeus_tpu.configuration import archs as jarchs
from linnaeus_tpu.configuration import utils as jutils
from linnaeus_tpu.utils import meta as jmeta
from linnaeus_tpu_torch import configuration as tconf
from linnaeus_tpu_torch.configuration import archs as tarchs
from linnaeus_tpu_torch.configuration import utils as tutils
from linnaeus_tpu_torch.utils import meta as tmeta

REPO = Path(__file__).resolve().parents[1]
YAMLS = sorted((REPO / "configs").rglob("*.yaml"))


@pytest.fixture
def at_repo_root(monkeypatch):
    monkeypatch.chdir(REPO)
    monkeypatch.setenv("CONFIG_DIR", str(REPO))


def _outcome(fn, *args):
    """("ok", to_dict()) or ("raise", type name, message)."""
    try:
        return ("ok", fn(*args).to_dict())
    except Exception as e:  # noqa: BLE001 the comparison is the point
        return ("raise", type(e).__name__, str(e))


def test_every_yaml_is_found():
    names = {p.relative_to(REPO).as_posix() for p in YAMLS}
    assert "configs/model/archs/mFormerV1_sm.yaml" in names
    assert "configs/experiments/example_experiment.yaml" in names
    assert len(YAMLS) >= 14


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: p.relative_to(REPO).as_posix())
def test_yaml_loads_alike(at_repo_root, path):
    rel = path.relative_to(REPO).as_posix()
    for name in ("load_config", "build_config"):
        theirs = _outcome(getattr(jutils, name), rel)
        ours = _outcome(getattr(tutils, name), rel)
        assert ours == theirs, f"{name}({rel})"
    # an absolute path needs no $CONFIG_DIR
    assert _outcome(tutils.build_config, str(path)) == _outcome(jutils.build_config, str(path))


def test_yaml_with_opts_and_unset_config_dir(monkeypatch):
    monkeypatch.delenv("CONFIG_DIR", raising=False)
    rel = "configs/experiments/example_experiment.yaml"
    # relative paths need $CONFIG_DIR: both raise alike
    assert _outcome(tutils.build_config, rel) == _outcome(jutils.build_config, rel)
    assert _outcome(tutils.build_config, rel)[0] == "raise"
    opts = ["MODEL.IMG_SIZE", "224", "TRAIN.EPOCHS", 7, "MODEL.USE_FLASH_ATTN", "True"]
    monkeypatch.setenv("CONFIG_DIR", str(REPO))
    theirs = jutils.build_config(rel, opts)
    ours = tutils.build_config(rel, opts)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.MODEL.IMG_SIZE == 224 and ours.MODEL.USE_FLASH_ATTN is True


def test_default_config_matches():
    ours, theirs = tconf.get_default_config(), jconf.get_default_config()
    assert ours.to_dict() == theirs.to_dict()
    assert tconf.get_config().to_dict() == jconf.get_config().to_dict()
    assert ours.dump() == theirs.dump()


@pytest.mark.parametrize("name", sorted(jarchs.MFORMER_V1_ARCHS) + sorted(jarchs.MFORMER_V0_ARCHS))
def test_apply_arch_matches(name):
    ours = tarchs.apply_arch(tconf.get_default_config(), name)
    theirs = jarchs.apply_arch(jconf.get_default_config(), name)
    assert ours.to_dict() == theirs.to_dict()
    frozen_ours, frozen_theirs = tconf.get_default_config(), jconf.get_default_config()
    frozen_ours.freeze()
    frozen_theirs.freeze()
    tarchs.apply_arch(frozen_ours, name)
    jarchs.apply_arch(frozen_theirs, name)
    assert frozen_ours.is_frozen() and frozen_ours.to_dict() == frozen_theirs.to_dict()


def test_presets_are_the_same_tables():
    for key in ("mFormerV1_sm", "mFormerV1_md", "mFormerV1_lg", "mFormerV1_xl"):
        assert tarchs.MFORMER_V1_ARCHS[key] == jarchs.MFORMER_V1_ARCHS[key]
    assert tarchs.MFORMER_V0_ARCHS == jarchs.MFORMER_V0_ARCHS
    with pytest.raises(ValueError, match="Unknown arch"):
        tarchs.apply_arch(tconf.get_default_config(), "mFormerV9")


def _pair(data):
    return tconf.CN(data, new_allowed=True), jconf.CN(data, new_allowed=True)


def test_merge_configs_matches():
    low = {"A": {"B": 1, "C": [1, 2], "D": {"E": "x"}}, "F": 2.0}
    high = {"A": {"C": [3], "D": {"G": True}}, "H": None}
    (tl, jl), (th, jh) = _pair(low), _pair(high)
    ours, theirs = tconf.merge_configs(tl, th), jconf.merge_configs(jl, jh)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.A.D.E == "x" and ours.A.D.G is True and ours.A.C == [3]
    assert tl.to_dict() == low  # the inputs are left as they were


@pytest.mark.parametrize("key, value", [
    ("MODEL.IMG_SIZE", "224"),          # str literal -> int
    ("MODEL.DROP_PATH_RATE", 1),        # int -> float
    ("MODEL.IMG_SIZE", 3.0),            # float -> int
    ("MODEL.USE_FLASH_ATTN", "true"),   # str -> bool
    ("MODEL.USE_FLASH_ATTN", "no"),
    ("MODEL.USE_FLASH_ATTN", "1"),
    ("DATA.TASK_KEYS_H5", "('taxa_L10',)"),  # tuple -> list
    ("MODEL.NAME", "[1, 2]"),           # list into a str: a type mismatch
    ("MODEL.FUSED_CONVNEXT_MLP", "off"),
    ("MODEL.NOT_A_KEY", 1),             # unknown key
    ("NOPE.IMG_SIZE", 1),
    ("MODEL.PRETRAINED", "None"),
])
def test_merge_from_list_coercion_matches(key, value):
    ours, theirs = tconf.get_default_config(), jconf.get_default_config()

    def merge(cfg):
        cfg.merge_from_list([key, value])
        return cfg

    assert _outcome(merge, ours) == _outcome(merge, theirs)


def test_merge_from_list_odd_length_and_frozen():
    for conf in (tconf, jconf):
        cfg = conf.get_default_config()
        with pytest.raises(ValueError, match="odd length"):
            cfg.merge_from_list(["MODEL.IMG_SIZE"])
        cfg.freeze()
        with pytest.raises(AttributeError, match="frozen"):
            cfg.MODEL.IMG_SIZE = 1
        clone = cfg.clone()
        assert not clone.is_frozen() and cfg.is_frozen()


@pytest.mark.parametrize("components", [
    {},  # the defaults: TEMPORAL and SPATIAL
    {"ELEVATION": {"ENABLED": True}},
    {"TEMPORAL": {"ENABLED": False}, "ELEVATION": {"ENABLED": True, "IDX": 0},
     "SPATIAL": {"IDX": 3}},
    {"EXTRA": {"ENABLED": True, "IDX": 1, "DIM": 4}, "SPATIAL": {"IDX": 5}},
    {"EXTRA": {"ENABLED": True, "IDX": -1, "DIM": 4}},
])
def test_meta_components_match(components):
    ours, theirs = tconf.get_default_config(), jconf.get_default_config()
    for cfg in (ours, theirs):
        cfg.merge_from_other_cfg({"DATA": {"META": {"COMPONENTS": components}}})
    for name in ("get_enabled_meta_components", "compute_meta_chunk_bounds",
                 "compute_meta_chunk_bounds_by_name", "total_meta_dim"):
        assert getattr(tmeta, name)(ours) == getattr(jmeta, name)(theirs), name
    ours.DATA.META.ACTIVE = theirs.DATA.META.ACTIVE = False
    assert tmeta.get_enabled_meta_components(ours) == jmeta.get_enabled_meta_components(theirs) == []


def test_update_out_features_and_save_config(tmp_path):
    ours, theirs = tconf.get_default_config(), jconf.get_default_config()
    heads = {t: {"TYPE": "Linear"} for t in ours.DATA.TASK_KEYS_H5}
    counts = {t: 10 * (i + 1) for i, t in enumerate(ours.DATA.TASK_KEYS_H5)}
    for cfg in (ours, theirs):
        cfg.set_new_allowed(True)
        cfg.merge_from_other_cfg({"MODEL": {"CLASSIFICATION": {"HEADS": heads}}})
    tutils.update_out_features(ours, counts)
    jutils.update_out_features(theirs, counts)
    assert ours.to_dict() == theirs.to_dict() and ours.is_frozen()
    tconf.save_config(ours, str(tmp_path / "a" / "ours.yaml"))
    jconf.save_config(theirs, str(tmp_path / "a" / "theirs.yaml"))
    assert (tmp_path / "a" / "ours.yaml").read_text() == (tmp_path / "a" / "theirs.yaml").read_text()
