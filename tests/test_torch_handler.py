"""The port's inference handler against the TPU package's on one bundle.

Both handlers serve the tiny mFormerV1 of tests/bundle_utils.py in fp32 on
the same weights (bridged with ``state_dict_from_jax``), once with the
hierarchical-consistency pass off on both sides and once with the port's
default options (the pass on, against the bundle's taxonomy tree). Top-k
class ids must agree and probabilities to 1e-5.
"""

import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from linnaeus_tpu.inference import InferenceRequestMetadata as JOpts
from linnaeus_tpu.inference import LinnaeusInferenceHandler as JHandler
from linnaeus_tpu.inference import preprocessing as jpre
from linnaeus_tpu_torch.inference import preprocessing as tpre
from linnaeus_tpu_torch.inference.artifacts import (
    load_class_index_maps_artifact,
    load_taxonomy_tree_artifact,
)
from linnaeus_tpu_torch.inference.config import InferenceOptionsConfig, load_inference_config
from linnaeus_tpu_torch.inference.handler import LinnaeusInferenceHandler
from linnaeus_tpu_torch.inference.model_utils import build_model_for_inference
from linnaeus_tpu_torch.inference.schemas import InferenceRequestMetadata
from linnaeus_tpu_torch.utils.convert import state_dict_from_jax

TASKS = ["taxa_L10", "taxa_L20"]
TINY = {
    "CONVNEXT": {"DEPTHS": [1, 1, 1, 1], "DIMS": [8, 16, 32, 64]},
    "ROPE": {"DEPTHS": [1, 1], "DIMS": [32, 64], "NUM_HEADS": [2, 2]},
    "DROP_PATH_RATE": 0.0,
}
REPO = Path(__file__).resolve().parents[1]


def _pair(bundle, check: bool):
    """(JAX handler, port handler) on the bundle's weights. ``check`` False:
    the bundle's options with the hierarchical-consistency pass off on both
    sides. True: the port's handler gets ``InferenceOptionsConfig()``, every
    option its default (the pass on), and the JAX handler the same top-k
    and batch size with the pass on."""
    defaults = InferenceOptionsConfig()
    loaded = JHandler.load_from_artifacts(bundle / "config.yaml")
    jcfg = loaded.config.model_copy(deep=True)
    jcfg.inference_options.enable_hierarchical_consistency_check = check
    jcfg.inference_options.data_parallel = 1
    if check:
        jcfg.inference_options.default_top_k = defaults.default_top_k
        jcfg.inference_options.batch_size = defaults.batch_size
    jax_handler = JHandler(
        jcfg, loaded.model.clone(dtype=jnp.float32), loaded.variables,
        loaded.taxonomy, loaded.class_maps,
    )

    cfg = load_inference_config(bundle / "config.yaml")
    if check:
        cfg.inference_options = defaults
    else:
        cfg.inference_options.enable_hierarchical_consistency_check = False
    model = build_model_for_inference(cfg, arch=TINY, device="cpu")
    params = jax.tree.map(np.asarray, loaded.variables["params"])
    model.load_state_dict(
        state_dict_from_jax(params, (1, 1, 1, 1), (1, 1),
                            ("TEMPORAL", "SPATIAL", "ELEVATION"), tuple(TASKS)),
        strict=True,
    )
    m, tax = cfg.model, cfg.taxonomy_data
    class_maps = load_class_index_maps_artifact(
        bundle / "class_map.json", m.model_task_keys_ordered,
        m.num_classes_per_task, m.null_class_indices,
    )
    taxonomy = load_taxonomy_tree_artifact(
        bundle / tax.taxonomy_tree_path, tax.source_name, tax.version, tax.root_identifier)
    return jax_handler, LinnaeusInferenceHandler(cfg, model, taxonomy, class_maps)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    from tests.bundle_utils import make_test_bundle

    return make_test_bundle(tmp_path_factory.mktemp("bundle"))


@pytest.fixture(scope="module")
def handlers(bundle):
    return _pair(bundle, check=False)


@pytest.fixture(scope="module")
def default_handlers(bundle):
    return _pair(bundle, check=True)


def _requests(n, seed):
    rng = np.random.default_rng(seed)
    images = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8) for _ in range(n)]
    metas = [
        {"lat": 40.0, "lon": -105.0, "datetime": "2024-06-15T12:00:00", "elevation_m": 1600.0},
        None,
        {"lat": -10.0, "lon": 30.0},
    ]
    return images, [metas[i % 3] for i in range(n)]


@pytest.mark.parametrize("n", [1, 3, 5])  # buckets 1 and 4; 5 spans two chunks
def test_predictions_match_jax_handler(handlers, n):
    jax_handler, handler = handlers
    images, metas = _requests(n, seed=n)
    ours = handler.predict(images, metas, InferenceRequestMetadata(top_k=5))
    theirs = jax_handler.predict(images, metas, JOpts(top_k=5))
    assert len(ours) == len(theirs) == n
    for a, b in zip(ours, theirs):
        assert [t.task_key for t in a.tasks] == TASKS
        for ta, tb in zip(a.tasks, b.tasks):
            assert ta.rank_level == tb.rank_level
            assert [tid for tid, _ in ta.predictions] == [tid for tid, _ in tb.predictions]
            np.testing.assert_allclose(
                [p for _, p in ta.predictions], [p for _, p in tb.predictions], atol=1e-5)


def test_buckets_topk_padding_and_info(handlers):
    _, handler = handlers
    assert [handler._bucket(n) for n in range(1, 6)] == [1, 2, 4, 4, 4]
    assert handler.warmup() == 3
    # k=6 > 3 classes of taxa_L20: that task pads, the result keeps 3
    res = handler.predict([np.zeros((32, 32, 3), np.uint8)], None,
                          InferenceRequestMetadata(top_k=6))[0]
    assert [len(t.predictions) for t in res.tasks] == [5, 3]
    probs = [p for _, p in res.tasks[0].predictions]
    assert probs == sorted(probs, reverse=True) and 0.99 < sum(probs) < 1.01
    assert {tid for t in res.tasks for tid, _ in t.predictions} <= {
        0, 5001, 5002, 5003, 5004, 61, 62}
    info = handler.info()
    assert info.task_keys == TASKS and info.num_classes_per_task == [5, 3]


def test_preprocessing_matches_jax(handlers):
    jax_handler, handler = handlers
    rng = np.random.default_rng(5)
    u8 = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    hot = u8.astype(np.int32)
    hot[5, 5, 0] = 300
    mask = np.zeros((32, 32, 3), bool)
    mask[8:24, 8:24] = True
    for image in (u8, u8.astype(np.float32) / 255.0, u8.astype(np.uint16) * 257,
                  hot, mask, u8.tolist(), rng.integers(0, 256, (40, 48, 3), np.uint8)):
        np.testing.assert_array_equal(
            tpre.preprocess_image_u8(image, handler.config),
            jpre.preprocess_image_u8(image, jax_handler.config),
        )
    for meta in _requests(3, seed=0)[1] + [{"latitude": 1.0, "longitude": 2.0, "elevation": 5.0}]:
        np.testing.assert_array_equal(
            tpre.preprocess_metadata(meta, handler.config),
            jpre.preprocess_metadata(meta, jax_handler.config),
        )


def _assert_same_results(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.taxonomy_context == dict(b.taxonomy_context)
        assert [t.task_key for t in a.tasks] == TASKS
        for ta, tb in zip(a.tasks, b.tasks):
            assert ta.rank_level == tb.rank_level
            assert [tid for tid, _ in ta.predictions] == [tid for tid, _ in tb.predictions]
            np.testing.assert_allclose(
                [p for _, p in ta.predictions], [p for _, p in tb.predictions], atol=1e-5)


@pytest.mark.parametrize("n", [1, 3, 5, 12])
def test_default_options_serve_and_match_jax_handler(default_handlers, n):
    """The port's handler with its default InferenceOptions: the
    consistency pass on, one device. Same taxa as the JAX handler with the
    pass on, probabilities to 1e-5, and every result obeys the tree."""
    jax_handler, handler = default_handlers
    opts = handler.config.inference_options
    assert opts == InferenceOptionsConfig()
    assert opts.enable_hierarchical_consistency_check and opts.data_parallel == "auto"
    images, metas = _requests(n, seed=20 + n)
    ours = handler.predict(images, metas)
    _assert_same_results(ours, jax_handler.predict(images, metas))
    tree, maps = handler.taxonomy.taxonomy_tree, handler.class_maps
    for r in ours:
        fine, coarse = r.tasks  # taxa_L10 under taxa_L20
        top = {t.rank_level: t.predictions[0][0] for t in r.tasks}
        if top[20] == maps.null_taxon_ids[20]:
            assert fine.predictions == [(maps.null_taxon_ids[10], 1.0)]
        elif top[10] != maps.null_taxon_ids[10]:
            child = ("taxa_L10", maps.taxon_id_to_idx[10][top[10]])
            parent = ("taxa_L20", maps.taxon_id_to_idx[20][top[20]])
            assert tree.get_parent(child) in (None, parent)


def test_the_consistency_pass_changes_some_result(default_handlers, handlers):
    """On random weights some request has a finer top taxon outside its
    coarser one's children, so the pass is seen to act (and to be off in
    the other pair)."""
    _, checked = default_handlers
    _, raw = handlers
    images, metas = _requests(24, seed=7)
    a, b = checked.predict(images, metas), raw.predict(images, metas)
    changed = sum(ta.predictions != tb.predictions
                  for ra, rb in zip(a, b) for ta, tb in zip(ra.tasks, rb.tasks))
    assert changed > 0
    for ra, rb in zip(a, b):  # the coarsest rank is never touched
        assert ra.tasks[1].predictions == rb.tasks[1].predictions


@pytest.mark.parametrize("spec", [False, None, "off", 1, "1", "auto"])
def test_data_parallel_one_device_spellings_construct(handlers, spec):
    _, handler = handlers
    opts = replace(handler.config.inference_options, data_parallel=spec)
    built = LinnaeusInferenceHandler(
        replace(handler.config, inference_options=opts), handler.model, handler.taxonomy,
        handler.class_maps)
    assert built._dp == 1


def test_unported_serving_options_raise(handlers):
    """Several devices are not ported; the consistency pass without a tree
    raises by name."""
    _, handler = handlers
    opts = handler.config.inference_options
    for spec in (2, "2", 4):
        with pytest.raises(NotImplementedError, match="data_parallel"):
            LinnaeusInferenceHandler(
                replace(handler.config, inference_options=replace(opts, data_parallel=spec)),
                handler.model, handler.taxonomy, handler.class_maps)
    checked = replace(handler.config, inference_options=replace(
        opts, enable_hierarchical_consistency_check=True))
    with pytest.raises(ValueError, match="enable_hierarchical_consistency_check"):
        LinnaeusInferenceHandler(checked, handler.model, None, handler.class_maps)
    LinnaeusInferenceHandler(checked, handler.model, handler.taxonomy, handler.class_maps)
    # off, the handler needs no tree and quotes the config's taxonomy names
    bare = LinnaeusInferenceHandler(handler.config, handler.model, None, handler.class_maps)
    res = bare.predict([np.zeros((32, 32, 3), np.uint8)])[0]
    assert res.taxonomy_context["source"] == handler.config.taxonomy_data.source_name


def test_architecture_variant_config_path_raises_by_name(bundle):
    cfg = load_inference_config(bundle / "config.yaml")
    cfg.model.architecture_variant_config_path = "variants/wide.yaml"
    with pytest.raises(NotImplementedError, match="architecture_variant_config_path"):
        build_model_for_inference(cfg, arch=TINY, device="cpu")


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import linnaeus_tpu_torch.inference.handler, linnaeus_tpu_torch.inference.model_utils\n"
        "import linnaeus_tpu_torch.utils.convert\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'linnaeus_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_inference_build_defaults_to_the_card_and_honours_the_config_device(tmp_path):
    """``inference_options.device`` "auto" is the GPU and raises without one;
    "cpu" in the config, or as an argument, is honoured."""
    import torch

    from tests.bundle_utils import make_test_bundle

    cfg = load_inference_config(make_test_bundle(tmp_path) / "config.yaml")
    assert cfg.inference_options.device == "auto"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model_for_inference(cfg, arch=TINY)
    cfg.inference_options.device = "cpu"
    model = build_model_for_inference(cfg, arch=TINY)
    assert next(model.parameters()).device.type == "cpu"
