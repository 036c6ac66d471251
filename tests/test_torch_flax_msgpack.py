"""The port's Flax msgpack reader against ``flax.serialization``.

``utils/flax_msgpack.py`` reads ``to_bytes`` output with the ``msgpack``
package alone. Held here against Flax's own writer: a tiny mFormerV1's
variables leaf by leaf, arrays that Flax splits into chunks past
``MAX_CHUNK_SIZE`` (patched small), numpy scalars, complex numbers and
bfloat16 arrays; the result feeds ``state_dict_from_jax`` and a
``batch_stats`` collection raises.
"""

import functools

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import linnaeus_tpu.ops.fused_mlp as jfm
from linnaeus_tpu.models import MFormerV1 as JMFormerV1
from linnaeus_tpu_torch.models.build import build_model
from linnaeus_tpu_torch.utils import flax_msgpack
from linnaeus_tpu_torch.utils.convert import state_dict_from_jax

TASKS = ("taxa_L10", "taxa_L20")
NC = {"taxa_L10": 7, "taxa_L20": 3}
META = (("TEMPORAL", 2), ("SPATIAL", 3))
SPEC = {
    "CONVNEXT": {"DEPTHS": [1, 1, 1, 1], "DIMS": [8, 16, 32, 64]},
    "ROPE": {"DEPTHS": [1, 1], "DIMS": [32, 64], "NUM_HEADS": [2, 2]},
    "DROP_PATH_RATE": 0.0,
}


@pytest.fixture(scope="module")
def variables():
    model = JMFormerV1(
        img_size=(64, 64), convnext_depths=(1, 1, 1, 1), convnext_dims=(8, 16, 32, 64),
        rope_depths=(1, 1), rope_dims=(32, 64), rope_num_heads=(2, 2), drop_path_rate=0.0,
        meta_components=META, task_keys=TASKS, num_classes=NC,
        head_configs={t: {"TYPE": "Linear"} for t in TASKS})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfm.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        return model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 5)))


def _assert_same_tree(ours, theirs, path=""):
    if isinstance(theirs, dict):
        assert isinstance(ours, dict) and sorted(ours) == sorted(theirs), path
        for k in theirs:
            _assert_same_tree(ours[k], theirs[k], f"{path}/{k}")
    else:
        theirs = np.asarray(theirs)
        ours = np.asarray(ours)
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, path
        np.testing.assert_array_equal(ours, theirs, err_msg=path)


def test_model_variables_leaf_by_leaf(variables, tmp_path):
    (tmp_path / "weights.msgpack").write_bytes(fser.to_bytes(variables))
    ours = flax_msgpack.load(tmp_path / "weights.msgpack")
    _assert_same_tree(ours, jax.tree.map(np.asarray, fser.to_state_dict(variables)))
    params = flax_msgpack.read_params(tmp_path / "weights.msgpack")
    state = state_dict_from_jax(params, (1, 1), (1, 1), ("TEMPORAL", "SPATIAL"), TASKS)
    model = build_model(SPEC, 64, NC, META, device="cpu")
    model.load_state_dict(state, strict=True)
    want = state_dict_from_jax(jax.tree.map(np.asarray, variables["params"]), (1, 1), (1, 1),
                               ("TEMPORAL", "SPATIAL"), TASKS)
    for key, value in want.items():
        assert torch.equal(model.state_dict()[key], value), key


@pytest.mark.parametrize("chunk_bytes", [64, 1000, 4096])
def test_chunked_arrays_reassemble(variables, monkeypatch, chunk_bytes):
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", chunk_bytes)
    encoded = fser.to_bytes(variables)
    assert b"__msgpack_chunked_array__" in encoded
    _assert_same_tree(flax_msgpack.loads(encoded),
                      jax.tree.map(np.asarray, fser.to_state_dict(variables)))
    # a chunked array as the whole tree, and one of odd size
    odd = np.arange(1001, dtype=np.float32).reshape(7, 11, 13)
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 100)
    np.testing.assert_array_equal(flax_msgpack.loads(fser.msgpack_serialize(odd)), odd)
    np.testing.assert_array_equal(
        flax_msgpack.loads(fser.msgpack_serialize({"a": {"b": odd}}))["a"]["b"], odd)


def test_scalars_complex_and_dtypes():
    tree = {
        "f32": np.float32(1.5), "i64": np.int64(-3), "c": complex(1.0, -2.0),
        "bf16": jnp.asarray([[1.0, -2.5], [3.25, 1e-3]], jnp.bfloat16),
        "u8": np.arange(6, dtype=np.uint8).reshape(2, 3), "f16": np.ones(3, np.float16),
        "nested": {"py": 3, "s": "text", "empty": {}},
    }
    ours = flax_msgpack.loads(fser.msgpack_serialize(tree))
    theirs = fser.msgpack_restore(fser.msgpack_serialize(tree))
    assert ours["f32"] == theirs["f32"] and ours["f32"].dtype == np.float32
    assert ours["i64"] == -3 and ours["i64"].dtype == np.int64
    assert ours["c"] == complex(1.0, -2.0)
    # bfloat16 widens to float32 exactly
    np.testing.assert_array_equal(ours["bf16"], np.asarray(theirs["bf16"], np.float32))
    assert ours["bf16"].dtype == np.float32
    for k in ("u8", "f16"):
        np.testing.assert_array_equal(ours[k], theirs[k])
        assert ours[k].dtype == theirs[k].dtype
    assert ours["nested"] == {"py": 3, "s": "text", "empty": {}}


def test_batch_stats_and_missing_params_raise(variables, tmp_path):
    """A ``batch_stats`` collection (mFormerV0's running statistics) is read
    beside ``params`` (it raised before the port had BatchNorm); a file
    without ``params`` still raises."""
    with_bn = {"params": variables["params"], "batch_stats": {"bn": {"mean": np.zeros(3)}},
               "other": {"x": np.ones(2)}}
    (tmp_path / "bn.msgpack").write_bytes(fser.to_bytes(with_bn))
    read = flax_msgpack.read_variables(tmp_path / "bn.msgpack")
    assert sorted(read) == ["batch_stats", "params"]
    np.testing.assert_array_equal(read["batch_stats"]["bn"]["mean"], np.zeros(3))
    assert flax_msgpack.read_params(tmp_path / "bn.msgpack").keys() == variables["params"].keys()
    (tmp_path / "none.msgpack").write_bytes(fser.to_bytes({"other": {"x": np.zeros(2)}}))
    with pytest.raises(ValueError, match="params"):
        flax_msgpack.read_params(tmp_path / "none.msgpack")


def test_mformer_v0_variables_with_batch_stats_load_leaf_by_leaf(tmp_path):
    """An mFormerV0's ``weights.msgpack`` (``params`` and ``batch_stats``,
    the JAX package's bundle format) loads into the port's model: every
    parameter and running statistic equal to the file's, the statistics in
    the BatchNorms' buffers. The handler's logits on such a bundle against
    the JAX handler's: tests/test_torch_bundle.py."""
    from linnaeus_tpu.models import MFormerV0 as JMFormerV0
    from linnaeus_tpu_torch.inference.model_utils import load_weights
    from linnaeus_tpu_torch.models.mformer_v0 import MFormerV0
    from linnaeus_tpu_torch.utils.convert import state_dict_from_variables

    kw = dict(img_size=(32, 32), stage_dims=(8, 12, 24, 32, 64), mbconv_depths=(1, 1),
              attn_depths=(1, 1), num_heads=(2, 2), meta_components=META, task_keys=TASKS,
              num_classes=NC)
    jmodel = JMFormerV0(**kw, head_configs={t: {"TYPE": "Linear"} for t in TASKS})
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                     jnp.zeros((1, 5)))
    variables = {"params": variables["params"], "batch_stats": jax.tree.map(
        lambda a: a + 0.25, variables["batch_stats"])}
    (tmp_path / "weights.msgpack").write_bytes(fser.to_bytes(variables))
    read = flax_msgpack.read_variables(tmp_path / "weights.msgpack")
    _assert_same_tree(read, jax.tree.map(np.asarray, fser.to_state_dict(variables)))
    model = MFormerV0(**kw)
    load_weights(model, str(tmp_path / "weights.msgpack"))
    want = state_dict_from_variables(model, jax.tree.map(np.asarray, variables))
    assert model.state_dict().keys() == want.keys()
    for key, value in want.items():
        assert torch.equal(model.state_dict()[key], value), key
    assert float(model.bn1.running_var[0]) == 1.25
