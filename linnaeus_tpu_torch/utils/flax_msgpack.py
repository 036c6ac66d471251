"""Read a Flax ``weights.msgpack`` without JAX or Flax.

The JAX package's bundles hold their weights as
``flax.serialization.to_bytes(variables)`` (read back with ``from_bytes``
at linnaeus_tpu/inference/model_utils.py). That is a msgpack map of nested
maps whose leaves use three extension types:

* 1, an ndarray: a msgpack array (shape, dtype name, C-order buffer);
* 2, a Python complex: a msgpack array (real, imag);
* 3, a numpy scalar, encoded as a 0-d ndarray.

Arrays larger than Flax's ``MAX_CHUNK_SIZE`` (2**30 bytes) are written as
``{"__msgpack_chunked_array__": True, "shape": {"0": ..}, "chunks": {"0":
flat array, "1": ..}}``, reassembled here. Only the ``msgpack`` package is
needed. :func:`read_params` gives the ``params`` collection as nested dicts
of numpy arrays, the input of ``utils/convert.py::state_dict_from_jax``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np

_NDARRAY, _COMPLEX, _NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


def _ndarray(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":  # not a numpy dtype: widen the bits to float32
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _NDARRAY:
        return _ndarray(data)
    if code == _COMPLEX:
        real, imag = msgpack.unpackb(data)
        return complex(real, imag)
    if code == _NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"unknown msgpack extension type {code} in a Flax state file")


def _unchunk(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    if _CHUNKED in node:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def loads(encoded: bytes) -> dict[str, Any]:
    """Flax ``msgpack_serialize`` / ``to_bytes`` output -> nested dicts of
    numpy arrays (read-only views of ``encoded``'s buffers)."""
    import msgpack

    return _unchunk(msgpack.unpackb(encoded, ext_hook=_ext_hook, raw=False))


def load(path: str | Path) -> dict[str, Any]:
    return loads(Path(path).read_bytes())


def read_params(path: str | Path) -> dict[str, Any]:
    """The ``params`` collection of a Flax variables file. A
    ``batch_stats`` collection raises: it belongs to mFormerV0's BatchNorm,
    which is not ported yet (M8)."""
    variables = load(path)
    if "batch_stats" in variables:
        raise NotImplementedError(
            f"{path}: a 'batch_stats' collection (BatchNorm running statistics, mFormerV0) "
            "is not ported yet")
    if "params" not in variables:
        raise ValueError(f"{path}: no 'params' collection (found {sorted(variables)})")
    return variables["params"]
