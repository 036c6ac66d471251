"""The weight bridge: a TPU-package mFormerV1 param tree -> this port's
state_dict.

Port of the mapping in linnaeus_tpu/utils/pretrained.py
(``_reference_v1_entries`` walked by ``export_reference_mformer_v1``),
written without jax: the Flax params come in as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)``), and the layouts convert as
  conv HWIO -> OIHW (depthwise (7, 7, 1, C) -> (C, 1, 7, 7)),
  Dense (in, out) -> Linear (out, in),
  aggregate Dense (2, 1) -> Conv1d (1, 2, 1),
  Conv1d-head kernel (k, in, out) -> (out, in, k).
The result loads into :class:`linnaeus_tpu_torch.models.mformer_v1.MFormerV1`
with ``strict=True``.

The map only renames and transposes, so ``state_dict_from_jax`` carries any
tree shaped like the params just as well, a JAX gradient tree for one, and
:func:`adamw_moments_from_optax` applies it to the first and second moments
of an optax AdamW state, so a test can compare gradients and one optimizer
update parameter by parameter. :func:`convnext_block_args_from_jax` does the
same for the argument tuple of one fused ConvNeXt block (K3).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch


def _conv(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (3, 2, 0, 1))  # HWIO -> OIHW


def _dense(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (1, 0))


def _aggregate(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (1, 0))[:, :, None]  # (2, 1) -> (1, 2, 1)


def _conv1d(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (2, 1, 0))  # (k, in, out) -> (out, in, k)


Entry = tuple[str, tuple[str, ...], Callable[[np.ndarray], np.ndarray] | None]


def _linear(dst: str, src: tuple[str, ...]) -> list[Entry]:
    return [(f"{dst}.weight", src + ("kernel",), _dense), (f"{dst}.bias", src + ("bias",), None)]


def _norm(dst: str, src: tuple[str, ...]) -> list[Entry]:
    return [(f"{dst}.weight", src + ("scale",), None), (f"{dst}.bias", src + ("bias",), None)]


def _conv2d(dst: str, src: tuple[str, ...]) -> list[Entry]:
    return [(f"{dst}.weight", src + ("kernel",), _conv), (f"{dst}.bias", src + ("bias",), None)]


def _entries(
    params: Mapping[str, Any],
    convnext_depths: tuple[int, ...],
    rope_depths: tuple[int, int],
    meta_names: tuple[str, ...],
    task_keys: tuple[str, ...],
) -> list[Entry]:
    out = _conv2d("stem.0", ("stem", "Conv_0")) + _norm("stem.1", ("stem", "LayerNorm_0"))
    for s, name in ((0, "stage1"), (1, "stage2")):
        for j in range(convnext_depths[s]):
            dst, src = f"stages.{s}.{j}", f"{name}_block{j}"
            out += _conv2d(f"{dst}.dwconv", (src, "Conv_0"))
            out += _norm(f"{dst}.norm", (src, "LayerNorm_0"))
            out += _linear(f"{dst}.pwconv1", (src, "Dense_0"))
            out += _linear(f"{dst}.pwconv2", (src, "Dense_1"))
            if "gamma" in params[src]:
                out.append((f"{dst}.gamma", (src, "gamma"), None))
    for t in range(3):
        src = f"downsample{t + 1}"
        out += _norm(f"downsample_layers.{t}.norm", (src, "LayerNorm_0"))
        out += _conv2d(f"downsample_layers.{t}.conv", (src, "Conv_0"))
    for s, name, depth in ((2, "stage3", rope_depths[0]), (3, "stage4", rope_depths[1])):
        for j in range(depth):
            dst, src = f"stages.{s}.{j}", f"{name}_block{j}"
            out += _norm(f"{dst}.norm1", (src, "norm1"))
            out += _linear(f"{dst}.attn.qkv", (src, "attn", "qkv"))
            out += _linear(f"{dst}.attn.proj", (src, "attn", "proj"))
            if "freqs" in params[src]["attn"]:
                out.append((f"{dst}.attn.freqs", (src, "attn", "freqs"), None))
            out += _norm(f"{dst}.norm2", (src, "norm2"))
            out += _linear(f"{dst}.mlp.fc1", (src, "mlp", "Dense_0"))
            out += _linear(f"{dst}.mlp.fc2", (src, "mlp", "Dense_1"))
    out += _norm("norm_1", ("norm_1",)) + _norm("norm_2", ("norm_2",))
    out += [("cls_token_1", ("cls_token_1",), None), ("cls_token_2", ("cls_token_2",), None)]
    if "cl_1_fc" in params:
        out += _linear("cl_1_fc.0.fc1", ("cl_1_fc", "Dense_0"))
        out += _linear("cl_1_fc.0.fc2", ("cl_1_fc", "Dense_1"))
        out += _norm("cl_1_fc.1", ("cl_1_norm",))
        out += [
            ("aggregate.weight", ("aggregate", "kernel"), _aggregate),
            ("aggregate.bias", ("aggregate", "bias"), None),
        ]
    out += _norm("final_norm", ("final_norm",))
    for s in (1, 2):
        for name in meta_names:
            head = f"meta_{name.lower()}_head_{s}"
            if head not in params:  # a zero-width component has no head
                continue
            out += _linear(f"{head}.0", (head, "Dense_0"))
            out += _norm(f"{head}.2", (head, "LayerNorm_0"))
            out += _linear(f"{head}.3.w1", (head, "ResNormLayer_0", "Dense_0"))
            out += _norm(f"{head}.3.norm_fn1", (head, "ResNormLayer_0", "LayerNorm_0"))
            out += _linear(f"{head}.3.w2", (head, "ResNormLayer_0", "Dense_1"))
            out += _norm(f"{head}.3.norm_fn2", (head, "ResNormLayer_0", "LayerNorm_1"))
    for task in task_keys:
        src = ("head", f"head_{task}")
        if "Conv_0" in params["head"][f"head_{task}"]:
            out += [
                (f"head.{task}.fc.weight", src + ("Conv_0", "kernel"), _conv1d),
                (f"head.{task}.fc.bias", src + ("Conv_0", "bias"), None),
            ]
        else:
            out += _linear(f"head.{task}.fc", src + ("Dense_0",))
    return out


def state_dict_from_jax(
    params: Mapping[str, Any],
    convnext_depths: tuple[int, ...],
    rope_depths: tuple[int, int],
    meta_names: tuple[str, ...] = (),
    task_keys: tuple[str, ...] = (),
) -> dict[str, torch.Tensor]:
    """Map a Flax mFormerV1 ``params`` tree (nested dicts of arrays), or any
    tree of its shape such as its gradients, onto the port's state_dict
    keys, converting layouts; every listed leaf must exist (a missing one
    raises KeyError)."""
    state: dict[str, torch.Tensor] = {}
    for key, path, convert in _entries(
        params, convnext_depths, rope_depths, tuple(meta_names), tuple(task_keys)
    ):
        node = params
        for part in path:
            node = node[part]
        value = np.asarray(node)
        if convert is not None:
            value = convert(value)
        state[key] = torch.tensor(value, dtype=torch.float32)
    return state


def adamw_moments_from_optax(
    opt_state: Any,
    convnext_depths: tuple[int, ...],
    rope_depths: tuple[int, int],
    meta_names: tuple[str, ...] = (),
    task_keys: tuple[str, ...] = (),
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor], int]:
    """(exp_avg, exp_avg_sq, count) of an optax AdamW state by the port's
    parameter names: the ``mu`` and ``nu`` trees and the step count of the
    ``ScaleByAdamState`` found in ``opt_state`` (a nested tuple of states,
    with the trees already brought to numpy)."""

    def find(node):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            return node
        if isinstance(node, (tuple, list)):
            for child in node:
                found = find(child)
                if found is not None:
                    return found
        return None

    adam = find(opt_state)
    if adam is None:
        raise ValueError("no state with mu and nu trees in this optax state")
    args = (convnext_depths, rope_depths, meta_names, task_keys)
    return (state_dict_from_jax(adam.mu, *args), state_dict_from_jax(adam.nu, *args),
            int(np.asarray(adam.count)))


def convnext_block_args_from_jax(
    x: np.ndarray,
    dw_kernel: np.ndarray,
    dw_bias: np.ndarray,
    ln_scale: np.ndarray,
    ln_bias: np.ndarray,
    w1: np.ndarray,
    b1: np.ndarray,
    w2: np.ndarray,
    b2: np.ndarray,
    gamma: np.ndarray,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, ...]:
    """The TPU package's ``fused_convnext_block`` arguments, as numpy arrays,
    in the layouts of :func:`linnaeus_tpu_torch.ops.fused_dwconv_mlp.fused_convnext_block`:
    the depthwise taps (7, 7, C) or HWIO (7, 7, 1, C) -> (C, 1, 7, 7), the
    Dense kernels (C, 4C) and (4C, C) -> Linear weights (4C, C) and (C, 4C).
    x and the two weights come back in ``dtype``, the taps and the vectors
    in float32."""
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    C = np.shape(x)[-1]
    taps = torch.tensor(_conv(f32(dw_kernel).reshape(7, 7, 1, C)))
    vectors = [torch.tensor(f32(a)) for a in (dw_bias, ln_scale, ln_bias, b1, b2, gamma)]
    kb, ls, lb, b1t, b2t, g = vectors
    cast = lambda a: torch.tensor(a).to(dtype)  # noqa: E731
    return (cast(f32(x)), taps, kb, ls, lb, cast(_dense(f32(w1))).contiguous(), b1t,
            cast(_dense(f32(w2))).contiguous(), b2t, g)
