"""The weight bridge: a TPU-package mFormerV1 or mFormerV0 variable tree ->
this port's state_dict.

Port of the mapping in linnaeus_tpu/utils/pretrained.py
(``_reference_v1_entries`` walked by ``export_reference_mformer_v1``),
written without jax: the Flax params come in as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)``), and the layouts convert as
  conv HWIO -> OIHW (depthwise (7, 7, 1, C) -> (C, 1, 7, 7)),
  Dense (in, out) -> Linear (out, in),
  aggregate Dense (2, 1) -> Conv1d (1, 2, 1),
  Conv1d-head kernel (k, in, out) -> (out, in, k).
The result loads into :class:`linnaeus_tpu_torch.models.mformer_v1.MFormerV1`
with ``strict=True``. :func:`v0_state_dict_from_jax` does the same for an
mFormerV0 (MetaFG's key layout; the table of
linnaeus_tpu/utils/pretrained.py::load_metaformer_into_mformer_v0 run the
other way), with its ``batch_stats`` collection mapped onto the BatchNorms'
``running_mean`` / ``running_var`` buffers; :func:`load_jax_variables` puts a
whole ``{"params", "batch_stats"}`` tree into a live model of either kind.

The map only renames and transposes, so ``state_dict_from_jax`` carries any
tree shaped like the params just as well, a JAX gradient tree for one, and
:func:`adamw_moments_from_optax` applies it to the first and second moments
of an optax AdamW state, so a test can compare gradients and one optimizer
update parameter by parameter. :func:`convnext_block_args_from_jax` does the
same for the argument tuple of one fused ConvNeXt block (K3).

:func:`jax_layouts` runs the map the other way for a live torch model: each
parameter's Flax path and a view of it in the Flax layout, which is what
the parameter filters and Muon read (utils/param_filters.py, optim/muon.py).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple

import numpy as np
import torch
from torch import nn


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
        if "aggregate" in params:
            out += [
                ("aggregate.weight", ("aggregate", "kernel"), _aggregate),
                ("aggregate.bias", ("aggregate", "bias"), None),
            ]
        elif "Dense_0" in params.get("aggregate_alt", {}):  # a Concatenation aggregation
            out += _linear("aggregate_alt.fc", ("aggregate_alt", "Dense_0"))
    out += _norm("final_norm", ("final_norm",))
    return out + _meta_and_task_heads(params, meta_names, task_keys)


def _meta_and_task_heads(params: Mapping[str, Any], meta_names: tuple[str, ...],
                         task_keys: tuple[str, ...]) -> list[Entry]:
    out = []
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
        head = params["head"][f"head_{task}"]
        layer = "Conv_0" if "Conv_0" in head else "Dense_0"
        src = ("head", f"head_{task}", layer)
        out.append((f"head.{task}.fc.weight", src + ("kernel",),
                    _conv1d if layer == "Conv_0" else _dense))
        if "bias" in head[layer]:  # a head with USE_BIAS: False has none
            out.append((f"head.{task}.fc.bias", src + ("bias",), None))
    return out


def _conv_kernel(dst: str, src: tuple[str, ...]) -> list[Entry]:
    return [(f"{dst}.weight", src + ("kernel",), _conv)]


# (the port's stem index, the Flax module) of mFormerV0's stem
_V0_STEM_CONVS = (("stage_0.0", "stem_conv0"), ("stage_0.3", "stem_conv1"),
                  ("stage_0.6", "stem_conv2"))
_V0_STEM_BNS = (("stage_0.1", "stem_bn0"), ("stage_0.4", "stem_bn1"), ("bn1", "bn1"))
_MBCONV_BNS = (("_bn0", "bn0"), ("_bn1", "bn1"), ("_bn2", "bn2"))


def _v0_batchnorms(params: Mapping[str, Any], mbconv_depths: tuple[int, int]
                   ) -> list[tuple[str, tuple[str, ...]]]:
    """(port module, Flax path) of every BatchNorm of an mFormerV0."""
    out = [(dst, (src,)) for dst, src in _V0_STEM_BNS]
    for s, depth in ((1, mbconv_depths[0]), (2, mbconv_depths[1])):
        for j in range(depth):
            dst, src = f"stage_{s}.{j}", f"stage{s}_block{j}"
            out += [(f"{dst}.{d}", (src, b)) for d, b in _MBCONV_BNS if b in params[src]]
    return out


def _v0_entries(
    params: Mapping[str, Any],
    mbconv_depths: tuple[int, int],
    attn_depths: tuple[int, int],
    meta_names: tuple[str, ...],
    task_keys: tuple[str, ...],
) -> list[Entry]:
    """mFormerV0's parameters: MetaFG key <- Flax path."""
    out = []
    for dst, src in _V0_STEM_CONVS:
        out += _conv_kernel(dst, (src,))
    for dst, path in _v0_batchnorms(params, mbconv_depths):
        out += _norm(dst, path)
    for s, depth in ((1, mbconv_depths[0]), (2, mbconv_depths[1])):
        for j in range(depth):
            dst, src = f"stage_{s}.{j}", f"stage{s}_block{j}"
            if "expand_conv" in params[src]:
                out += _conv_kernel(f"{dst}._expand_conv", (src, "expand_conv"))
            out += _conv_kernel(f"{dst}._depthwise_conv", (src, "depthwise_conv"))
            if "se" in params[src]:
                out += _conv2d(f"{dst}._se_reduce", (src, "se", "reduce"))
                out += _conv2d(f"{dst}._se_expand", (src, "se", "expand"))
            out += _conv_kernel(f"{dst}._project_conv", (src, "project_conv"))
    for s, depth in ((3, attn_depths[0]), (4, attn_depths[1])):
        for j in range(depth):
            dst, src = f"stage_{s}.{j}", f"stage{s}_block{j}"
            if j == 0:
                out += _conv2d(f"{dst}.patch_embed.proj", (src, "patch_embed", "proj"))
                out += _norm(f"{dst}.patch_embed.norm", (src, "patch_embed", "LayerNorm_0"))
            out += _norm(f"{dst}.norm1", (src, "norm1"))
            out += _linear(f"{dst}.attn.qkv", (src, "attn", "qkv"))
            out += _linear(f"{dst}.attn.proj", (src, "attn", "proj"))
            out.append((f"{dst}.attn.relative_position_bias_table",
                        (src, "attn", "relative_position_bias_table"), None))
            out += _norm(f"{dst}.norm2", (src, "norm2"))
            out += _linear(f"{dst}.mlp.fc1", (src, "mlp", "Dense_0"))
            out += _linear(f"{dst}.mlp.fc2", (src, "mlp", "Dense_1"))
    out += _norm("norm_1", ("norm_1",)) + _norm("norm_2", ("norm_2",))
    out += [("cls_token_1", ("cls_token_1",), None), ("cls_token_2", ("cls_token_2",), None)]
    if "cl_1_fc" in params:
        out += _linear("cl_1_fc.0.fc1", ("cl_1_fc", "Dense_0"))
        out += _linear("cl_1_fc.0.fc2", ("cl_1_fc", "Dense_1"))
        out += _norm("cl_1_fc.1", ("cl_1_norm",))
        out += [("aggregate.weight", ("aggregate", "kernel"), _aggregate),
                ("aggregate.bias", ("aggregate", "bias"), None)]
    out += _norm("norm", ("final_norm",))
    return out + _meta_and_task_heads(params, meta_names, task_keys)


def _v0_stat_entries(params: Mapping[str, Any], mbconv_depths: tuple[int, int]) -> list[Entry]:
    """mFormerV0's BatchNorm buffers: MetaFG key <- ``batch_stats`` path."""
    out = []
    for dst, path in _v0_batchnorms(params, mbconv_depths):
        out += [(f"{dst}.running_mean", path + ("mean",), None),
                (f"{dst}.running_var", path + ("var",), None)]
    return out


def _gather(tree: Mapping[str, Any], entries: list[Entry]) -> dict[str, torch.Tensor]:
    state: dict[str, torch.Tensor] = {}
    for key, path, convert in entries:
        node = tree
        for part in path:
            node = node[part]
        value = np.asarray(node)
        if convert is not None:
            value = convert(value)
        state[key] = torch.tensor(value, dtype=torch.float32)
    return state


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
    return _gather(params, _entries(params, convnext_depths, rope_depths, tuple(meta_names),
                                    tuple(task_keys)))


def v0_state_dict_from_jax(
    params: Mapping[str, Any],
    mbconv_depths: tuple[int, int],
    attn_depths: tuple[int, int],
    meta_names: tuple[str, ...] = (),
    task_keys: tuple[str, ...] = (),
    batch_stats: Mapping[str, Any] | None = None,
) -> dict[str, torch.Tensor]:
    """A Flax mFormerV0 ``params`` tree (or any tree of its shape, such as
    its gradients) onto the port's MetaFG keys, and with ``batch_stats`` its
    ``mean`` / ``var`` onto the BatchNorms' ``running_mean`` /
    ``running_var``; every listed leaf must exist."""
    state = _gather(params, _v0_entries(params, mbconv_depths, attn_depths, tuple(meta_names),
                                        tuple(task_keys)))
    if batch_stats is not None:
        state.update(_gather(batch_stats, _v0_stat_entries(params, mbconv_depths)))
    return state


def _bridge_args(model: nn.Module) -> tuple[Callable, tuple]:
    """The bridge for ``model``'s kind and its arguments after the tree."""
    names = tuple(name for name, _ in model.meta_components)
    tasks = tuple(model.head.task_keys)
    if hasattr(model, "mbconv_depths"):  # mFormerV0
        return v0_state_dict_from_jax, (model.mbconv_depths, model.attn_depths, names, tasks)
    depths = tuple(len(stage) for stage in model.stages)
    return state_dict_from_jax, (depths[:2], depths[2:], names, tasks)


def state_dict_from_variables(model: nn.Module, variables: Mapping[str, Any]
                              ) -> dict[str, torch.Tensor]:
    """The JAX package's variables ``{"params": ..., "batch_stats": ...}``
    (nested dicts of numpy arrays; ``batch_stats`` only for mFormerV0) as a
    state_dict of ``model``, an MFormerV1 or MFormerV0 of the same geometry."""
    bridge, args = _bridge_args(model)
    if bridge is v0_state_dict_from_jax:
        if "batch_stats" not in variables:
            raise ValueError("an mFormerV0's variables need their 'batch_stats' collection "
                             "(the BatchNorms' running statistics)")
        return bridge(variables["params"], *args, batch_stats=variables["batch_stats"])
    if variables.get("batch_stats"):
        raise ValueError("'batch_stats' given for an mFormerV1, which has no BatchNorm")
    return bridge(variables["params"], *args)


def load_jax_variables(model: nn.Module, variables: Mapping[str, Any]) -> None:
    """Load the JAX package's ``{"params", "batch_stats"}`` into ``model``
    (strict: every parameter and running statistic is set)."""
    model.load_state_dict(state_dict_from_variables(model, variables), strict=True)


def policy_state_dict_from_jax(variables: Mapping[str, Any], policy: nn.Module
                               ) -> dict[str, torch.Tensor]:
    """The JAX ``LinnaeusPolicyWrapper``'s variables (``policy.init``: nested
    dicts of arrays under ``params``, or the ``params`` tree itself) as a
    state_dict of the port's policy (rl/policies.py) over a backbone of the
    same geometry: ``params/backbone`` through the backbone's bridge, each
    ``actor_{t}`` and ``critic`` Dense kernel (in, out) as a Linear weight
    (out, in). The JAX tree holds no classification heads of the backbone
    (the policy calls only ``forward_features``), so neither does the result:
    load it with ``strict=False`` and only ``backbone.head.*`` missing."""
    params = variables.get("params", variables)
    bridge, args = _bridge_args(policy.backbone)
    args = args[:-1] + ((),)  # no task heads in the policy's backbone tree
    state = {f"backbone.{k}": v for k, v in bridge(params["backbone"], *args).items()}
    for name in [f"actor_{t}" for t in policy.task_keys] + ["critic"]:
        state.update(_gather(params, _linear(name, (name,))))
    return state


def adamw_moments_from_optax(
    opt_state: Any,
    convnext_depths: tuple[int, ...],
    rope_depths: tuple[int, int],
    meta_names: tuple[str, ...] = (),
    task_keys: tuple[str, ...] = (),
    bridge: Callable = state_dict_from_jax,
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor], int]:
    """(exp_avg, exp_avg_sq, count) of an optax AdamW state by the port's
    parameter names: the ``mu`` and ``nu`` trees and the step count of the
    ``ScaleByAdamState`` found in ``opt_state`` (a nested tuple of states,
    with the trees already brought to numpy). For an mFormerV0 pass
    ``bridge=v0_state_dict_from_jax`` and its MBConv and attention depths."""

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
    return bridge(adam.mu, *args), bridge(adam.nu, *args), int(np.asarray(adam.count))


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


class JaxLayout(NamedTuple):
    """One parameter's place in the TPU package's tree: its Flax path joined
    with '/' (``stage1_block0/Dense_0/kernel``), and the two views between
    the torch layout and the Flax one."""

    path: str
    to_jax: Callable[[torch.Tensor], torch.Tensor]
    from_jax: Callable[[torch.Tensor], torch.Tensor]


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


# the torch views of the numpy layout changes above: (to Flax, from Flax)
_VIEWS: dict[Any, tuple[Callable, Callable]] = {
    None: (_same, _same),
    _conv: (lambda t: t.permute(2, 3, 1, 0), lambda t: t.permute(3, 2, 0, 1)),
    _dense: (lambda t: t.t(), lambda t: t.t()),
    _aggregate: (lambda t: t[:, :, 0].t(), lambda t: t.t()[:, :, None]),
    _conv1d: (lambda t: t.permute(2, 1, 0), lambda t: t.permute(2, 1, 0)),
}


def _skeleton(model: nn.Module) -> dict[str, Any]:
    """The keys of the Flax params tree that ``_entries`` looks up to decide
    which leaves exist, read off a torch mFormerV1."""
    tree: dict[str, Any] = {}
    for s, name in ((0, "stage1"), (1, "stage2")):
        for j, blk in enumerate(model.stages[s]):
            tree[f"{name}_block{j}"] = {"gamma": True} if blk.gamma is not None else {}
    for s, name in ((2, "stage3"), (3, "stage4")):
        for j, blk in enumerate(model.stages[s]):
            tree[f"{name}_block{j}"] = {"attn": {"freqs": True} if blk.attn.freqs is not None
                                        else {}}
    if hasattr(model, "cl_1_fc"):
        tree["cl_1_fc"] = True
    if hasattr(model, "aggregate"):
        tree["aggregate"] = True
    alt = getattr(model, "aggregate_alt", None)
    if alt is not None and hasattr(alt, "fc"):
        tree["aggregate_alt"] = {"Dense_0": True}
    return tree | _heads_skeleton(model, lambda dim: dim > 0)


def _heads_skeleton(model: nn.Module, has_meta_head: Callable[[int], bool]) -> dict[str, Any]:
    tree: dict[str, Any] = {}
    for s in (1, 2):
        for name, dim in model.meta_components:
            if has_meta_head(dim):
                tree[f"meta_{name.lower()}_head_{s}"] = True
    tree["head"] = {}
    for task in model.head.task_keys:
        fc = model.head[task].fc
        layer = "Conv_0" if isinstance(fc, nn.Conv1d) else "Dense_0"
        tree["head"][f"head_{task}"] = {layer: {"bias": True} if fc.bias is not None else {}}
    return tree


def _v0_skeleton(model: nn.Module) -> dict[str, Any]:
    """The keys of a Flax mFormerV0 params tree that ``_v0_entries`` looks up,
    read off a torch mFormerV0."""
    tree: dict[str, Any] = {}
    for s in (1, 2):
        for j, blk in enumerate(getattr(model, f"stage_{s}")):
            node = tree[f"stage{s}_block{j}"] = {"bn1": True, "bn2": True}
            if hasattr(blk, "_expand_conv"):
                node.update(expand_conv=True, bn0=True)
            if blk.has_se:
                node["se"] = True
    if hasattr(model, "cl_1_fc"):
        tree["cl_1_fc"] = True
    return tree | _heads_skeleton(model, lambda dim: True)


def jax_layouts(model: nn.Module) -> dict[str, JaxLayout]:
    """Parameter name -> :class:`JaxLayout` for every parameter of a torch
    mFormerV1 or mFormerV0, from the same table as :func:`state_dict_from_jax`
    / :func:`v0_state_dict_from_jax` (parameters only: the running
    statistics are no parameters)."""
    names = tuple(name for name, _ in model.meta_components)
    tasks = tuple(model.head.task_keys)
    if hasattr(model, "mbconv_depths"):
        entries = _v0_entries(_v0_skeleton(model), model.mbconv_depths, model.attn_depths,
                              names, tasks)
    else:
        depths = tuple(len(stage) for stage in model.stages)
        entries = _entries(_skeleton(model), depths[:2], depths[2:], names, tasks)
    out = {}
    for key, path, convert in entries:
        to_jax, from_jax = _VIEWS[convert]
        out[key] = JaxLayout("/".join(path), to_jax, from_jax)
    return out
