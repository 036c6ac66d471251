"""Pretrained initialisation of mFormerV1 and mFormerV0 from torch checkpoints.

Port of linnaeus_tpu/utils/pretrained.py (reference parity:
utils/checkpoint.py:117-513): the stitched ConvNeXt + RoPE-ViT init
(``load_stitched_pretrained``), the reference framework's own mFormerV1
``state_dict`` (``load_reference_mformer_v1``) and the way back
(``export_reference_mformer_v1``), a MetaFG ("MetaFormer") checkpoint into
mFormerV0 (``load_metaformer_into_mformer_v0``, running statistics
included), sparse upcycling into an MoE mFormerV1 and the config-driven
``load_pretrained``. The port's modules hold the reference's key layout, so
every entry maps a source key onto one of the model's own ``state_dict``
keys and the tensor is copied as it is: no layout changes. The official
ConvNeXt layout differs from the reference's by one downsampler index: its
stem is ``downsample_layers.0.{0=conv,1=LN}`` and its downsamplers
``downsample_layers.{1,2,3}.{0=LN,1=conv}``, where the reference (and this
port) has ``stem.{0,1}`` and ``downsample_layers.{0,1,2}.{norm,conv}``.

Loading is non-strict as in the TPU package: a source key that is absent
is reported as ``src:<key>``, a target the model lacks by its key, and a
shape mismatch is skipped and reported; everything unmapped keeps its
random init. The tensors are copied under ``no_grad`` into the existing
parameters, so the optimizer and the EMA, built afterwards, see the loaded
values. Each loader returns its report: ``{"loaded": [...], "missing":
[...], "shape_mismatch": [...]}``, keys by the port's names.

MoE (models/blocks/moe.py). The loaders map onto the dense layout, so an
MoE model loads through its dense twin: ``densify_moe_params`` turns its
state_dict into the dense one (zeros for each bank's MLP, routers dropped),
the loaders fill that, and ``upcycle_dense_to_moe`` copies the dense MLP
into every expert of each bank (sparse upcycling, Komatsuzaki et al. 2023),
the router keeping its fresh init. ``average_experts_into_dense`` is the
export's way down: each bank's mean in the dense layout. A bank ``wi`` is
(E, D, F) in the Flax layout and a dense ``fc1.weight`` (F, D), so each
expert is the transpose of the dense weight, bit for bit.

A ``b2://bucket/key`` path is fetched once into a local cache through
utils/remote_sync.py (b2sdk and the ``B2_APP_KEY_ID`` / ``B2_APP_KEY``
credentials, as in the TPU package); ``hf://`` raises by name (the port
downloads nothing from a model hub).
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from linnaeus_tpu_torch.utils.logging import get_main_logger
from linnaeus_tpu_torch.utils.remote_sync import resolve_checkpoint_path

logger = get_main_logger()

Report = dict[str, list[str]]
Entry = tuple[str, str]  # (source key, the model's state_dict key)


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The tensors of a torch checkpoint file, unwrapped from a
    ``state_dict`` / ``model`` / ``module`` entry, ``module.`` prefixes
    dropped. Official checkpoints carry non-tensor objects beside the
    weights (an argparse namespace, optimizer state), so the file is read
    with ``weights_only=False``, as in the TPU package: load only files you
    trust. A ``b2://`` path is fetched into the local cache first
    (utils/remote_sync.py::resolve_checkpoint_path)."""
    obj = torch.load(resolve_checkpoint_path(str(path)), map_location="cpu", weights_only=False)
    for key in ("state_dict", "model", "module"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
    return {k.removeprefix("module."): v.detach() for k, v in obj.items()
            if isinstance(v, torch.Tensor)}


def _new_report() -> Report:
    return {"loaded": [], "missing": [], "shape_mismatch": []}


def apply_entries(target: nn.Module | dict[str, torch.Tensor],
                  state_dict: Mapping[str, torch.Tensor],
                  entries: list[Entry], report: Report) -> None:
    """Copy each entry's source tensor into the target's tensor of that key
    (cast to its dtype, in place), recording the outcome in ``report``; the
    target is a model or a state_dict (an MoE model's dense twin)."""
    targets = target.state_dict(keep_vars=True) if isinstance(target, nn.Module) else target
    with torch.no_grad():
        for src, dst in entries:
            if src not in state_dict:
                report["missing"].append(f"src:{src}")
                continue
            if dst not in targets:
                report["missing"].append(dst)
                continue
            value, target = state_dict[src], targets[dst]
            if tuple(target.shape) != tuple(value.shape):
                report["shape_mismatch"].append(
                    f"{dst}: {tuple(value.shape)} -> expected {tuple(target.shape)}")
                continue
            target.copy_(value)
            report["loaded"].append(dst)


def log_report(name: str, report: Report) -> None:
    logger.info(
        f"[pretrained:{name}] loaded {len(report['loaded'])} tensors; "
        f"{len(report['missing'])} missing, "
        f"{len(report['shape_mismatch'])} shape mismatches"
    )
    for m in report["shape_mismatch"][:10]:
        logger.warning(f"[pretrained:{name}] shape mismatch: {m}")


def _convnext_block_entries(src: str, dst: str) -> list[Entry]:
    names = ("dwconv.weight", "dwconv.bias", "norm.weight", "norm.bias", "pwconv1.weight",
             "pwconv1.bias", "pwconv2.weight", "pwconv2.bias", "gamma")
    return [(f"{src}.{n}", f"{dst}.{n}") for n in names]


def _rope_block_entries(src: str, dst: str) -> list[Entry]:
    names = ("norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
             "attn.proj.weight", "attn.proj.bias", "norm2.weight", "norm2.bias",
             "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias")
    return [(f"{src}.{n}", f"{dst}.{n}") for n in names]


def _norm_conv(src_norm: str, src_conv: str, dst: str) -> list[Entry]:
    return [(f"{src_norm}.weight", f"{dst}.norm.weight"), (f"{src_norm}.bias", f"{dst}.norm.bias"),
            (f"{src_conv}.weight", f"{dst}.conv.weight"), (f"{src_conv}.bias", f"{dst}.conv.bias")]


def _depths(model: nn.Module) -> tuple[tuple[int, ...], tuple[int, int]]:
    depths = tuple(len(stage) for stage in model.stages)
    return depths[:2], depths[2:]


def convnext_entries(convnext_depths: tuple[int, ...]) -> list[Entry]:
    """The official ConvNeXt trunk (facebookresearch layout) onto the stem,
    stages 1-2 and the three downsamplers."""
    entries = [("downsample_layers.0.0.weight", "stem.0.weight"),
               ("downsample_layers.0.0.bias", "stem.0.bias"),
               ("downsample_layers.0.1.weight", "stem.1.weight"),
               ("downsample_layers.0.1.bias", "stem.1.bias")]
    for s in (0, 1):
        for j in range(convnext_depths[s]):
            entries += _convnext_block_entries(f"stages.{s}.{j}", f"stages.{s}.{j}")
    for t in (1, 2, 3):
        entries += _norm_conv(f"downsample_layers.{t}.0", f"downsample_layers.{t}.1",
                              f"downsample_layers.{t - 1}")
    return entries


def ropevit_entries(state_dict: Mapping[str, torch.Tensor],
                    rope_depths: tuple[int, int]) -> list[Entry]:
    """RoPE-ViT (rope-vit layout) blocks onto stages 3 and 4: the first
    ``rope_depths[0]`` source blocks fill stage 3, the next ``rope_depths[1]``
    stage 4. A block's learnable mixed-RoPE frequencies are taken from the
    first of ``blocks.{i}.attn.freqs``, ``freqs_{i}``, ``blocks.{i}.freqs``
    the file holds."""
    entries = []
    blk = 0
    for s, depth in ((2, rope_depths[0]), (3, rope_depths[1])):
        for j in range(depth):
            src, dst = f"blocks.{blk}", f"stages.{s}.{j}"
            entries += _rope_block_entries(src, dst)
            for freq_key in (f"{src}.attn.freqs", f"freqs_{blk}", f"{src}.freqs"):
                if freq_key in state_dict:
                    entries.append((freq_key, f"{dst}.attn.freqs"))
                    break
            blk += 1
    return entries


def load_convnext_into_mformer_v1(model: nn.Module, state_dict: Mapping[str, torch.Tensor],
                                  into: dict[str, torch.Tensor] | None = None) -> Report:
    """``into``: a state_dict of the model's geometry to load instead of the
    model (an MoE model's dense twin)."""
    report = _new_report()
    apply_entries(model if into is None else into, state_dict,
                  convnext_entries(_depths(model)[0]), report)
    log_report("ConvNeXt", report)
    return report


def load_ropevit_into_mformer_v1(model: nn.Module, state_dict: Mapping[str, torch.Tensor],
                                 into: dict[str, torch.Tensor] | None = None) -> Report:
    report = _new_report()
    apply_entries(model if into is None else into, state_dict,
                  ropevit_entries(state_dict, _depths(model)[1]), report)
    log_report("RoPE-ViT", report)
    return report


def load_stitched_pretrained(model: nn.Module, convnext_path: str | None,
                             ropevit_path: str | None,
                             into: dict[str, torch.Tensor] | None = None) -> dict[str, Report]:
    """mFormerV1 stitched init (reference: checkpoint.py:216-340); the
    reports by loader, "ConvNeXt" and "RoPE-ViT"."""
    reports = {}
    if convnext_path:
        reports["ConvNeXt"] = load_convnext_into_mformer_v1(
            model, load_torch_state_dict(convnext_path), into)
    if ropevit_path:
        reports["RoPE-ViT"] = load_ropevit_into_mformer_v1(
            model, load_torch_state_dict(ropevit_path), into)
    return reports


def reference_entries(model: nn.Module) -> list[Entry]:
    """The reference framework's own mFormerV1 ``state_dict``: the port's
    layout, so every key maps onto itself (the TPU package's
    ``_reference_v1_entries`` over the model's stages, metadata heads and
    tasks)."""
    return reference_v1_entries(*_depths(model), tuple(n for n, _ in model.meta_components),
                                tuple(model.head.task_keys))


def reference_v1_entries(cd: tuple[int, ...], rd: tuple[int, int],
                         meta_names: tuple[str, ...] = (),
                         task_keys: tuple[str, ...] = ()) -> list[Entry]:
    """:func:`reference_entries` from the geometry alone."""
    entries = [(k, k) for k in ("stem.0.weight", "stem.0.bias", "stem.1.weight", "stem.1.bias")]
    for s in (0, 1):
        for j in range(cd[s]):
            entries += _convnext_block_entries(f"stages.{s}.{j}", f"stages.{s}.{j}")
    for t in (0, 1, 2):
        d = f"downsample_layers.{t}"
        entries += _norm_conv(f"{d}.norm", f"{d}.conv", d)
    for s, depth in ((2, rd[0]), (3, rd[1])):
        for j in range(depth):
            key = f"stages.{s}.{j}"
            entries += _rope_block_entries(key, key) + [(f"{key}.attn.freqs",) * 2]
    plain = ["norm_1.weight", "norm_1.bias", "norm_2.weight", "norm_2.bias", "cls_token_1",
             "cls_token_2", "cl_1_fc.0.fc1.weight", "cl_1_fc.0.fc1.bias", "cl_1_fc.0.fc2.weight",
             "cl_1_fc.0.fc2.bias", "cl_1_fc.1.weight", "cl_1_fc.1.bias", "aggregate.weight",
             "aggregate.bias", "final_norm.weight", "final_norm.bias"]
    for s in (1, 2):
        for name in meta_names:
            head = f"meta_{name.lower()}_head_{s}"
            plain += [f"{head}.{p}" for p in (
                "0.weight", "0.bias", "2.weight", "2.bias", "3.w1.weight", "3.w1.bias",
                "3.norm_fn1.weight", "3.norm_fn1.bias", "3.w2.weight", "3.w2.bias",
                "3.norm_fn2.weight", "3.norm_fn2.bias")]
    for task in task_keys:
        plain += [f"head.{task}.fc.weight", f"head.{task}.fc.bias"]
    return entries + [(k, k) for k in plain]


def load_reference_mformer_v1(model: nn.Module,
                              state_dict: Mapping[str, torch.Tensor]) -> Report:
    """The reference framework's own mFormerV1 ``state_dict`` onto the model
    (checkpoints trained with the reference)."""
    report = _new_report()
    apply_entries(model, state_dict, reference_entries(model), report)
    log_report("reference-mFormerV1", report)
    return report


def export_reference_mformer_v1(
    state_dict: Mapping[str, torch.Tensor],
    convnext_depths: tuple[int, ...],
    rope_depths: tuple[int, int],
    meta_names: tuple[str, ...] = (),
    task_keys: tuple[str, ...] = (),
) -> dict[str, torch.Tensor]:
    """Inverse of :func:`load_reference_mformer_v1`: the state_dict the
    reference's own mFormerV1 loads, walked over the same entries. The
    port holds the reference's layout, so every tensor is taken as it is.
    Entries the state_dict lacks are skipped, as in the TPU package: an MoE
    bank's dense MLP (export :func:`average_experts_into_dense` of it), a
    head other than a Linear one (a Conv1d head's 3-D weight has no
    reference analog, nor has its bias)."""
    out = {}
    for src, dst in reference_v1_entries(convnext_depths, rope_depths, meta_names, task_keys):
        value = state_dict.get(dst)
        if value is None:
            continue
        if src.startswith("head.") and src.endswith(".fc.weight") and value.dim() != 2:
            continue
        out[src] = value
    for task in task_keys:  # a head's bias goes with its weight
        if f"head.{task}.fc.weight" not in out:
            out.pop(f"head.{task}.fc.bias", None)
    return out


# ---------------------------------------------------------------------- MoE
# an MoE bank leaf -> (the dense layer's key suffix, bank[e] -> dense tensor)
_MOE_LEAF_TO_DENSE = {
    "wi": ("fc1.weight", lambda t: t.t()),
    "bi": ("fc1.bias", lambda t: t),
    "wo": ("fc2.weight", lambda t: t.t()),
    "bo": ("fc2.bias", lambda t: t),
}


def _moe_leaf(key: str) -> tuple[str, str] | None:
    """(the mlp module's key, the leaf) of an MoE MLP tensor, else None."""
    base, _, leaf = key.rpartition(".")
    if (leaf in _MOE_LEAF_TO_DENSE or leaf == "router") and f".{base}".endswith(".mlp"):
        return base, leaf
    return None


def _moe_to_dense_walk(moe_params: Mapping[str, torch.Tensor], bank_to_dense) -> dict:
    """Each MoE bank in the dense layout (``bank_to_dense(bank)`` the dense
    tensor in the Flax layout of one expert), routers dropped, everything
    else as it is."""
    out = {}
    for key, value in moe_params.items():
        found = _moe_leaf(key)
        if found is None:
            out[key] = value
        elif found[1] != "router":
            suffix, to_dense = _MOE_LEAF_TO_DENSE[found[1]]
            out[f"{found[0]}.{suffix}"] = to_dense(bank_to_dense(value)).contiguous()
    return out


def densify_moe_params(moe_params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The dense twin of an MoE state_dict as a zero template for each MLP
    (the other tensors cloned), so the loaders, which map onto the dense
    layout, run unchanged; :func:`upcycle_dense_to_moe` then takes what they
    loaded into the banks."""
    dense = _moe_to_dense_walk(moe_params, lambda bank: torch.zeros_like(bank[0]))
    return {k: v.detach().clone() for k, v in dense.items()}


def average_experts_into_dense(moe_params: Mapping[str, torch.Tensor]
                               ) -> dict[str, torch.Tensor]:
    """Each (E, ...) bank collapsed to its mean in the dense layout: the
    export's way down (exact while the experts are replicas, as when freshly
    upcycled; a best-effort distillation otherwise)."""
    return _moe_to_dense_walk(moe_params, lambda bank: bank.mean(dim=0))


def upcycle_dense_to_moe(dense_params: Mapping[str, torch.Tensor],
                         moe_params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Sparse upcycling (Komatsuzaki et al. 2023, arXiv:2212.05055): the
    MoE state_dict with the dense MLP of ``dense_params`` copied into every
    expert of each bank. The routers keep the MoE model's fresh init (a zero
    router would send every token to experts 0..k-1 and overflow their
    capacity); the other tensors come from ``dense_params`` where it has
    them. With identical experts and normalised gates the upcycled forward
    equals the dense one up to capacity drops. ``dense_params``: the dense
    twin's state_dict, or :func:`densify_moe_params` after a loader."""
    out = {}
    n_upcycled = 0
    for key, target in moe_params.items():
        found = _moe_leaf(key)
        if found is not None and found[1] != "router":
            suffix, to_dense = _MOE_LEAF_TO_DENSE[found[1]]
            src_key = f"{found[0]}.{suffix}"
            if src_key not in dense_params:
                raise KeyError(f"upcycle: dense source missing for {key} (expected {src_key})")
            expert = to_dense(dense_params[src_key])  # the transpose is its own inverse
            if tuple(expert.shape) != tuple(target.shape[1:]):
                raise ValueError(f"upcycle: {key} expert shape {tuple(target.shape[1:])} != "
                                 f"dense {tuple(expert.shape)}")
            out[key] = expert.to(target.dtype).unsqueeze(0).expand_as(target).contiguous()
            n_upcycled += 1
        elif found is not None or key not in dense_params:
            out[key] = target  # a router keeps its fresh init
        else:
            out[key] = dense_params[key].to(target.dtype)
    logger.info(f"Sparse upcycling: replicated {n_upcycled} dense MLP leaves into expert banks")
    return out


def _is_moe_params(params: Mapping[str, torch.Tensor]) -> bool:
    return any((found := _moe_leaf(k)) is not None and found[1] == "wi" for k in params)


_BN_STATS = ("running_mean", "running_var")


def _weight_bias(src: str) -> list[str]:
    return [f"{src}.weight", f"{src}.bias"]


def metaformer_entries(mbconv_depths: tuple[int, int], attn_depths: tuple[int, int],
                       meta_names: tuple[str, ...] = (), task_keys: tuple[str, ...] = ()
                       ) -> tuple[list[Entry], list[Entry]]:
    """(parameter entries, running-statistic entries) of a MetaFG checkpoint
    on mFormerV0, in the order of the TPU package's table
    (``load_metaformer_into_mformer_v0``). The port holds MetaFG's layout, so
    every key maps onto itself. Not in the table, so never loaded: MetaFG's
    own ``head``, the ``relative_position_index`` buffers and
    ``num_batches_tracked``."""
    params = ["stage_0.0.weight", "stage_0.3.weight", "stage_0.6.weight"]
    stats = []
    for src in ("stage_0.1", "stage_0.4", "bn1"):
        params += _weight_bias(src)
        stats += [f"{src}.{b}" for b in _BN_STATS]
    for s, depth in ((1, mbconv_depths[0]), (2, mbconv_depths[1])):
        for j in range(depth):
            src = f"stage_{s}.{j}"
            params += [f"{src}._expand_conv.weight", f"{src}._depthwise_conv.weight",
                       *_weight_bias(f"{src}._se_reduce"), *_weight_bias(f"{src}._se_expand"),
                       f"{src}._project_conv.weight"]
            for bn in ("_bn0", "_bn1", "_bn2"):
                params += _weight_bias(f"{src}.{bn}")
                stats += [f"{src}.{bn}.{b}" for b in _BN_STATS]
    for s, depth in ((3, attn_depths[0]), (4, attn_depths[1])):
        for j in range(depth):
            src = f"stage_{s}.{j}"
            if j == 0:
                params += [*_weight_bias(f"{src}.patch_embed.proj"),
                           *_weight_bias(f"{src}.patch_embed.norm")]
            params += [*_weight_bias(f"{src}.norm1"), *_weight_bias(f"{src}.attn.qkv"),
                       *_weight_bias(f"{src}.attn.proj"),
                       f"{src}.attn.relative_position_bias_table", *_weight_bias(f"{src}.norm2"),
                       *_weight_bias(f"{src}.mlp.fc1"), *_weight_bias(f"{src}.mlp.fc2")]
    params += [*_weight_bias("norm_1"), *_weight_bias("norm_2"), "cls_token_1", "cls_token_2",
               *_weight_bias("norm"), *_weight_bias("cl_1_fc.0.fc1"),
               *_weight_bias("cl_1_fc.0.fc2"), *_weight_bias("cl_1_fc.1"),
               *_weight_bias("aggregate")]
    for s in (1, 2):
        for name in meta_names:
            head = f"meta_{name.lower()}_head_{s}"
            for part in ("0", "2", "3.w1", "3.norm_fn1", "3.w2", "3.norm_fn2"):
                params += _weight_bias(f"{head}.{part}")
    for task in task_keys:
        params += _weight_bias(f"head.{task}.fc")
    return [(k, k) for k in params], [(k, k) for k in stats]


def load_metaformer_into_mformer_v0(model: nn.Module,
                                    state_dict: Mapping[str, torch.Tensor]) -> dict[str, Report]:
    """A MetaFG ("MetaFormer") checkpoint onto an mFormerV0 (reference:
    utils/checkpoint.py:117 ``map_metaformer_checkpoint``): the stem, MBConv
    and attention stages, CLS tokens, the metadata heads and the aggregator,
    and every BatchNorm's running statistics. Non-strict: an absent or
    shape-mismatched tensor keeps its init and is reported. The reports of
    the parameters ("MetaFormer") and of the statistics
    ("MetaFormer/bn-stats"), as the TPU package logs them."""
    param_entries, stat_entries = metaformer_entries(
        model.mbconv_depths, model.attn_depths,
        tuple(name for name, _ in model.meta_components), tuple(model.head.task_keys))
    reports = {"MetaFormer": _new_report(), "MetaFormer/bn-stats": _new_report()}
    apply_entries(model, state_dict, param_entries, reports["MetaFormer"])
    apply_entries(model, state_dict, stat_entries, reports["MetaFormer/bn-stats"])
    for name, report in reports.items():
        log_report(name, report)
    return reports


def pretrained_paths(config) -> dict[str, str]:
    """MODEL.PRETRAINED / PRETRAINED_CONVNEXT / PRETRAINED_ROPEVIT that the
    config sets, by key."""
    return {key: str(config.MODEL.get(key)) for key in
            ("PRETRAINED", "PRETRAINED_CONVNEXT", "PRETRAINED_ROPEVIT")
            if config.MODEL.get(key)}


def load_pretrained(config, model: nn.Module) -> dict[str, Report]:
    """Config-driven pretrained initialisation (reference:
    utils/checkpoint.py:513 ``load_pretrained``), in place; the reports by
    loader, empty when nothing is configured. Reads:

      MODEL.PRETRAINED           torch checkpoint path
      MODEL.PRETRAINED_SOURCE    'metaformer' (v0) | 'reference' (v1) |
                                 'stitched'; inferred when unset ('stitched'
                                 with a ConvNeXt or RoPE-ViT path,
                                 'metaformer' for mFormerV0, else 'reference')
      MODEL.PRETRAINED_CONVNEXT  ConvNeXt trunk checkpoint (stitched init)
      MODEL.PRETRAINED_ROPEVIT   RoPE-ViT checkpoint (stitched init)

    For an MoE model the checkpoint is loaded into the dense twin and
    upcycled into the expert banks (the routers keep their init). The
    Trainer calls this only when no auto-resume checkpoint exists (resume
    wins, as in the reference)."""
    paths = pretrained_paths(config)
    if not paths:
        return {}
    for key, path in paths.items():
        try:
            paths[key] = resolve_checkpoint_path(path)
        except (NotImplementedError, RuntimeError) as e:
            raise type(e)(f"MODEL.{key} {path!r}: {e}") from e
    cn_path, rv_path = paths.get("PRETRAINED_CONVNEXT"), paths.get("PRETRAINED_ROPEVIT")
    source = config.MODEL.get("PRETRAINED_SOURCE")
    if not source:
        if cn_path or rv_path:
            source = "stitched"
        elif str(config.MODEL.TYPE) == "mFormerV0":
            source = "metaformer"
        else:
            source = "reference"
    source = str(source).lower()
    if source.startswith("stitched"):  # e.g. 'stitched_convnext_ropevit'
        source = "stitched"
    if source not in ("stitched", "metaformer", "reference"):
        raise ValueError(
            f"Unknown MODEL.PRETRAINED_SOURCE {source!r} "
            "(expected 'metaformer', 'reference', or 'stitched')"
        )
    if source == "metaformer":
        return load_metaformer_into_mformer_v0(model, load_torch_state_dict(paths["PRETRAINED"]))
    # an MoE model loads into its dense twin, which is then upcycled
    moe = _is_moe_params(model.state_dict())
    into = densify_moe_params(model.state_dict()) if moe else None
    if source == "stitched":
        reports = load_stitched_pretrained(model, cn_path, rv_path, into)
    else:
        report = _new_report()
        apply_entries(model if into is None else into,
                      load_torch_state_dict(paths["PRETRAINED"]), reference_entries(model), report)
        log_report("reference-mFormerV1", report)
        reports = {"reference-mFormerV1": report}
    if moe:
        model.load_state_dict(upcycle_dense_to_moe(into, model.state_dict()), strict=True)
        logger.info("Pretrained weights sparse-upcycled into the MoE banks")
    return reports
