"""Pretrained initialisation of mFormerV1 and mFormerV0 from torch checkpoints.

Port of linnaeus_tpu/utils/pretrained.py (reference parity:
utils/checkpoint.py:117-513) without its MoE and export parts: the stitched
ConvNeXt + RoPE-ViT init (``load_stitched_pretrained``), the reference
framework's own mFormerV1 ``state_dict`` (``load_reference_mformer_v1``), a
MetaFG ("MetaFormer") checkpoint into mFormerV0
(``load_metaformer_into_mformer_v0``, running statistics included) and the
config-driven ``load_pretrained``. The port's modules hold the reference's key layout, so
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

What the port does not run raises by name: an MoE model (sparse upcycling,
M9) and ``hf://`` or ``b2://`` paths (remote checkpoints are not part of the
port).
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from linnaeus_tpu_torch.utils.logging import get_main_logger

logger = get_main_logger()

Report = dict[str, list[str]]
Entry = tuple[str, str]  # (source key, the model's state_dict key)


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The tensors of a torch checkpoint file, unwrapped from a
    ``state_dict`` / ``model`` / ``module`` entry, ``module.`` prefixes
    dropped. Official checkpoints carry non-tensor objects beside the
    weights (an argparse namespace, optimizer state), so the file is read
    with ``weights_only=False``, as in the TPU package: load only files you
    trust."""
    if str(path).startswith(("hf://", "b2://")):
        raise NotImplementedError(
            f"pretrained path {path!r}: hf:// and b2:// checkpoints are not part of the "
            "port (no downloads); give a local file")
    obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model", "module"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
    return {k.removeprefix("module."): v.detach() for k, v in obj.items()
            if isinstance(v, torch.Tensor)}


def _new_report() -> Report:
    return {"loaded": [], "missing": [], "shape_mismatch": []}


def apply_entries(model: nn.Module, state_dict: Mapping[str, torch.Tensor],
                  entries: list[Entry], report: Report) -> None:
    """Copy each entry's source tensor into the model's tensor of that key
    (cast to its dtype, in place), recording the outcome in ``report``."""
    targets = model.state_dict(keep_vars=True)
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


def load_convnext_into_mformer_v1(model: nn.Module,
                                  state_dict: Mapping[str, torch.Tensor]) -> Report:
    report = _new_report()
    apply_entries(model, state_dict, convnext_entries(_depths(model)[0]), report)
    log_report("ConvNeXt", report)
    return report


def load_ropevit_into_mformer_v1(model: nn.Module,
                                 state_dict: Mapping[str, torch.Tensor]) -> Report:
    report = _new_report()
    apply_entries(model, state_dict, ropevit_entries(state_dict, _depths(model)[1]), report)
    log_report("RoPE-ViT", report)
    return report


def load_stitched_pretrained(model: nn.Module, convnext_path: str | None,
                             ropevit_path: str | None) -> dict[str, Report]:
    """mFormerV1 stitched init (reference: checkpoint.py:216-340); the
    reports by loader, "ConvNeXt" and "RoPE-ViT"."""
    reports = {}
    if convnext_path:
        reports["ConvNeXt"] = load_convnext_into_mformer_v1(
            model, load_torch_state_dict(convnext_path))
    if ropevit_path:
        reports["RoPE-ViT"] = load_ropevit_into_mformer_v1(
            model, load_torch_state_dict(ropevit_path))
    return reports


def reference_entries(model: nn.Module) -> list[Entry]:
    """The reference framework's own mFormerV1 ``state_dict``: the port's
    layout, so every key maps onto itself (the TPU package's
    ``_reference_v1_entries`` over the model's stages, metadata heads and
    tasks)."""
    (cd, rd) = _depths(model)
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
        for name, _ in model.meta_components:
            head = f"meta_{name.lower()}_head_{s}"
            plain += [f"{head}.{p}" for p in (
                "0.weight", "0.bias", "2.weight", "2.bias", "3.w1.weight", "3.w1.bias",
                "3.norm_fn1.weight", "3.norm_fn1.bias", "3.w2.weight", "3.w2.bias",
                "3.norm_fn2.weight", "3.norm_fn2.bias")]
    for task in model.head.task_keys:
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

    The Trainer calls this only when no auto-resume checkpoint exists
    (resume wins, as in the reference)."""
    paths = pretrained_paths(config)
    if not paths:
        return {}
    for key, path in paths.items():
        if path.startswith(("hf://", "b2://")):
            raise NotImplementedError(
                f"MODEL.{key} {path!r}: hf:// and b2:// checkpoints (utils/remote_sync.py) are "
                "not part of the port; give a local file")
    if bool(config.MODEL.get("MOE", {}).get("ENABLED", False)):
        raise NotImplementedError(
            "MODEL.PRETRAINED* into an MoE model: sparse upcycling is not ported yet (M9)")
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
    if source == "stitched":
        return load_stitched_pretrained(model, cn_path, rv_path)
    if source == "metaformer":
        return load_metaformer_into_mformer_v0(model, load_torch_state_dict(paths["PRETRAINED"]))
    if source == "reference":
        return {"reference-mFormerV1": load_reference_mformer_v1(
            model, load_torch_state_dict(paths["PRETRAINED"]))}
    raise ValueError(
        f"Unknown MODEL.PRETRAINED_SOURCE {source!r} "
        "(expected 'metaformer', 'reference', or 'stitched')"
    )
