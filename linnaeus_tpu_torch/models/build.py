"""Model construction: from a config, or from an architecture preset.

Port of linnaeus_tpu/models/build.py, in two forms:

* ``build_model(config, num_classes=None, taxonomy_tree=None)``: a
  ``CfgNode`` (``configuration/``) whose ``MODEL.TYPE`` names the model in
  the registry (models/factory.py: mFormerV1, mFormerV0) and whose
  ``MODEL.*``, ``DATA.TASK_KEYS_H5``, ``DATA.META.COMPONENTS`` and
  ``TRAIN.MIXED_PRECISION`` decide it, as in the JAX package;
  ``TRAIN.GRADIENT_CHECKPOINTING.ENABLED_NORMAL_STEPS`` and ``POLICY`` set
  mFormerV1's per-block rematerialisation; ``MODEL.MOE.*`` its MoE MLPs
  (mFormerV0 with MoE raises, as in the JAX package).
* ``build_model(arch, img_size, num_classes, ...)``: the preset (a name from
  configuration/archs.py, or a dict of the same shape) fixes the depths and
  widths, and keywords carry the rest.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from torch import nn

from linnaeus_tpu_torch.configuration.archs import MFORMER_V0_ARCHS, MFORMER_V1_ARCHS
from linnaeus_tpu_torch.configuration.cfg_node import CfgNode
from linnaeus_tpu_torch.models.factory import MODEL_REGISTRY, list_models
from linnaeus_tpu_torch.models.heads.heads import needs_taxonomy_tree
from linnaeus_tpu_torch.models.mformer_v0 import MFormerV0
from linnaeus_tpu_torch.models.mformer_v1 import MFormerV1
from linnaeus_tpu_torch.utils.device import resolve_device
from linnaeus_tpu_torch.utils.meta import get_enabled_meta_components

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_compute_dtype(config) -> torch.dtype:
    mp = config.TRAIN.get("MIXED_PRECISION")
    if mp is not None and mp.get("ENABLED", False):
        return _DTYPES.get(str(mp.get("DTYPE", "bfloat16")), torch.bfloat16)
    # legacy AMP_OPT_LEVEL mapping: O0 -> fp32, otherwise bf16
    if str(config.TRAIN.get("AMP_OPT_LEVEL", "O1")) != "O0":
        return torch.bfloat16
    return torch.float32


def _meta_component_pairs(config) -> tuple[tuple[str, int], ...]:
    return tuple(
        (name, int(cfg.get("DIM", 0)))
        for name, cfg in get_enabled_meta_components(config)
    )


def _head_configs(config, task_keys) -> dict[str, dict]:
    heads = config.MODEL.CLASSIFICATION.get("HEADS", {})
    out = {}
    for task in task_keys:
        cfg = heads.get(task)
        out[task] = dict(cfg) if isinstance(cfg, Mapping) else {"TYPE": "Linear"}
    return out


def _hierarchy_matrices(head_configs, taxonomy_tree):
    if not needs_taxonomy_tree(head_configs):
        return None
    if taxonomy_tree is None:
        raise ValueError("Hierarchical heads configured but no taxonomy_tree provided")
    return taxonomy_tree.build_hierarchy_matrices()


def build_model(arch, *args, **kwargs) -> nn.Module:
    """``build_model(config, num_classes=None, taxonomy_tree=None, *,
    device=None, seed=0)`` for a ``CfgNode``; otherwise the keyword form,
    :func:`build_model_from_arch`. Either way the model has seeded random
    weights, is in eval mode, and sits on the CUDA device unless the CPU is
    asked for (``device="cpu"``)."""
    if isinstance(arch, CfgNode):
        return build_model_from_config(arch, *args, **kwargs)
    return build_model_from_arch(arch, *args, **kwargs)


def build_model_from_config(
    config: CfgNode,
    num_classes: Mapping[str, int] | None = None,
    taxonomy_tree=None,
    *,
    device: torch.device | str | None = None,
    seed: int = 0,
) -> nn.Module:
    """The model ``config.MODEL.TYPE`` declares, read as
    linnaeus_tpu/models/build.py reads it."""
    device = resolve_device(device)
    model_type = config.MODEL.TYPE
    list_models()  # fills the registry
    if model_type not in MODEL_REGISTRY:
        raise ValueError(
            f"Unknown MODEL.TYPE '{model_type}'. Registered: {sorted(MODEL_REGISTRY)}")

    task_keys = tuple(config.DATA.TASK_KEYS_H5)
    if num_classes is None:
        listed = list(config.MODEL.get("NUM_CLASSES", []) or [])
        if len(listed) != len(task_keys):
            raise ValueError(
                "num_classes not provided and MODEL.NUM_CLASSES does not match "
                "DATA.TASK_KEYS_H5"
            )
        num_classes = dict(zip(task_keys, listed))

    head_configs = _head_configs(config, task_keys)
    matrices = _hierarchy_matrices(head_configs, taxonomy_tree)

    moe = config.MODEL.get("MOE", {})
    moe_enabled = bool(moe.get("ENABLED", False))
    if moe_enabled and model_type != "mFormerV1":
        raise ValueError(
            "MODEL.MOE.ENABLED requires MODEL.TYPE=mFormerV1 (the MoE MLP replaces "
            "RoPE-block MLPs; mFormerV0 has no MoE substrate)")

    img_size = config.MODEL.IMG_SIZE
    img_size = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
    common = dict(
        img_size=img_size,
        in_chans=int(config.MODEL.IN_CHANS),
        drop_rate=float(config.MODEL.DROP_RATE),
        attn_drop_rate=float(config.MODEL.ATTN_DROP_RATE),
        drop_path_rate=float(config.MODEL.DROP_PATH_RATE),
        only_last_cls=bool(config.MODEL.ONLY_LAST_CLS),
        meta_components=_meta_component_pairs(config),
        task_keys=task_keys,
        num_classes={k: int(v) for k, v in num_classes.items()},
        head_configs=head_configs,
        hierarchy_matrices=matrices,
        gradient_checkpointing=bool(
            config.TRAIN.GRADIENT_CHECKPOINTING.get("ENABLED_NORMAL_STEPS", False)),
        act_exact=bool(config.MODEL.get("ACT_EXACT_GELU", False)),
        use_flash_attn=bool(config.MODEL.get("USE_FLASH_ATTN", False)),
        attn_fp32_softmax=bool(config.MODEL.get("ATTN_FP32_SOFTMAX", True)),
        dtype=resolve_compute_dtype(config),
        seed=seed,
    )
    if model_type == "mFormerV1":
        cs = config.MODEL.CONVNEXT_STAGES
        rs = config.MODEL.ROPE_STAGES
        fused = str(config.MODEL.get("FUSED_CONVNEXT_MLP", "auto")).lower()
        model = MFormerV1(
            moe_num_experts=int(moe.get("NUM_EXPERTS", 8)) if moe_enabled else 0,
            moe_top_k=int(moe.get("TOP_K", 2)),
            moe_capacity_factor=float(moe.get("CAPACITY_FACTOR", 1.25)),
            moe_every_n=int(moe.get("EVERY_N", 2)),
            moe_noise_std=float(moe.get("NOISE_STD", 0.0)),
            convnext_depths=tuple(cs.DEPTHS),
            convnext_dims=tuple(cs.DIMS),
            convnext_ls_init=float(cs.get("LAYER_SCALE_INIT_VALUE", 1e-6)),
            rope_depths=tuple(rs.DEPTHS),
            rope_dims=tuple(rs.DIMS),
            rope_num_heads=tuple(rs.NUM_HEADS),
            rope_mlp_ratio=tuple(float(r) for r in rs.MLP_RATIO),
            rope_theta=float(rs.get("ROPE_THETA", 10000.0)),
            rope_mixed=bool(rs.get("ROPE_MIXED", True)),
            # ROPE_DEINTERLEAVE is a weight layout of the TPU package's qkv
            # projection with the same parameters and function: nothing to read
            rope_fidelity=str(config.MODEL.get("ROPE_FIDELITY", "rotate")),
            fused_convnext_mlp={"auto": None, "on": True, "off": False}[fused],
            aggregation=str(config.MODEL.get("AGGREGATION", {}).get("TYPE", "default")),
            remat_policy=str(config.TRAIN.GRADIENT_CHECKPOINTING.get("POLICY", "dots")),
            **common,
        )
    elif model_type == "mFormerV0":
        st = config.MODEL.get("STAGES", {})
        model = MFormerV0(
            stage_dims=tuple(st.get("DIMS", (64, 96, 192, 384, 768))),
            mbconv_depths=tuple(st.get("MBCONV_DEPTHS", (2, 3))),
            attn_depths=tuple(st.get("ATTN_DEPTHS", (5, 2))),
            num_heads=tuple(st.get("NUM_HEADS", (8, 8))),
            mlp_ratio=tuple(float(r) for r in st.get("MLP_RATIO", (4.0, 4.0))),
            head_split=bool(config.MODEL.get("ATTN_HEAD_SPLIT", False)),
            **common,
        )
    else:
        model = MODEL_REGISTRY[model_type](**common)
    return model.to(device).eval()


def build_model_from_arch(
    arch: str | Mapping[str, Any],
    img_size: int,
    num_classes: Mapping[str, int],
    meta_components: tuple[tuple[str, int], ...] = (),
    in_chans: int = 3,
    dtype: torch.dtype = torch.float32,
    use_flash_attn: bool = False,
    attn_fp32_softmax: bool = True,
    fused_convnext_mlp: bool | None = None,
    act_exact: bool = False,
    rope_fidelity: str = "rotate",
    head_configs: Mapping[str, Mapping[str, Any]] | None = None,
    device: torch.device | str | None = None,
    seed: int = 0,
    drop_path_rate: float | None = None,
    taxonomy_tree=None,
) -> nn.Module:
    """mFormerV1 or mFormerV0 for ``arch`` with seeded random weights, in eval mode, on
    the CUDA device: ``device=None`` (or ``"auto"``) means the card and
    raises where there is none; the CPU is used only for ``device="cpu"``.

    ``num_classes`` maps each task key, in order, to its class count.
    ``meta_components`` are ordered (name, dim) pairs, e.g.
    (("TEMPORAL", 2), ("SPATIAL", 3), ("ELEVATION", 6)). ``use_flash_attn``
    routes every RoPE attention through K1; ``attn_fp32_softmax`` False
    lets the plain attention path compute its scores in ``dtype`` (the TPU
    package's ``MODEL.ATTN_FP32_SOFTMAX``); ``fused_convnext_mlp`` True or
    None routes the ConvNeXt MLP tails of stages 1-2 through K2 on CUDA
    (None keeps plain modules for CPU tensors), False keeps plain modules.
    Hierarchical ``head_configs`` need ``taxonomy_tree``. An mFormerV0
    preset (``MFORMER_V0_ARCHS``, or a dict with ``DIMS`` and
    ``MBCONV_DEPTHS``) builds an mFormerV0; ``fused_convnext_mlp`` and
    ``rope_fidelity`` have nothing to act on there, and ``use_flash_attn``
    is accepted and unused, as in the JAX package. A dict preset may carry
    ``MOE`` (``NUM_EXPERTS``, ``TOP_K``, ``CAPACITY_FACTOR``, ``EVERY_N``,
    ``NOISE_STD``: the keys of ``MODEL.MOE``) for an mFormerV1 with MoE MLPs.
    """
    device = resolve_device(device)
    spec = (MFORMER_V1_ARCHS | MFORMER_V0_ARCHS)[arch] if isinstance(arch, str) else arch
    matrices = _hierarchy_matrices(head_configs or {}, taxonomy_tree)
    if "MBCONV_DEPTHS" in spec:
        model = MFormerV0(
            img_size=(img_size, img_size),
            in_chans=in_chans,
            stage_dims=tuple(spec["DIMS"]),
            mbconv_depths=tuple(spec["MBCONV_DEPTHS"]),
            attn_depths=tuple(spec["ATTN_DEPTHS"]),
            num_heads=tuple(spec["NUM_HEADS"]),
            drop_path_rate=float(
                spec.get("DROP_PATH_RATE", 0.2) if drop_path_rate is None else drop_path_rate),
            act_exact=act_exact,
            use_flash_attn=use_flash_attn,
            attn_fp32_softmax=attn_fp32_softmax,
            meta_components=tuple(meta_components),
            task_keys=tuple(num_classes),
            num_classes=dict(num_classes),
            head_configs=head_configs,
            hierarchy_matrices=matrices,
            dtype=dtype,
            seed=seed,
        )
        return model.to(device).eval()
    moe = spec.get("MOE") or {}
    model = MFormerV1(
        img_size=(img_size, img_size),
        in_chans=in_chans,
        moe_num_experts=int(moe.get("NUM_EXPERTS", 0)),
        moe_top_k=int(moe.get("TOP_K", 2)),
        moe_capacity_factor=float(moe.get("CAPACITY_FACTOR", 1.25)),
        moe_every_n=int(moe.get("EVERY_N", 2)),
        moe_noise_std=float(moe.get("NOISE_STD", 0.0)),
        convnext_depths=tuple(spec["CONVNEXT"]["DEPTHS"]),
        convnext_dims=tuple(spec["CONVNEXT"]["DIMS"]),
        rope_depths=tuple(spec["ROPE"]["DEPTHS"]),
        rope_dims=tuple(spec["ROPE"]["DIMS"]),
        rope_num_heads=tuple(spec["ROPE"]["NUM_HEADS"]),
        drop_path_rate=float(
            spec.get("DROP_PATH_RATE", 0.2) if drop_path_rate is None else drop_path_rate),
        rope_fidelity=rope_fidelity,
        act_exact=act_exact,
        use_flash_attn=use_flash_attn,
        attn_fp32_softmax=attn_fp32_softmax,
        fused_convnext_mlp=fused_convnext_mlp,
        meta_components=tuple(meta_components),
        task_keys=tuple(num_classes),
        num_classes=dict(num_classes),
        head_configs=head_configs,
        hierarchy_matrices=matrices,
        dtype=dtype,
        seed=seed,
    )
    return model.to(device).eval()
