"""Architecture presets (mFormerV1 sm/md/lg/xl, mFormerV0 sm/md/lg).

Port of linnaeus_tpu/configuration/archs.py: ConvNeXt-T/L/XL trunks with
DeiT-S/B/L-width RoPE stages, and the MetaFG geometries of mFormerV0.
``apply_arch(cfg, name)`` merges a preset into ``cfg.MODEL`` as the JAX
package does; the port builds only mFormerV1 (``models/build.py`` raises by
name for mFormerV0).
"""

from __future__ import annotations

from .cfg_node import CfgNode as CN

MFORMER_V1_ARCHS: dict[str, dict] = {
    "mFormerV1_sm": {
        "CONVNEXT": {"DEPTHS": [3, 3, 9, 3], "DIMS": [96, 192, 384, 768]},
        "ROPE": {"DEPTHS": [5, 2], "DIMS": [384, 768], "NUM_HEADS": [6, 12]},
        "DROP_PATH_RATE": 0.2,
    },
    "mFormerV1_md": {
        "CONVNEXT": {"DEPTHS": [3, 3, 27, 3], "DIMS": [96, 192, 384, 768]},
        "ROPE": {"DEPTHS": [10, 2], "DIMS": [384, 768], "NUM_HEADS": [6, 12]},
        "DROP_PATH_RATE": 0.3,
    },
    "mFormerV1_lg": {
        "CONVNEXT": {"DEPTHS": [3, 3, 27, 3], "DIMS": [192, 384, 768, 1536]},
        "ROPE": {"DEPTHS": [10, 2], "DIMS": [768, 1536], "NUM_HEADS": [12, 24]},
        "DROP_PATH_RATE": 0.4,
    },
    "mFormerV1_xl": {
        "CONVNEXT": {"DEPTHS": [3, 3, 27, 3], "DIMS": [256, 512, 1024, 2048]},
        "ROPE": {"DEPTHS": [22, 2], "DIMS": [1024, 2048], "NUM_HEADS": [16, 32]},
        "DROP_PATH_RATE": 0.5,
    },
}

# DIMS = (stem, mbconv1, mbconv2, attn3, attn4)
MFORMER_V0_ARCHS: dict[str, dict] = {
    "mFormerV0_sm": {
        "DIMS": (64, 96, 192, 384, 768),
        "MBCONV_DEPTHS": (2, 3),
        "ATTN_DEPTHS": (5, 2),
        "NUM_HEADS": (8, 8),
    },
    "mFormerV0_md": {
        "DIMS": (64, 96, 192, 384, 768),
        "MBCONV_DEPTHS": (2, 6),
        "ATTN_DEPTHS": (14, 2),
        "NUM_HEADS": (8, 8),
    },
    "mFormerV0_lg": {
        "DIMS": (128, 128, 256, 512, 1024),
        "MBCONV_DEPTHS": (2, 6),
        "ATTN_DEPTHS": (14, 2),
        "NUM_HEADS": (8, 8),
        "DROP_PATH_RATE": 0.3,
    },
}


def apply_arch(cfg: CN, arch_name: str) -> CN:
    """Apply a named architecture preset to cfg.MODEL (in place)."""
    was_frozen = cfg.is_frozen()
    cfg.defrost()
    if arch_name in MFORMER_V1_ARCHS:
        spec = MFORMER_V1_ARCHS[arch_name]
        cfg.MODEL.TYPE = "mFormerV1"
        cfg.MODEL.NAME = arch_name
        cfg.MODEL.DROP_PATH_RATE = spec.get("DROP_PATH_RATE", 0.2)
        cfg.MODEL.CONVNEXT_STAGES.DEPTHS = list(spec["CONVNEXT"]["DEPTHS"])
        cfg.MODEL.CONVNEXT_STAGES.DIMS = list(spec["CONVNEXT"]["DIMS"])
        cfg.MODEL.CONVNEXT_STAGES.LAYER_SCALE_INIT_VALUE = 1e-6
        cfg.MODEL.ROPE_STAGES.DEPTHS = list(spec["ROPE"]["DEPTHS"])
        cfg.MODEL.ROPE_STAGES.DIMS = list(spec["ROPE"]["DIMS"])
        cfg.MODEL.ROPE_STAGES.NUM_HEADS = list(spec["ROPE"]["NUM_HEADS"])
        cfg.MODEL.ROPE_STAGES.MLP_RATIO = [4.0, 4.0]
        cfg.MODEL.ROPE_STAGES.ROPE_THETA = 10000.0
        cfg.MODEL.ROPE_STAGES.ROPE_MIXED = True
    elif arch_name in MFORMER_V0_ARCHS:
        spec = MFORMER_V0_ARCHS[arch_name]
        cfg.MODEL.TYPE = "mFormerV0"
        cfg.MODEL.NAME = arch_name
        cfg.MODEL.DROP_PATH_RATE = spec.get("DROP_PATH_RATE", 0.2)
        cfg.MODEL.STAGES.DIMS = list(spec["DIMS"])
        cfg.MODEL.STAGES.MBCONV_DEPTHS = list(spec["MBCONV_DEPTHS"])
        cfg.MODEL.STAGES.ATTN_DEPTHS = list(spec["ATTN_DEPTHS"])
        cfg.MODEL.STAGES.NUM_HEADS = list(spec["NUM_HEADS"])
        cfg.MODEL.STAGES.MLP_RATIO = [4.0, 4.0]
    else:
        raise ValueError(f"Unknown arch '{arch_name}'")
    if was_frozen:
        cfg.freeze()
    return cfg
