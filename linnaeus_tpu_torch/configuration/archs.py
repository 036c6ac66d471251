"""mFormerV1 architecture presets as plain dicts.

Port of linnaeus_tpu/configuration/archs.py (the mFormerV1 presets): a
ConvNeXt-T/L/XL trunk with DeiT-S/B/L-width RoPE stages.
"""

from __future__ import annotations

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
