"""Training presets as data.

``TRAINRUN_SYNTH_384`` carries what the train step, the loss, the schedule
and the optimizer read from configs/experiments/tpu_trainrun_synth_384.yaml
merged over the TPU package's defaults: mFormerV1_sm at 384 px, batch 64,
bfloat16 compute, AdamW with weight decay 0.05, a cosine schedule from
1.5e-4 to 1.5e-5 after 150 linear warm-up steps, global-norm clip 5.0,
drop-path 0.05, mixup alpha 1.0, the start values of the mix and
meta-masking schedules, and the defaults' ``MODEL.ATTN_FP32_SOFTMAX: False``
(the plain attention path stores its scores in the compute dtype), which
the yaml does not override. Data paths, samplers, checkpoints and logging
are not part of it: a run reads those from its experiment yaml.

``TRAINRUN_SYNTH_512`` is the same run with ``MODEL.IMG_SIZE`` and
``DATA.IMG_SIZE`` set to 512. The TPU package ships no 512 px yaml; both
keys are free knobs of its config. At 512 px stage 3 of mFormerV1_sm holds
32 x 32 + 4 = 1028 tokens, the first size past 1024, where K1's backward
takes its split dQ and dK/dV kernels (ops/flash_attention.py).
"""

from __future__ import annotations

import copy

from .cfg_node import CfgNode


_TASKS = ["taxa_L10", "taxa_L20", "taxa_L30", "taxa_L40"]

TRAINRUN_SYNTH_384 = {
    "MODEL": {
        "ARCH": "mFormerV1_sm",
        "IMG_SIZE": 384,
        "USE_FLASH_ATTN": True,
        "ATTN_FP32_SOFTMAX": False,
        "DROP_PATH_RATE": 0.05,
        "LABEL_SMOOTHING": 0.1,
    },
    "DATA": {
        "IMG_SIZE": 384,
        "BATCH_SIZE": 64,
        "BATCH_SIZE_VAL": 64,
        "TASK_KEYS_H5": _TASKS,
    },
    "TRAIN": {
        "EPOCHS": 8,
        "CLIP_GRAD": 5.0,
        "ACCUMULATION_STEPS": 0,
        "PHASE1_MASK_NULL_LOSS": False,
        "MIXED_PRECISION": {"ENABLED": True, "DTYPE": "bfloat16"},
    },
    "LOSS": {
        "TAXONOMY_SMOOTHING": {"ENABLED": [], "ALPHA": 0.1, "BETA": 1.0,
                               "UNIFORM_ROOTS": True, "FALLBACK_TO_UNIFORM": True},
        "TASK_SPECIFIC": {
            "TRAIN": {"FUNCS": ["CrossEntropyLoss"] * 4},
            "VAL": {"FUNCS": ["CrossEntropyLoss"] * 4},
        },
    },
    "OPTIMIZER": {
        "NAME": "adamw",
        "WEIGHT_DECAY": 0.05,
        "BETAS": (0.9, 0.999, 0.9999),
        "EPS": 1e-8,
        "PARAMETER_GROUPS": {"ENABLED": False},
    },
    "LR_SCHEDULER": {
        "NAME": "cosine",
        "BASE_LR": 1.5e-4,
        "MIN_LR": 1.5e-5,
        "WARMUP_LR": 5e-7,
        "WARMUP_EPOCHS": 0,
        "WARMUP_STEPS": 150,
        "WARMUP_FRACTION": None,
        "REFERENCE_BS": 64,
        "REFERENCE_LR": 5e-5,
    },
    "SCHEDULE": {
        "META_MASKING": {"ENABLED": True, "START_PROB": 1.0, "END_PROB": 0.1,
                         "END_FRACTION": 0.5},
        "MIX": {
            "PROB": {"ENABLED": True, "START_PROB": 0.2, "END_PROB": 0.1,
                     "END_FRACTION": 0.8},
            "MIXUP": {"ENABLED": True, "ALPHA": 1.0},
            "CUTMIX": {"ENABLED": False, "ALPHA": 1.0},
            "GROUP_LEVELS": ["taxa_L20", "taxa_L10"],
        },
        "NULL_MASKING": {"ENABLED": False, "START_PROB": 0.0, "END_PROB": 1.0},
    },
}

TRAINRUN_SYNTH_512 = {
    **TRAINRUN_SYNTH_384,
    "MODEL": {**TRAINRUN_SYNTH_384["MODEL"], "IMG_SIZE": 512},
    "DATA": {**TRAINRUN_SYNTH_384["DATA"], "IMG_SIZE": 512},
}

TRAIN_PRESETS = {
    "tpu_trainrun_synth_384": TRAINRUN_SYNTH_384,
    "tpu_trainrun_synth_512": TRAINRUN_SYNTH_512,
}


def train_preset(name: str = "tpu_trainrun_synth_384") -> CfgNode:
    """A fresh, editable copy of the preset ``name`` (a key of
    ``TRAIN_PRESETS``) as a config node."""
    return CfgNode(copy.deepcopy(TRAIN_PRESETS[name]))
