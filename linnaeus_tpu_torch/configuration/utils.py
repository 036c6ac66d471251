"""Config loading, inheritance, and finalization.

Copy of linnaeus_tpu/configuration/utils.py: the upstream framework's merge
semantics with 5-level precedence

    defaults -> BASE file(s) -> MODEL.BASE file(s) -> experiment yaml -> --opts

Relative paths resolve against ``$CONFIG_DIR``; the in-file ``MODEL.BASE``
paths start with ``configs/``, so it is the repository root.
"""

from __future__ import annotations

import os

import yaml

from .cfg_node import CfgNode as CN
from .defaults import get_default_config


def get_config_path(relative_path: str) -> str:
    """Resolve a config path; relative paths resolve against $CONFIG_DIR."""
    if os.path.isabs(relative_path):
        return relative_path
    config_dir = os.environ.get("CONFIG_DIR")
    if not config_dir:
        raise ValueError(
            "CONFIG_DIR environment variable not set; cannot resolve relative paths."
        )
    return os.path.join(config_dir, relative_path)


def load_config(config_path: str) -> CN:
    """Load a YAML file into a standalone (new-allowed) CfgNode."""
    abs_path = get_config_path(config_path)
    if not os.path.isfile(abs_path):
        raise FileNotFoundError(f"Config file does not exist: {abs_path}")
    with open(abs_path) as f:
        data = yaml.safe_load(f) or {}
    return CN(data, new_allowed=True)


def merge_configs(lower_priority: CN, higher_priority: CN) -> CN:
    """Recursive merge; the second argument wins on conflicts."""
    merged = lower_priority.clone()
    for key, value in higher_priority.items():
        if key in merged and isinstance(merged[key], CN) and isinstance(value, CN):
            merged[key] = merge_configs(merged[key], value)
        else:
            merged[key] = value
    return merged


def save_config(cfg: CN, save_path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    with open(save_path, "w") as f:
        yaml.dump(
            cfg.to_dict(),
            f,
            default_flow_style=False,
            sort_keys=False,
            allow_unicode=True,
            width=1000,
        )


def _resolve_base_chain(cfg: CN) -> CN:
    """Resolve top-level ``BASE`` file inheritance (depth-first)."""
    base_paths = cfg.get("BASE", [])
    if isinstance(base_paths, str):
        base_paths = [base_paths]
    resolved = CN(new_allowed=True)
    for base_path in base_paths:
        if not base_path or not str(base_path).strip():
            continue
        base_cfg = load_config(base_path)
        base_cfg = _resolve_base_chain(base_cfg)
        resolved = merge_configs(resolved, base_cfg)
    out = merge_configs(resolved, cfg)
    if "BASE" in out:
        out["BASE"] = [""]
    return out


def load_model_base_config(cfg: CN) -> CN:
    """Merge ``MODEL.BASE`` file(s) under the experiment's MODEL overrides."""
    if "MODEL" not in cfg or "BASE" not in cfg.MODEL or not cfg.MODEL.BASE:
        return cfg
    base_paths = cfg.MODEL.BASE
    if isinstance(base_paths, str):
        base_paths = [base_paths]
    original_model = cfg.MODEL.clone()
    for base_path in base_paths:
        if not base_path or not str(base_path).strip():
            continue
        base_cfg = load_config(base_path)
        model_base = base_cfg.get("MODEL", base_cfg)
        temp = model_base.clone()
        for key in original_model:
            if key == "BASE":
                continue
            if (
                key in temp
                and isinstance(temp[key], CN)
                and isinstance(original_model[key], CN)
            ):
                temp[key] = merge_configs(temp[key], original_model[key])
            else:
                temp[key] = original_model[key]
        cfg.MODEL = temp
    return cfg


def build_config(experiment_yaml: str | None = None, opts: list | None = None) -> CN:
    """Full precedence chain: defaults <- BASE <- MODEL.BASE <- exp yaml <- opts."""
    cfg = get_default_config()
    cfg.set_new_allowed(True)
    if experiment_yaml:
        exp = load_config(experiment_yaml)
        exp = _resolve_base_chain(exp)
        exp = load_model_base_config(exp)
        cfg = merge_configs(cfg, exp)
    if opts:
        cfg.merge_from_list(list(opts))
    return cfg


def validate_config_paths(cfg: CN) -> None:
    for path_attr in (
        "TRAIN_LABELS_PATH",
        "VAL_LABELS_PATH",
        "TRAIN_IMAGES_PATH",
        "VAL_IMAGES_PATH",
    ):
        possible_path = cfg.DATA.H5.get(path_attr)
        if possible_path and not os.path.exists(possible_path):
            raise FileNotFoundError(f"Required H5 file does not exist: {possible_path}")


def update_config(cfg: CN, args) -> CN:
    """Apply CLI --opts overrides, validate paths, and freeze."""
    cfg.defrost()
    if hasattr(args, "opts") and args.opts:
        cfg.merge_from_list(args.opts)
    validate_config_paths(cfg)
    cfg.freeze()
    return cfg


def update_out_features(cfg: CN, num_classes: dict[str, int]) -> None:
    """Inject per-task OUT_FEATURES into the classification-head configs."""
    cfg.defrost()
    for task_str in cfg.DATA.TASK_KEYS_H5:
        if task_str not in cfg.MODEL.CLASSIFICATION.HEADS:
            raise ValueError(f"No classification head found for {task_str}")
        if task_str not in num_classes:
            raise ValueError(f"No num_classes found for {task_str}")
        head_cfg = cfg.MODEL.CLASSIFICATION.HEADS[task_str]
        head_cfg.OUT_FEATURES = num_classes[task_str]
    cfg.freeze()


def setup_output_dirs(config: CN) -> CN:
    """Create the experiment output tree and record paths in ENV.OUTPUT.DIRS."""
    base = config.ENV.OUTPUT.BASE_DIR
    exp_base = os.path.join(
        base,
        config.EXPERIMENT.PROJECT or "default_project",
        config.EXPERIMENT.GROUP or "default_group",
        config.EXPERIMENT.NAME or "default_experiment",
    )
    dirs = {
        "EXP_BASE": exp_base,
        "CHECKPOINTS": os.path.join(exp_base, "checkpoints"),
        "LOGS": os.path.join(exp_base, "logs"),
        "ASSETS": os.path.join(exp_base, "assets"),
        "CONFIGS": os.path.join(exp_base, "configs"),
        "METADATA": os.path.join(exp_base, "metadata"),
    }
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    was_frozen = config.is_frozen()
    config.defrost()
    for k, v in dirs.items():
        config.ENV.OUTPUT.DIRS[k] = v
    if was_frozen:
        config.freeze()
    return config
