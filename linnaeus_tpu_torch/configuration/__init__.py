"""Configuration: the YACS-style node, the defaults, loading and merging,
the architecture presets, and the training presets as data."""

from .cfg_node import CfgNode, CN  # noqa: F401
from .defaults import get_config, get_default_config  # noqa: F401
from .utils import (  # noqa: F401
    build_config,
    load_config,
    load_model_base_config,
    merge_configs,
    save_config,
    setup_output_dirs,
    update_config,
    update_out_features,
)
