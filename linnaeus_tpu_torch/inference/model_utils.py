"""Model construction and weight loading for inference.

Port of linnaeus_tpu/inference/model_utils.py. :func:`build_config_for_inference`
bridges the inference config to a training-style ``CfgNode`` line for line
as the JAX package does: defaults, the named preset (``apply_arch``), the
architecture variant file merged over it, the metadata components aligned
with the inference config. :func:`load_model_for_inference` builds the model
from that config (``models.build.build_model``) and loads its weights:

* a Flax ``.msgpack`` file, the JAX package's bundles' format, read by
  ``utils/flax_msgpack.py`` (``params``, and an mFormerV0's ``batch_stats``)
  and mapped by ``utils/convert.py::state_dict_from_variables``;
* a torch ``state_dict`` file (``.pt`` / ``.pth``), the port's own format
  (an mFormerV0's holds its BatchNorms' running statistics as buffers);
* a training checkpoint directory of the port's Trainer
  (``<dir>/state/state.pt``, utils/checkpoint.py): its model state_dict,
  running statistics included, as the JAX package serves its own training
  checkpoint directories. An Orbax directory (the JAX package's training
  checkpoints) raises by name, and so do ``hf://`` weights: the port reads
  no Orbax state and downloads nothing.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Mapping

import torch

from linnaeus_tpu_torch.configuration import get_default_config, load_config, merge_configs
from linnaeus_tpu_torch.configuration.archs import apply_arch
from linnaeus_tpu_torch.configuration.cfg_node import CfgNode
from torch import nn

from linnaeus_tpu_torch.models.build import build_model
from linnaeus_tpu_torch.utils import flax_msgpack
from linnaeus_tpu_torch.utils.checkpoint import read_model_state
from linnaeus_tpu_torch.utils.convert import state_dict_from_variables

from .config import InferenceConfig

logger = logging.getLogger(__name__)


def meta_components_for_inference(cfg: InferenceConfig) -> tuple[tuple[str, int], ...]:
    """Enabled metadata components in the trained order (TEMPORAL, SPATIAL,
    ELEVATION), with the widths the aux vector packs them at."""
    mc = cfg.metadata_preprocessing
    out = []
    if mc.use_temporal:
        out.append(("TEMPORAL", 4 if mc.temporal_use_hour else 2))
    if mc.use_geolocation:
        out.append(("SPATIAL", 3))
    if mc.use_elevation:
        out.append(("ELEVATION", 2 * len(mc.elevation_scales)))
    return tuple(out)


def build_config_for_inference(inf_cfg: InferenceConfig) -> CfgNode:
    """Inference config -> training-style config for ``build_model``. The
    variant path goes to ``load_config`` as given: an absolute path, or one
    relative to ``$CONFIG_DIR``."""
    cfg = get_default_config()
    cfg.DATA.TASK_KEYS_H5 = list(inf_cfg.model.model_task_keys_ordered)
    c, h, w = inf_cfg.input_preprocessing.image_size
    cfg.MODEL.IMG_SIZE = h
    cfg.MODEL.IN_CHANS = c
    cfg.TRAIN.GRADIENT_CHECKPOINTING.ENABLED_NORMAL_STEPS = False
    arch = inf_cfg.model.architecture_name
    try:
        apply_arch(cfg, arch)
    except ValueError:
        logger.warning(f"Unknown arch preset '{arch}'; relying on variant config")
    if inf_cfg.model.architecture_variant_config_path:
        variant = load_config(inf_cfg.model.architecture_variant_config_path)
        cfg = merge_configs(cfg, variant)
    # align the enabled components with the inference MetaConfig
    mc = inf_cfg.metadata_preprocessing
    cfg.DATA.META.COMPONENTS.TEMPORAL.ENABLED = bool(mc.use_temporal)
    cfg.DATA.META.COMPONENTS.TEMPORAL.DIM = 4 if mc.temporal_use_hour else 2
    cfg.DATA.META.COMPONENTS.SPATIAL.ENABLED = bool(mc.use_geolocation)
    cfg.DATA.META.COMPONENTS.SPATIAL.DIM = 3
    cfg.DATA.META.COMPONENTS.ELEVATION.ENABLED = bool(mc.use_elevation)
    cfg.DATA.META.COMPONENTS.ELEVATION.DIM = 2 * len(mc.elevation_scales)
    return cfg


def _num_classes(inf_cfg: InferenceConfig) -> dict[str, int]:
    return dict(zip(inf_cfg.model.model_task_keys_ordered, inf_cfg.model.num_classes_per_task))


def load_weights(model: nn.Module, weights_path: str) -> None:
    """Load ``weights_path`` into ``model`` (strict): a Flax ``.msgpack``, a
    torch state_dict file or a training checkpoint directory of the port."""
    path = Path(weights_path)
    if weights_path.startswith("hf://"):
        raise NotImplementedError(
            f"weights_path {weights_path!r}: hf:// weights are not ported (no downloads); "
            "give a local .msgpack or .pt file")
    if path.is_dir():
        state = read_model_state(weights_path)
    elif not path.is_file():
        raise FileNotFoundError(f"weights file not found: {weights_path}")
    elif path.suffix == ".msgpack":
        state = state_dict_from_variables(model, flax_msgpack.read_variables(path))
    elif path.suffix in (".pt", ".pth"):
        state = torch.load(path, map_location="cpu", weights_only=True)
    else:
        raise ValueError(f"Unsupported weights format: {weights_path}")
    model.load_state_dict(state, strict=True)


def load_model_for_inference(inf_cfg: InferenceConfig, taxonomy_tree=None,
                             **kwargs: Any) -> nn.Module:
    """The bundle's model with its weights, in eval mode, on
    ``inference_options.device`` ("auto" is the CUDA device and raises
    without one). ``kwargs`` go to ``build_model`` (``device``, ``seed``)."""
    cfg = build_config_for_inference(inf_cfg)
    kwargs.setdefault("device", inf_cfg.inference_options.device)
    model = build_model(cfg, _num_classes(inf_cfg), taxonomy_tree, **kwargs)
    load_weights(model, inf_cfg.model.weights_path)
    logger.info(f"Loaded inference weights from {inf_cfg.model.weights_path}")
    return model


def build_model_for_inference(
    cfg: InferenceConfig,
    arch: str | Mapping[str, Any] | None = None,
    taxonomy_tree=None,
    **kwargs: Any,
) -> nn.Module:
    """The bundle's model (mFormerV1 or mFormerV0) with seeded random weights.

    With ``model.architecture_variant_config_path`` set, the merged config
    (:func:`build_config_for_inference`) decides the model through the
    config form of ``build_model``; only ``device`` and ``seed`` may be
    given beside it. Otherwise the keyword form: ``arch`` defaults to
    ``cfg.model.architecture_name``; ``kwargs`` go to ``build_model``
    (dtype, device, use_flash_attn, fused_convnext_mlp, seed, ...), and the
    plain attention path computes its scores in the compute dtype, the TPU
    package's serving default (``MODEL.ATTN_FP32_SOFTMAX: False``), unless
    ``attn_fp32_softmax=True`` is passed. The device defaults to
    ``cfg.inference_options.device``, whose "auto" is the CUDA device:
    without one this raises unless the CPU is asked for."""
    kwargs.setdefault("device", cfg.inference_options.device)
    if cfg.model.architecture_variant_config_path:
        given = sorted(set(kwargs) - {"device", "seed"}) + (["arch"] if arch is not None else [])
        if given:
            raise ValueError(
                f"model.architecture_variant_config_path is set: the merged config decides "
                f"the model, so {given} cannot be given beside it")
        return build_model(build_config_for_inference(cfg), _num_classes(cfg), taxonomy_tree,
                           **kwargs)
    c, h, w = cfg.input_preprocessing.image_size
    if h != w:
        raise ValueError(f"square images only, got {h}x{w}")
    kwargs.setdefault("attn_fp32_softmax", False)
    return build_model(
        arch if arch is not None else cfg.model.architecture_name,
        img_size=h,
        in_chans=c,
        num_classes=_num_classes(cfg),
        meta_components=meta_components_for_inference(cfg),
        taxonomy_tree=taxonomy_tree,
        **kwargs,
    )
