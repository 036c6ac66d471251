"""Model construction for inference.

Port of the config bridge in linnaeus_tpu/inference/model_utils.py: the
inference config's image size, tasks and metadata switches decide the
mFormerV1 built for it. Weights are loaded by the caller with
``load_state_dict`` (e.g. from :func:`linnaeus_tpu_torch.utils.convert.state_dict_from_jax`).
"""

from __future__ import annotations

from typing import Any, Mapping

from linnaeus_tpu_torch.models.build import build_model
from linnaeus_tpu_torch.models.mformer_v1 import MFormerV1

from .config import InferenceConfig


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


def build_model_for_inference(
    cfg: InferenceConfig,
    arch: str | Mapping[str, Any] | None = None,
    **kwargs: Any,
) -> MFormerV1:
    """mFormerV1 for ``cfg`` with seeded random weights; ``arch`` defaults to
    ``cfg.model.architecture_name``; ``kwargs`` go to ``build_model``
    (dtype, device, use_flash_attn, fused_convnext_mlp, seed, ...). The
    device defaults to ``cfg.inference_options.device``, whose "auto" is the
    CUDA device: without one this raises unless the CPU is asked for. The
    plain attention path computes its scores in the compute dtype, the TPU
    package's serving default (``MODEL.ATTN_FP32_SOFTMAX: False``), unless
    ``attn_fp32_softmax=True`` is passed. A config that sets
    ``model.architecture_variant_config_path`` raises: merging a variant
    file over the preset is not ported, and building the preset without it
    would be a different model."""
    if cfg.model.architecture_variant_config_path:
        raise NotImplementedError(
            "model.architecture_variant_config_path="
            f"{cfg.model.architecture_variant_config_path!r}: merging an architecture "
            "variant file is not ported; pass the merged architecture as `arch`"
        )
    c, h, w = cfg.input_preprocessing.image_size
    if h != w:
        raise ValueError(f"square images only, got {h}x{w}")
    kwargs.setdefault("device", cfg.inference_options.device)
    kwargs.setdefault("attn_fp32_softmax", False)
    return build_model(
        arch if arch is not None else cfg.model.architecture_name,
        img_size=h,
        in_chans=c,
        num_classes=dict(zip(cfg.model.model_task_keys_ordered,
                             cfg.model.num_classes_per_task)),
        meta_components=meta_components_for_inference(cfg),
        **kwargs,
    )

