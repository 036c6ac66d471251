"""Model construction from an architecture preset.

Port of linnaeus_tpu/models/build.py for mFormerV1: the preset (a name from
configuration/archs.py, or a dict of the same shape) fixes the depths and
widths, and the arguments carry what the TPU package reads from its config.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from linnaeus_tpu_torch.configuration.archs import MFORMER_V1_ARCHS
from linnaeus_tpu_torch.models.mformer_v1 import MFormerV1
from linnaeus_tpu_torch.utils.device import resolve_device


def build_model(
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
) -> MFormerV1:
    """mFormerV1 for ``arch`` with seeded random weights, in eval mode, on
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
    """
    device = resolve_device(device)
    spec = MFORMER_V1_ARCHS[arch] if isinstance(arch, str) else arch
    model = MFormerV1(
        img_size=(img_size, img_size),
        in_chans=in_chans,
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
        dtype=dtype,
        seed=seed,
    )
    return model.to(device).eval()
