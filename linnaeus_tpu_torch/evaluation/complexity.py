"""Model complexity estimation: params / FLOPs / activation memory.

Port of linnaeus_tpu/evaluation/complexity.py (reference parity:
tools/estimate_model_complexity.py), whose table is
docs/models/model_complexity_estimates.json.

What is counted, and how it differs from the TPU package's:

* params: every parameter's element count, exactly the TPU package's count
  of its Flax tree (the port keeps the same parameters).
* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one forward of a
  copy of the model on the meta device (no memory, no arithmetic), so the
  model's plain route runs: K1 and K2 are ctypes calls whose insides no
  counter can see, and their plain versions do the same products. The
  counter counts the matrix products and convolutions (2 per
  multiply-add), and nothing else. XLA's ``cost_analysis`` counts the
  compiled program's elementwise work as well (softmax, GELU, LayerNorm,
  the residual adds), so this count is lower: 26.77 against the stored
  27.97 GFLOPs a sample for mFormerV1_sm at 384 px (4.3%); the
  elementwise work is not added back, so the figure is the products' alone.
* activation memory: the card's peak allocation during one ``no_grad``
  forward, less what was allocated before it (the weights and the input):
  the working set of the forward. The TPU package reads
  ``memory_analysis().temp_size_in_bytes``, XLA's temporaries of the
  compiled forward, which is a neighbouring but not the same quantity.
  It is None off the card.
"""

from __future__ import annotations

import copy
import json
from typing import Any

import torch
from torch import nn

from linnaeus_tpu_torch.utils.logging import get_main_logger

logger = get_main_logger()


def count_params(params) -> int:
    """Element count of a module's parameters or of an iterable of tensors."""
    tensors = params.parameters() if isinstance(params, nn.Module) else params
    return int(sum(p.numel() for p in tensors))


def estimate_model_complexity(
    model: nn.Module,
    img_size: int | tuple[int, int] = 384,
    meta_dim: int = 5,
    batch_size: int = 1,
) -> dict[str, Any]:
    """Params, FLOPs a sample and (on the card) activation MB of ``model``'s
    forward on ``batch_size`` NHWC images of ``img_size`` with a
    ``meta_dim`` aux vector (module docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    hw = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
    n_params = count_params(model)
    meta = copy.deepcopy(model).to("meta").eval()
    images = torch.zeros((batch_size, hw[0], hw[1], 3), device="meta")
    aux = torch.zeros((batch_size, meta_dim), device="meta") if meta_dim else None
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        meta(images, aux)
    flops = float(counter.get_total_flops())

    activation_bytes = None
    device = next(model.parameters()).device
    if device.type == "cuda":
        x = torch.zeros((batch_size, hw[0], hw[1], 3), device=device)
        a = torch.zeros((batch_size, meta_dim), device=device) if meta_dim else None
        was_training = model.training
        model.eval()
        torch.cuda.synchronize(device)
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        with torch.no_grad():
            model(x, a)
        torch.cuda.synchronize(device)
        activation_bytes = torch.cuda.max_memory_allocated(device) - before
        model.train(was_training)

    result = {
        "params": n_params,
        "flops_per_sample": flops / batch_size if flops else None,
        "gflops_per_sample": flops / batch_size / 1e9 if flops else None,
        "activation_memory_mb": activation_bytes / 1e6 if activation_bytes else None,
        "img_size": hw[0],
    }
    logger.info(
        f"complexity: {n_params:,} params, "
        f"{result['gflops_per_sample'] or float('nan'):.2f} GFLOPs @ {hw[0]}px")
    return result


def estimate_all_archs(
    arch_names: list[str] | None = None,
    img_size: int = 384,
    num_classes: dict | None = None,
    output_path: str | None = None,
    device: torch.device | str = "meta",
) -> dict[str, dict]:
    """Sweep the registered arch presets (both families by default), each
    built from the default config as the TPU package builds it; on the meta
    device (FLOPs and params, no memory) unless ``device`` names a card."""
    from linnaeus_tpu_torch.configuration import get_default_config
    from linnaeus_tpu_torch.configuration.archs import (
        MFORMER_V0_ARCHS,
        MFORMER_V1_ARCHS,
        apply_arch,
    )
    from linnaeus_tpu_torch.models.build import build_model

    arch_names = arch_names or (list(MFORMER_V1_ARCHS) + list(MFORMER_V0_ARCHS))
    num_classes = num_classes or {
        "taxa_L10": 1000, "taxa_L20": 400, "taxa_L30": 100, "taxa_L40": 30}
    results = {}
    for name in arch_names:
        cfg = get_default_config()
        cfg.MODEL.IMG_SIZE = img_size
        cfg.DATA.TASK_KEYS_H5 = list(num_classes.keys())
        cfg.TRAIN.GRADIENT_CHECKPOINTING.ENABLED_NORMAL_STEPS = False
        cfg.TRAIN.MIXED_PRECISION.ENABLED = False
        apply_arch(cfg, name)
        if torch.device(device).type == "meta":
            with torch.device("meta"):
                model = build_model(cfg, num_classes=num_classes, device="meta")
        else:
            model = build_model(cfg, num_classes=num_classes, device=device)
        results[name] = estimate_model_complexity(model, img_size)
    if output_path:
        with open(output_path, "w") as f:
            json.dump(results, f, indent=2)
    return results


def validate_complexity_estimates(
    estimates_path: str,
    arch_names: list[str] | None = None,
    img_size: int = 384,
    flops_rtol: float = 0.05,
    device: torch.device | str = "meta",
) -> dict[str, dict]:
    """Recompute complexity and diff against a stored estimates JSON:
    params must match exactly; FLOPs within ``flops_rtol`` of the stored
    value (the TPU package's rule)."""
    with open(estimates_path) as f:
        stored = json.load(f)
    names = arch_names or list(stored)
    fresh = estimate_all_archs(names, img_size=img_size, device=device)
    report: dict[str, dict] = {}
    for name in names:
        st, fr = stored.get(name), fresh.get(name)
        ok = bool(st and fr and st["params"] == fr["params"])
        if ok and st.get("flops_per_sample") and fr.get("flops_per_sample"):
            ok = abs(st["flops_per_sample"] - fr["flops_per_sample"]) <= (
                flops_rtol * st["flops_per_sample"])
        report[name] = {"ok": ok, "stored": st, "fresh": fr}
        logger.info(f"validate {name}: {'OK' if ok else 'MISMATCH'}")
    return report
