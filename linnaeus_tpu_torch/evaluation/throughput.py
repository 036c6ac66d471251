"""Synthetic throughput test (reference parity: evaluation/throughput_tester.py:13).

Port of linnaeus_tpu/evaluation/throughput.py. ``throughput_test`` sweeps
batch sizes with synthetic inputs and reports images/s and ms a batch of
the forward (the configured train step is timed by tools/train_bench.py). The
inputs are drawn afresh every iteration from a ``torch.Generator`` on the
model's device, as the TPU package draws them from a folded key, so no
cache can fake the rate. On CUDA the time is taken with CUDA events around
the timed iterations, on the CPU with the host clock. The metadata is as
wide as the model's metadata components (the TPU package takes
``meta_dim``, 5 by default, for a model built from a config too).

``evaluation/complexity.py`` (FLOPs from XLA's cost analysis) is not
ported: ``torch.utils.flop_counter`` counts different work.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

from linnaeus_tpu_torch.utils.logging import get_main_logger

logger = get_main_logger()


def generate_synthetic_data(generator: torch.Generator, batch_size: int, img_hw,
                            meta_dim: int, dtype: torch.dtype = torch.float32):
    """Normal NHWC images and metadata (None when ``meta_dim`` is 0) drawn
    from ``generator`` on its device."""
    dev = generator.device
    images = torch.randn((batch_size, img_hw[0], img_hw[1], 3), generator=generator,
                         device=dev, dtype=dtype)
    aux = (torch.randn((batch_size, meta_dim), generator=generator, device=dev, dtype=dtype)
           if meta_dim else None)
    return images, aux


def _timed(device: torch.device, fn: Callable[[], Any], iters: int) -> float:
    """Seconds for ``iters`` calls of ``fn``."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1000.0
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return time.perf_counter() - t0


def throughput_test(
    config=None,
    model: torch.nn.Module | None = None,
    batch_sizes: list[int] | None = None,
    warmup: int = 3,
    iters: int = 10,
    meta_dim: int | None = None,
    device: torch.device | str | None = None,
) -> dict[int, dict[str, float]]:
    """{batch size: {"images_per_sec", "latency_ms"}} of the forward in
    eval mode. Without ``model`` it is built from ``config`` (its compute
    dtype, MODEL.IMG_SIZE, MODEL.NUM_CLASSES by DATA.TASK_KEYS_H5) on
    ``device`` (the CUDA device unless told otherwise); a given model's
    inputs are float32 at its image size. ``meta_dim`` defaults to the
    model's metadata width."""
    if model is None:
        from linnaeus_tpu_torch.models.build import build_model

        num_classes = None
        if config.MODEL.NUM_CLASSES:
            num_classes = dict(zip(config.DATA.TASK_KEYS_H5, config.MODEL.NUM_CLASSES))
        model = build_model(config, num_classes, device=device)
        img = config.MODEL.IMG_SIZE
        img_hw = (img, img) if isinstance(img, int) else tuple(img)
    else:
        img_hw = (16 * model.grid3[0], 16 * model.grid3[1])
    if meta_dim is None:
        meta_dim = sum(dim for _, dim in model.meta_components)
    dev = next(model.parameters()).device
    model.eval()
    batch_sizes = batch_sizes or [32, 64, 128, 256]
    results = {}
    for bs in batch_sizes:
        g = torch.Generator(device=dev).manual_seed(0)

        def forward_sum(_bs=bs):
            images, aux = generate_synthetic_data(g, _bs, img_hw, meta_dim)
            out = model(images, aux)
            return sum(v.float().sum() for v in out.values())

        with torch.inference_mode():
            for _ in range(warmup):
                float(forward_sum())
            elapsed = _timed(dev, forward_sum, iters)
        results[bs] = {"images_per_sec": bs * iters / elapsed,
                       "latency_ms": 1000 * elapsed / iters}
        logger.info(
            f"throughput bs={bs}: {results[bs]['images_per_sec']:.1f} img/s, "
            f"{results[bs]['latency_ms']:.2f} ms/batch"
        )
    return results

