"""AutoBatch sweeps over memory fractions.

Port of linnaeus_tpu/tools/analyze_batch_sizes.py (reference parity:
tools/analyze_batch_sizes.py): for each target share of the card's memory,
the largest batch whose step fits, by train/autobatch.py's search. Where the
TPU tool compiles the forward and reads its memory analysis, a trial here
runs the forward at the candidate batch on the card and reads its peak
(``measure_peak_bytes``); without a card it raises by name.

    python -m linnaeus_tpu_torch.tools.analyze_batch_sizes --arch mFormerV1_sm --img-size 384
"""

from __future__ import annotations

import argparse
import json
from typing import Callable


def sweep_memory_fractions(
    measure: Callable[[int], int],
    fractions=(0.5, 0.6, 0.7, 0.8, 0.9),
    min_batch: int = 1,
    max_batch: int = 1024,
    total_bytes: int = 0,
    multiple_of: int = 1,
) -> dict[float, int]:
    """{fraction: the largest batch whose ``measure(batch)`` bytes fit
    ``total_bytes * fraction``}."""
    from linnaeus_tpu_torch.train.autobatch import auto_find_batch_size

    return {
        f: auto_find_batch_size(measure, f, min_batch, max_batch,
                                total_bytes=total_bytes, multiple_of=multiple_of)
        for f in fractions
    }


def main(argv=None) -> dict[float, int]:
    parser = argparse.ArgumentParser("analyze_batch_sizes")
    parser.add_argument("--arch", default="mFormerV1_sm")
    parser.add_argument("--img-size", type=int, default=224)
    parser.add_argument("--fractions", nargs="*", type=float, default=[0.5, 0.7, 0.8, 0.9])
    parser.add_argument("--max-batch", type=int, default=1024)
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args(argv)

    import torch

    from linnaeus_tpu_torch.configuration import get_default_config
    from linnaeus_tpu_torch.configuration.archs import apply_arch
    from linnaeus_tpu_torch.models.build import build_model
    from linnaeus_tpu_torch.train.autobatch import device_memory_bytes, measure_peak_bytes
    from linnaeus_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    total = device_memory_bytes(device)  # raises by name off the card
    cfg = get_default_config()
    cfg.MODEL.IMG_SIZE = args.img_size
    cfg.TRAIN.GRADIENT_CHECKPOINTING.ENABLED_NORMAL_STEPS = False
    apply_arch(cfg, args.arch)
    num_classes = {"taxa_L10": 1000, "taxa_L20": 400, "taxa_L30": 100, "taxa_L40": 30}
    cfg.DATA.TASK_KEYS_H5 = list(num_classes)
    model = build_model(cfg, num_classes=num_classes, device=device)

    def forward(bs: int) -> None:
        images = torch.zeros(bs, args.img_size, args.img_size, 3, device=device)
        aux = torch.zeros(bs, 5, device=device)
        with torch.inference_mode():
            model(images, aux)

    results = sweep_memory_fractions(
        lambda bs: measure_peak_bytes(forward, bs, device), args.fractions,
        max_batch=args.max_batch, total_bytes=total)
    print(json.dumps({str(k): v for k, v in results.items()}, indent=2))
    return results


if __name__ == "__main__":
    main()
