"""A tiny geometry of every cell, for runs on the CPU: the published
configuration with its widths and depths cut and the traffic scaled down,
so that the harness, the reference and the comparisons run whole in
seconds. No number of such a run is a measurement."""

from __future__ import annotations

import json
from pathlib import Path

from benchmark import common

BENCH = common.load_json(common.ROOT.parent / "BENCHMARK.json")
SEED = 2**31 + 17  # above 32 signed bits, as the checks' seeds are


def tiny(doc: dict, traffic: dict) -> None:
    m = doc["config"]["MODEL"]
    m["IMG_SIZE"] = doc["config"]["DATA"]["IMG_SIZE"] = 64
    m["CONVNEXT_STAGES"]["DEPTHS"] = [1, 2, 9, 3]
    m["CONVNEXT_STAGES"]["DIMS"] = [16, 32, 64, 128]
    m["ROPE_STAGES"].update(DEPTHS=[2, 2], DIMS=[64, 128], NUM_HEADS=[2, 4])
    doc["num_classes"] = {"taxa_L10": 12, "taxa_L20": 6, "taxa_L30": 4, "taxa_L40": 3}
    traffic.update(batch=4, ring=3, warmup_steps=1)


def tiny_float32(doc: dict, traffic: dict) -> None:
    """The tiny geometry computed in float32 by the program, every step
    mixing and a third of the metadata masked: the program and the
    reference then agree to float32 rounding."""
    tiny(doc, traffic)
    cfg = doc["config"]
    cfg["TRAIN"]["MIXED_PRECISION"]["ENABLED"] = False
    cfg["TRAIN"]["AMP_OPT_LEVEL"] = "O0"
    cfg["SCHEDULE"]["MIX"]["PROB"]["START_PROB"] = 1.0
    cfg["SCHEDULE"]["META_MASKING"]["START_PROB"] = 0.3


def copy_tree(dst: Path) -> Path:
    """A copy of the benchmark's data files (configurations, mixes,
    metrics) under ``dst``, as a checkout would hold them."""
    for sub in ("configs", "traffic", "metrics"):
        (dst / sub).mkdir(parents=True)
        for f in (common.ROOT / sub).iterdir():
            if f.is_file():
                (dst / sub / f.name).write_bytes(f.read_bytes())
    return dst


def write_json(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))
