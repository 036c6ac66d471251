"""The readings the correctness limits are set from, on the card at the
cell's own size.

    python3 -m benchmark.calibrate --workload <cell> --seeds 12 --control-seeds 3

For each seed: the program's reading of every compared number against the
reference over its first three steps. For the first ``--control-seeds``
seeds also the control's (the reference in float8 products in the
program's place) and each fault's the cell can have: half of each batch
left out (the reference on the first half of the rows, the mean over
those), and the program's clip removed or set at half its limit. A state
left unchanged reads 1 on the change by construction and needs no run. One
JSON line a seed; the leaves that read worst are named, for the look the
limits' rules ask for.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from benchmark import common
from benchmark.drivers import train as train_driver


def worst_leaves(got: dict, ref: dict, key: str, n: int = 5) -> list:
    names = list(ref[key])
    r = np.array([ref[key][k] for k in names])
    g = np.array([got[key][k] for k in names])
    gap = np.abs(g - r) / np.maximum(r, np.median(r))
    return [[names[i], float(g[i]), float(r[i]), float(gap[i])] for i in np.argsort(-gap)[:n]]


def half_batch(ring: list) -> list:
    def cut(v):
        return {t: x[:x.shape[0] // 2] for t, x in v.items()} if isinstance(v, dict) \
            else v[:v.shape[0] // 2]
    return [{k: cut(v) for k, v in b.items()} for b in ring]


@contextlib.contextmanager
def planted_clip(factor: float):
    """The program's train step built with its clip limit times ``factor``
    (0: no clip), the configuration and the reference left as they are."""
    import linnaeus_tpu_torch.train.build as build

    real = build.make_train_step

    def planted(*args, **kwargs):
        kwargs["clip_grad"] = kwargs["clip_grad"] * factor
        return real(*args, **kwargs)

    build.make_train_step = planted
    try:
        yield
    finally:
        build.make_train_step = real


def program_run(doc, traffic, seed, device) -> train_driver.TrainDriver:
    d = train_driver.TrainDriver(doc, dict(traffic, warmup_steps=0), seed, device)
    d.setup()
    d.release()
    return d


def train_seed(doc, traffic, seed, device, control: bool) -> dict:
    d = program_run(doc, traffic, seed, device)
    out = {"seed": seed, "raw": {"program": d.recorded}}
    with train_driver.no_tf32():
        ref = d.reference()
        out["raw"]["reference"] = ref
        out["program"] = train_driver.compare(d.recorded, ref)
        out["program_worst_grad"] = worst_leaves(d.recorded, ref, "grad")
        out["program_worst_change"] = worst_leaves(d.recorded, ref, "change")
        if control:
            ctl = d.reference(quant=True)
            out["raw"]["control"] = ctl
            out["control"] = train_driver.compare(ctl, ref)
            out["control_worst_grad"] = worst_leaves(ctl, ref, "grad")
            full = d.ring
            d.ring = half_batch(full)
            half = d.reference()
            out["raw"]["fault_half_batch"] = half
            out["fault_half_batch"] = train_driver.compare(half, ref)
            d.ring = full
    if control:
        del d
        for name, factor in (("fault_clip_removed", 0.0), ("fault_clip_halved", 0.5)):
            with planted_clip(factor):
                f = program_run(doc, traffic, seed, device)
            out[name] = train_driver.compare(f.recorded, ref)
            del f
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser("benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=4_000_000_000)
    args = p.parse_args(argv)
    bench = common.load_json(common.ROOT.parent / "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    doc, traffic = common.config_file(cell["config"]), common.traffic_file(cell["traffic"])
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        print(json.dumps(train_seed(doc, traffic, seed, device, i < args.control_seeds)),
              flush=True)


if __name__ == "__main__":
    main()
