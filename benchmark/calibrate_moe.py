"""``calibrate.py``'s readings for a cell of kind ``train_moe``, on the card
at the cell's own size.

    python3 -m benchmark.calibrate_moe --workload v1_sm_moe.train384 --seeds 8 --control-seeds 4

For each seed: the program's reading of every compared number
(``drivers/train_moe.py::compare``) against the reference under the
program's routing. For the first ``--control-seeds`` seeds also the
control's (the reference in float8 products, under the same routing, in
the program's place), the reference's own routing against the held one
(``free_routing``: what a check without the routing operand would read),
and each fault's: half of each batch left out (the reference on the first
half of the rows and of the routing), the program's clip removed or set
at half its limit, and its expert capacity halved (``planted_capacity``:
the program drops what the reference keeps). A state left unchanged reads
1 on the change by construction and needs no run. One JSON line a seed.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import torch

from benchmark import calibrate, common
from benchmark.drivers import train as base
from benchmark.drivers import train_moe


@contextlib.contextmanager
def planted_capacity(factor: float):
    """The program's expert layers built with ``factor`` times the slots an
    expert their ``capacity`` gives (at least one), the reference left as
    it is."""
    from linnaeus_tpu_torch.models.blocks import moe

    real = moe.capacity

    def planted(*args):
        return max(1, int(real(*args) * factor))

    moe.capacity = planted
    try:
        yield
    finally:
        moe.capacity = real


def program_run(doc, traffic, seed, device) -> train_moe.TrainMoEDriver:
    d = train_moe.TrainMoEDriver(doc, dict(traffic, warmup_steps=0), seed, device)
    d.setup()
    d.release()
    return d


def train_seed(doc, traffic, seed, device, control: bool) -> dict:
    d = program_run(doc, traffic, seed, device)
    out = {"seed": seed}
    with base.no_tf32():
        ref = d.reference()
        out["program"] = train_moe.compare(d.recorded, ref)
        out["program_worst_grad"] = calibrate.worst_leaves(d.recorded, ref, "grad")
        out["program_worst_change"] = calibrate.worst_leaves(d.recorded, ref, "change")
        if control:
            ctl = d.reference(quant=True)
            out["control"] = train_moe.compare(ctl, ref)
            out["control_worst_grad"] = calibrate.worst_leaves(ctl, ref, "grad")
            out["free_routing"] = train_moe.compare(d.recorded, d.reference(hold=False))
            full = d.ring
            d.ring = calibrate.half_batch(full)
            out["fault_half_batch"] = train_moe.compare(d.reference(), ref)
            d.ring = full
    if control:
        del d
        for name, plant in (("fault_clip_removed", calibrate.planted_clip(0.0)),
                            ("fault_clip_halved", calibrate.planted_clip(0.5)),
                            ("fault_capacity_halved", planted_capacity(0.5))):
            with plant:
                f = program_run(doc, traffic, seed, device)
            out[name] = train_moe.compare(f.recorded, ref)
            del f
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser("benchmark.calibrate_moe")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=8)
    p.add_argument("--control-seeds", type=int, default=4)
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
