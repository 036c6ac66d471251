"""The training-level bar at full size: kernels on against the other routes.

Writes the receipt dataset of ``configs/experiments/tpu_trainrun_synth_384.yaml``
(8,192 hybrid samples at 384 px, ``tools/e2e_train_bench.py``), then trains
it through the CLI once per (seed, route), ``--parallel`` runs at a time on
the one card, and writes each run's receipt (``tools/train_run_receipt.py``)
under ``--out``. Routes: ``on`` and ``on2`` (kernels on, twice: do two runs
of one seed repeat?), ``off`` (the plain route), ``attn`` (K1 off with
float32 scores) and ``k2off`` (K2 off). The last line printed is one JSON
object: each run's validation loss at the last validation step, unrounded,
and each route's gap against the seed's ``on`` run.

    python -m linnaeus_tpu_torch.tools.bar_study --out build/bar/receipts
    python -m linnaeus_tpu_torch.tools.bar_study --seeds 42 --routes on on2 --gen 512 --epochs 1
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

CFG = "configs/experiments/tpu_trainrun_synth_384.yaml"
ROUTES = {
    "on": [],
    "on2": [],
    "off": ["MODEL.USE_FLASH_ATTN", "False", "MODEL.FUSED_CONVNEXT_MLP", "off"],
    "attn": ["MODEL.USE_FLASH_ATTN", "False", "MODEL.ATTN_FP32_SOFTMAX", "True"],
    "k2off": ["MODEL.FUSED_CONVNEXT_MLP", "off"],
}


def last_val_loss(run_dir: str) -> tuple[int, float] | None:
    """(step, loss) of the run's last ``val/loss`` row in logs/metrics.jsonl."""
    out = None
    with open(os.path.join(run_dir, "logs", "metrics.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            if "val/loss" in row:
                out = (int(row["step"]), float(row["val/loss"]))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("bar_study")
    ap.add_argument("--out", default="build/bar/receipts")
    ap.add_argument("--work", default="build/bar", help="dataset and run directories")
    ap.add_argument("--seeds", type=int, nargs="+", default=[42, 1, 2])
    ap.add_argument("--routes", nargs="+", default=list(ROUTES), choices=list(ROUTES))
    ap.add_argument("--parallel", type=int, default=5)
    ap.add_argument("--gen", type=int, default=8192)
    ap.add_argument("--epochs", type=int, default=0, help="0: the experiment's own")
    ap.add_argument("--timeout", type=float, default=1800.0, help="seconds a run")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    prefix = os.path.join(args.work, "trainrun")
    t0 = time.time()
    subprocess.run([sys.executable, "-m", "linnaeus_tpu_torch.tools.e2e_train_bench",
                    "--gen-only", "--gen-learnable", "--hybrid", "--img", "384",
                    "--gen", str(args.gen), "--prefix", prefix], check=True)
    gen_s = time.time() - t0
    base = ["DATA.HYBRID.USE_HYBRID", "True", "DATA.HYBRID.FILE_EXTENSION", ".jpg",
            "ENV.OUTPUT.BASE_DIR", os.path.join(args.work, "out"),
            "DATA.H5.LABELS_PATH", prefix + "_labels.npz",
            "DATA.HYBRID.IMAGES_DIR", prefix + "_images"]
    if args.epochs:
        base += ["TRAIN.EPOCHS", str(args.epochs)]
    env = dict(os.environ, CONFIG_DIR=os.getcwd(), PYTHONPATH=os.getcwd())

    def run(job):
        seed, route = job
        name = f"s{seed}_{route}"
        run_dir = os.path.join(args.work, "out", "linnaeus_tpu", "receipts", name)
        cmd = [sys.executable, "-m", "linnaeus_tpu_torch.train.main", "--cfg", CFG, "--opts",
               *base, "EXPERIMENT.NAME", name, "MISC.SEED", str(seed), *ROUTES[route]]
        t = time.time()
        with open(os.path.join(args.out, name + ".log"), "w") as log:
            rc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT, env=env,
                                timeout=args.timeout).returncode
        seconds = time.time() - t
        if rc != 0:
            return name, {"rc": rc, "seconds": seconds}
        subprocess.run([sys.executable, "-m", "linnaeus_tpu_torch.tools.train_run_receipt",
                        "--run-dir", run_dir, "--out", os.path.join(args.out, name + ".json")],
                       check=True, env=env, stdout=subprocess.DEVNULL)
        step, loss = last_val_loss(run_dir)
        return name, {"rc": 0, "seconds": seconds, "val_step": step, "val_loss": loss}

    jobs = [(s, r) for s in args.seeds for r in args.routes]
    with ThreadPoolExecutor(max_workers=args.parallel) as pool:
        runs = dict(pool.map(run, jobs))
    gaps = {}
    for seed in args.seeds:
        ref = runs.get(f"s{seed}_on", {}).get("val_loss")
        for route in args.routes:
            loss = runs.get(f"s{seed}_{route}", {}).get("val_loss")
            if route != "on" and ref is not None and loss is not None:
                gaps[f"s{seed}_{route}"] = (loss - ref) / ref
    print(json.dumps({"gen_seconds": gen_s, "runs": runs, "gap_vs_on": gaps}))
    if any(r["rc"] for r in runs.values()):
        sys.exit(1)


if __name__ == "__main__":
    main()
