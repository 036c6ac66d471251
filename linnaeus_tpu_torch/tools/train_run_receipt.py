"""Distill a training run of the port's CLI into a receipt JSON.

Copy of linnaeus_tpu/tools/train_run_receipt.py for the port: the loss
curve from ``logs/metrics.jsonl``, per-epoch samples/sec, validation
metrics, checkpoint and resume events and ``model_params`` from the
Trainer's ``logs/main_p*.log`` (train/loop.py and utils/checkpoint.py log
these lines in the JAX Trainer's words), and the device: the card's name
and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them (``backend`` "cuda"), or "cpu" where no
card is present.

Usage:
    python -m linnaeus_tpu_torch.tools.train_run_receipt \
        --run-dir /tmp/trainrun384_out/linnaeus_tpu/receipts/tpu_trainrun_synth_384 \
        --out linnaeus_tpu_torch/receipts/train_run_h100_384.json
"""

from __future__ import annotations

import argparse
import json
import os
import re

from linnaeus_tpu_torch.utils.device import describe_device

_EPOCH_RE = re.compile(
    r"epoch (\d+) done: (\d+) samples in ([\d.]+)s \(([\d.]+) img/s\)"
)
_RESUME_RE = re.compile(r"Resumed from (\S+) at step (\d+)")
_CKPT_RE = re.compile(r"Saved checkpoint at step (\d+)")
_VAL_RE = re.compile(r"\[(val[\w]*)\] step (\d+) (.*)")


def _downsample(curve: list[list[float]], max_points: int) -> list[list[float]]:
    if len(curve) <= max_points:
        return curve
    stride = (len(curve) + max_points - 1) // max_points
    kept = curve[::stride]
    if kept[-1] != curve[-1]:
        kept.append(curve[-1])
    return kept


def build_receipt(run_dir: str, max_curve_points: int = 120) -> dict:
    logs = os.path.join(run_dir, "logs")
    receipt: dict = {"run_dir": os.path.abspath(run_dir)}

    # the device at extraction time
    receipt["device"], receipt["backend"] = describe_device()

    # ---- metrics.jsonl: loss curve + validation summaries
    curve: list[list[float]] = []
    vals: list[dict] = []
    jsonl = os.path.join(logs, "metrics.jsonl")
    if os.path.isfile(jsonl):
        with open(jsonl) as f:
            for line in f:
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "train/loss" in row:
                    curve.append(
                        [int(row["step"]), round(float(row["train/loss"]), 4)]
                    )
                val_keys = [k for k in row if k.startswith("val")]
                if val_keys:
                    phase = val_keys[0].split("/", 1)[0]
                    vals.append(
                        {
                            "step": int(row["step"]),
                            "phase": phase,
                            **{
                                k.split("/", 1)[1]: round(float(v), 4)
                                for k, v in row.items()
                                if k.startswith(phase + "/")
                            },
                        }
                    )

    # ---- main logs: epoch throughput, resume + checkpoint events. A
    # resumed run appends to the same main_p0.log (same output dir), so one
    # pass collects both phases in order.
    epochs: list[dict] = []
    resumes: list[dict] = []
    n_ckpts = 0
    params = None
    for name in sorted(os.listdir(logs)) if os.path.isdir(logs) else []:
        if not (name.startswith("main_p") and name.endswith(".log")):
            continue
        with open(os.path.join(logs, name)) as f:
            for line in f:
                m = _EPOCH_RE.search(line)
                if m:
                    epochs.append(
                        {
                            "epoch": int(m.group(1)),
                            "samples": int(m.group(2)),
                            "seconds": float(m.group(3)),
                            "img_per_sec": float(m.group(4)),
                        }
                    )
                    continue
                m = _RESUME_RE.search(line)
                if m:
                    resumes.append(
                        {"checkpoint": m.group(1), "step": int(m.group(2))}
                    )
                    continue
                if _CKPT_RE.search(line):
                    n_ckpts += 1
                    continue
                if params is None and "Model params:" in line:
                    params = int(
                        line.split("Model params:")[1].strip().replace(",", "")
                    )

    if curve:
        receipt["loss_first"] = curve[0][1]
        receipt["loss_last"] = curve[-1][1]
        receipt["steps"] = curve[-1][0]
        receipt["loss_curve"] = _downsample(curve, max_curve_points)
    if params:
        receipt["model_params"] = params
    if epochs:
        receipt["epochs"] = epochs
        steady = [e["img_per_sec"] for e in epochs[1:]] or [
            epochs[0]["img_per_sec"]
        ]
        receipt["img_per_sec_steady"] = round(
            sum(steady) / len(steady), 1
        )
    if vals:
        receipt["validation"] = vals
    if resumes:
        receipt["resumes"] = resumes
    receipt["checkpoint_saves"] = n_ckpts
    return receipt


def main(argv=None) -> None:
    p = argparse.ArgumentParser("train_run_receipt")
    p.add_argument("--run-dir", required=True,
                   help="experiment output dir (contains logs/, checkpoints/)")
    p.add_argument("--out", default="train_run_receipt.json")
    p.add_argument("--max-curve-points", type=int, default=120)
    args = p.parse_args(argv)
    receipt = build_receipt(args.run_dir, args.max_curve_points)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(receipt, f, indent=1)
    print(json.dumps({
        "out": args.out,
        "steps": receipt.get("steps"),
        "loss_first": receipt.get("loss_first"),
        "loss_last": receipt.get("loss_last"),
        "resumes": len(receipt.get("resumes", [])),
        "validations": len(receipt.get("validation", [])),
    }))


if __name__ == "__main__":
    main()
