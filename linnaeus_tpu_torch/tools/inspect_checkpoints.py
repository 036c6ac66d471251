"""Checkpoint inspection CLI (reference parity: linnaeus/tools/inspect_checkpoints.py).

Port of linnaeus_tpu/tools/inspect_checkpoints.py for the port's
checkpoints (utils/checkpoint.py: ``sidecar.json`` beside ``state/state.pt``).

    python -m linnaeus_tpu_torch.tools.inspect_checkpoints <checkpoint_dir_or_path> [--params]

Lists checkpoints, their steps, sidecar metrics, and with ``--params`` the
shape of every model parameter (``tree``) and their count (``num_params``).
"""

from __future__ import annotations

import argparse
import json
import os


def inspect_checkpoint(path: str, show_params: bool = False) -> dict:
    from linnaeus_tpu_torch.utils.checkpoint import SIDECAR_NAME, STATE_DIR, STATE_FILE

    info: dict = {"path": path}
    sidecar_path = os.path.join(path, SIDECAR_NAME)
    if os.path.exists(sidecar_path):
        with open(sidecar_path) as f:
            sidecar = json.load(f)
        info["step"] = sidecar.get("step")
        info["metric_value"] = sidecar.get("metric_value")
        tp = sidecar.get("training_progress", {})
        info["epoch"] = tp.get("current_epoch")
        info["pending_validations"] = len(tp.get("pending_validations", []))
    state_file = os.path.join(path, STATE_DIR, STATE_FILE)
    if os.path.isfile(state_file) and show_params:
        import torch

        model = torch.load(state_file, map_location="cpu", weights_only=True)["model"]
        info["tree"] = {name: list(t.shape) for name, t in model.items()}
        info["num_params"] = sum(t.numel() for t in model.values())
    return info


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("inspect_checkpoints")
    parser.add_argument("path", help="checkpoint dir (or parent of checkpoints)")
    parser.add_argument("--params", action="store_true", help="show param tree")
    args = parser.parse_args(argv)

    from linnaeus_tpu_torch.utils.checkpoint import list_checkpoints

    targets = list_checkpoints(args.path) or [args.path]
    for t in targets:
        info = inspect_checkpoint(t, show_params=args.params)
        print(json.dumps(info, indent=2, default=str))


if __name__ == "__main__":
    main()
