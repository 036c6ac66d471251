"""Export a trained checkpoint to a state_dict the reference's mFormerV1 loads.

Port of linnaeus_tpu/tools/export_torch.py: the way back. It reads a port
training checkpoint directory (``<dir>/state/state.pt``, utils/checkpoint.py)
and writes the model's weights in the reference layout through
``utils/pretrained.py::export_reference_mformer_v1``, the inverse of the
reference loader over the same entries. The geometry comes from the config
alone (no model is built, so hierarchical heads need no taxonomy tree; a
head other than Linear has no reference counterpart and is left out).

An MoE checkpoint exports its dense twin: each expert bank averaged into
the dense MLP (``average_experts_into_dense``; exact while the experts are
replicas, as after upcycling, a best-effort distillation otherwise; the
reference has no MoE to receive the banks). The routers are left out.

    python -m linnaeus_tpu_torch.tools.export_torch \\
        --cfg experiment.yaml --checkpoint <run>/checkpoints/checkpoint_step_<n> --out model.pth
"""

from __future__ import annotations

import argparse

import torch


def export_checkpoint(config, checkpoint_path: str, out_path: str) -> dict[str, torch.Tensor]:
    """Write the reference-layout state_dict of ``checkpoint_path`` to
    ``out_path`` and return it."""
    from linnaeus_tpu_torch.utils.checkpoint import read_model_state
    from linnaeus_tpu_torch.utils.meta import get_enabled_meta_components
    from linnaeus_tpu_torch.utils.pretrained import (
        _is_moe_params,
        average_experts_into_dense,
        export_reference_mformer_v1,
    )

    if str(config.MODEL.TYPE) != "mFormerV1":
        raise ValueError(
            "export_torch supports mFormerV1 (the reference's flagship); mFormerV0 checkpoints "
            "come from MetaFG torch weights in the first place")
    state = read_model_state(checkpoint_path)
    if _is_moe_params(state):
        state = average_experts_into_dense(state)
    sd = export_reference_mformer_v1(
        state,
        convnext_depths=tuple(config.MODEL.CONVNEXT_STAGES.DEPTHS),
        rope_depths=tuple(config.MODEL.ROPE_STAGES.DEPTHS),
        meta_names=tuple(n for n, _ in get_enabled_meta_components(config)),
        task_keys=tuple(config.DATA.TASK_KEYS_H5),
    )
    torch.save({k: v.contiguous() for k, v in sd.items()}, out_path)
    return sd


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("export_torch")
    parser.add_argument("--cfg", required=True, help="experiment yaml")
    parser.add_argument("--checkpoint", required=True, help="checkpoint directory")
    parser.add_argument("--out", required=True, help="output .pth path")
    parser.add_argument("--opts", nargs=argparse.REMAINDER, default=None,
                        help="config overrides, KEY VALUE pairs")
    args = parser.parse_args(argv)

    from linnaeus_tpu_torch.configuration import build_config

    config = build_config(args.cfg, args.opts)
    sd = export_checkpoint(config, args.checkpoint, args.out)
    print(f"exported {len(sd)} tensors -> {args.out}")


if __name__ == "__main__":
    main()
