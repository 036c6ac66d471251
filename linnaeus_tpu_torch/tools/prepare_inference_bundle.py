"""Assemble an inference bundle from a training run.

Port of linnaeus_tpu/tools/prepare_inference_bundle.py (reference parity:
tools/prepare_inference_bundle.py) for the port's checkpoints: from a
checkpoint directory (``state/state.pt``, utils/checkpoint.py) and the run's
``assets/`` (``dataset_metadata.json``, ``taxonomy.json``) it writes
``taxonomy.json``, ``class_map.json``, ``config.yaml`` and ``weights.pt``, a
torch ``state_dict`` that ``LinnaeusInferenceHandler.load_from_artifacts``
reads. The config is the TPU package's but for ``weights_path``.

    python -m linnaeus_tpu_torch.tools.prepare_inference_bundle --checkpoint CKPT \\
        --assets ASSETS --output OUT --arch mFormerV1_sm --task-keys taxa_L10 ... \\
        --num-classes 1000 ... [--image-size 384] [--ema]

The config names the architecture preset only; a run whose model differs
from the preset (other heads, flash attention on) needs an architecture
variant file named in ``model.architecture_variant_config_path``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil


def _meta_in_dim(weights: dict, name: str) -> int | None:
    """Input width of a metadata head's first Linear (``<head>.0.weight``,
    (out, in)), the stage-2 head standing in for a missing stage-1 one."""
    for head in (name, name.replace("_1", "_2")):
        w = weights.get(f"{head}.0.weight")
        if w is not None:
            return int(w.shape[1])
    return None


def prepare_bundle(
    checkpoint_path: str,
    assets_dir: str,
    output_dir: str,
    architecture_name: str,
    task_keys: list[str],
    num_classes: list[int],
    image_size: int = 224,
    description: str | None = None,
    use_ema: bool = False,
) -> str:
    """Build the bundle; returns the output directory."""
    import torch
    import yaml

    from linnaeus_tpu_torch.utils.checkpoint import STATE_DIR, STATE_FILE

    os.makedirs(output_dir, exist_ok=True)

    # 1) taxonomy + class maps from assets
    shutil.copy(os.path.join(assets_dir, "taxonomy.json"),
                os.path.join(output_dir, "taxonomy.json"))
    with open(os.path.join(assets_dir, "dataset_metadata.json")) as f:
        ds_meta = json.load(f)
    # class_map: task -> {model_idx: taxon_id} inverted from class_to_idx
    class_map = {}
    for task, mapping in ds_meta["class_to_idx"].items():
        class_map[task] = {
            str(idx): (0 if key == "null" else int(key))
            for key, idx in mapping.items()
        }
    with open(os.path.join(output_dir, "class_map.json"), "w") as f:
        json.dump(class_map, f, indent=2)

    # 2) weights: the checkpoint's model state_dict, or its EMA
    saved = torch.load(os.path.join(checkpoint_path, STATE_DIR, STATE_FILE),
                       map_location="cpu", weights_only=True)
    weights = dict(saved["model"])
    if use_ema:
        if saved.get("ema_params") is None:
            raise ValueError(
                "--ema requested but the checkpoint carries no ema_params "
                "(train with TRAIN.EMA.ENABLED)"
            )
        weights.update(saved["ema_params"])
    torch.save(weights, os.path.join(output_dir, "weights.pt"))

    # 3) metadata flags derived from the checkpoint's own meta heads: the
    # model only creates heads for enabled components, so the weights are
    # ground truth; writing {} would fall back to the defaults (elevation
    # on) and break restores of runs trained without elevation
    t_dim = _meta_in_dim(weights, "meta_temporal_head_1")
    s_dim = _meta_in_dim(weights, "meta_spatial_head_1")
    e_dim = _meta_in_dim(weights, "meta_elevation_head_1")
    meta_pre: dict = {
        "use_temporal": t_dim is not None,
        "temporal_use_hour": t_dim == 4,
        "use_geolocation": s_dim is not None,
        "use_elevation": e_dim is not None,
    }
    if e_dim:
        # 2 sinusoidal features per scale; the scale values are training
        # configuration the checkpoint does not carry: defaults of the right
        # count (editable in the emitted yaml)
        scales = [100.0, 1000.0, 5000.0][: e_dim // 2]
        while len(scales) < e_dim // 2:
            scales.append(scales[-1] * 10.0)
        meta_pre["elevation_scales"] = scales
    else:
        meta_pre["elevation_scales"] = []
    aux_len = (t_dim or 0) + (s_dim or 0) + (e_dim or 0)

    config = {
        "model": {
            "architecture_name": architecture_name,
            "weights_path": "weights.pt",
            "model_task_keys_ordered": list(task_keys),
            "num_classes_per_task": [int(n) for n in num_classes],
            "null_class_indices": {t: 0 for t in task_keys},
            "expected_aux_vector_length": aux_len,
        },
        "input_preprocessing": {"image_size": [3, image_size, image_size]},
        "metadata_preprocessing": meta_pre,
        "taxonomy_data": {
            "source_name": "linnaeus_tpu",
            "taxonomy_tree_path": "taxonomy.json",
            "class_index_map_path": "class_map.json",
        },
        "inference_options": {},
        "model_description": description,
    }
    with open(os.path.join(output_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(config, f, sort_keys=False)
    return output_dir


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("prepare_inference_bundle")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--assets", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--arch", required=True)
    parser.add_argument("--task-keys", nargs="+", required=True)
    parser.add_argument("--num-classes", nargs="+", type=int, required=True)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument(
        "--ema", action="store_true",
        help="bundle the EMA weights instead of the raw params",
    )
    args = parser.parse_args(argv)
    out = prepare_bundle(
        args.checkpoint, args.assets, args.output, args.arch,
        args.task_keys, args.num_classes, args.image_size,
        use_ema=args.ema,
    )
    print(f"bundle written to {out}")


if __name__ == "__main__":
    main()
