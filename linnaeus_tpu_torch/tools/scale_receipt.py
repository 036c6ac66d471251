"""Data-pipeline scale receipt: wall time and peak RSS at 16k/100k/1M rows.

Port of linnaeus_tpu/tools/scale_receipt.py. Every phase runs in its own
subprocess, so ``ru_maxrss`` is that phase's own peak, and phase walls can be
compared across row counts for super-linear cliffs. The labels are ``.npz``
(``data/processor.py::write_labels_npz``) and the images a JPEG directory
(DATA.HYBRID), which the port reads without h5py, as ``data/build.py`` does.

Phases per row count:
  * ``processor``: DatasetProcessor.process_single_file's one-pass scan
    (class maps, label projection, hierarchy map) and the TaxonomyTree
    build (timed apart), wall and peak RSS;
  * ``sampler``: GroupedBatchSampler's mixed-pairs epoch construction (two
    epochs: build and reshuffle), wall and peak RSS;
  * ``loader``: the production loader's host feed over ``--feed-batches``
    batches, no device transfer (needs ``--with-images``);
  * ``cli``: the training CLI from start to its first step log line
    (config, processor, sampler, loader warm-up, model build, step 1), on
    the card unless ``--device cpu`` (needs ``--with-images``).

Usage:
    python -m linnaeus_tpu_torch.tools.scale_receipt --rows 16384 100000 1000000 \\
        --with-images --out build/scale_receipt.json
    python -m linnaeus_tpu_torch.tools.scale_receipt --rows 4096 --dir build/scale
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import resource
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

TASKS = ["taxa_L10", "taxa_L20", "taxa_L30", "taxa_L40"]
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ----------------------------------------------------------------- dataset
def generate_labels(path: str, n: int) -> None:
    """Hierarchy-consistent 4-level labels and 5-dim meta from the shared
    taxonomy generator (tools/e2e_train_bench.py::hierarchy_labels), about
    2% all-level nulls; the TPU package's arrays, written as ``.npz``."""
    from linnaeus_tpu_torch.data.processor import write_labels_npz
    from linnaeus_tpu_torch.tools.e2e_train_bench import hierarchy_labels

    rng = np.random.default_rng(0)
    l10, l20, l30, l40, _ = hierarchy_labels(n, null_frac=0.02, rng=rng)
    write_labels_npz(path, {
        "img_identifiers": np.char.add("i", np.arange(n).astype(str)).astype("S12"),
        "taxa_L10": l10.astype(np.int64), "taxa_L20": l20, "taxa_L30": l30,
        "taxa_L40": l40,
        "temporal": rng.normal(size=(n, 2)).astype("f4"),
        "spatial": rng.normal(size=(n, 3)).astype("f4"),
    })


def generate_images(path: str, n: int, img: int) -> None:
    """``<path>/i<k>.jpg``: a flat image of value k % 251, as the TPU
    package's byte pattern (feed-rate probes read files, not semantics);
    the 251 encodings are made once and written under every name."""
    from PIL import Image

    os.makedirs(path, exist_ok=True)
    encoded = []
    for v in range(251):
        buf = io.BytesIO()
        Image.fromarray(np.full((img, img, 3), v, np.uint8)).save(buf, format="JPEG",
                                                                    quality=95)
        encoded.append(buf.getvalue())

    def write(k: int) -> None:
        with open(os.path.join(path, f"i{k}.jpg"), "wb") as f:
            f.write(encoded[k % 251])

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(write, range(n), chunksize=4096))


def _cfg(labels: str, images: str | None, img: int):
    from linnaeus_tpu_torch.configuration import get_default_config

    cfg = get_default_config()
    cfg.DATA.TASK_KEYS_H5 = list(TASKS)
    cfg.DATA.PARTIAL.LEVELS = True
    cfg.DATA.IMG_SIZE = img
    cfg.DATA.H5.LABELS_PATH = labels
    if images:
        cfg.DATA.HYBRID.USE_HYBRID = True
        cfg.DATA.HYBRID.IMAGES_DIR = images
        cfg.DATA.HYBRID.FILE_EXTENSION = ".jpg"
    return cfg


def _phase_result(t0: float, **extra) -> dict:
    return {
        "wall_s": round(time.perf_counter() - t0, 2),
        "peak_rss_mb": round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0, 1),
        **extra,
    }


# ------------------------------------------------------------------ phases
def phase_processor(labels: str, img: int) -> dict:
    from linnaeus_tpu_torch.data.processor import DatasetProcessor
    from linnaeus_tpu_torch.utils.taxonomy.tree import TaxonomyTree

    cfg = _cfg(labels, None, img)
    t0 = time.perf_counter()
    proc = DatasetProcessor(cfg)
    _, _, train_idx, val_idx = proc.process_single_file(labels, 0.9)
    t_proc = time.perf_counter() - t0
    t1 = time.perf_counter()
    TaxonomyTree(hierarchy_map=proc.hierarchy_map, task_keys=proc.task_keys,
                 num_classes=proc.num_classes)
    t_tree = time.perf_counter() - t1
    return _phase_result(t0, processor_wall_s=round(t_proc, 2), tree_wall_s=round(t_tree, 3),
                         n_train=int(len(train_idx)), n_val=int(len(val_idx)),
                         n_classes=dict(proc.num_classes))


def phase_sampler(labels: str, img: int, batch: int) -> dict:
    from linnaeus_tpu_torch.data.processor import DatasetProcessor
    from linnaeus_tpu_torch.data.sampler import GroupedBatchSampler

    proc = DatasetProcessor(_cfg(labels, None, img))
    data, _, train_idx, _ = proc.process_single_file(labels, 0.9)
    groups = {t: np.asarray(data.labels[t], np.int64) for t in proc.task_keys[:2]}
    t0 = time.perf_counter()
    s = GroupedBatchSampler(groups, train_idx, batch, mode="mixed-pairs",
                            initial_level=proc.task_keys[1])
    n_b0 = len(s.batches())
    t_epoch0 = time.perf_counter() - t0
    t1 = time.perf_counter()
    s.set_epoch(1)
    n_b1 = len(s.batches())
    t_epoch1 = time.perf_counter() - t1
    return _phase_result(t0, epoch0_s=round(t_epoch0, 2), epoch1_s=round(t_epoch1, 2),
                         batches=int(n_b0), batches_epoch1=int(n_b1))


def phase_loader(labels: str, images: str, img: int, batch: int, feed_batches: int) -> dict:
    from linnaeus_tpu_torch.tools.e2e_train_bench import _steady_feed

    t0 = time.perf_counter()
    cold, steady = _steady_feed(labels, images, batch, io_threads=8, window=4, depth=2,
                                direct_chunk="auto", feed_warmup=10, feed_steady=feed_batches,
                                img=img)
    return _phase_result(t0, host_feed_images_per_sec_cold=round(cold, 1),
                         host_feed_images_per_sec_steady=round(steady, 1))


def phase_cli(labels: str, images: str, img: int, batch: int, out_dir: str,
              device: str | None = None, timeout_s: float = 1200.0) -> dict:
    """The training CLI from exec to its first optimizer-step log line,
    then terminated: the number a user feels at 1M rows."""
    import yaml

    # a fresh output tree: TRAIN.AUTO_RESUME would resume a leftover run
    tag = os.path.basename(labels).replace(".npz", "")
    run_base = os.path.join(out_dir, f"cli_out_{tag}")
    shutil.rmtree(run_base, ignore_errors=True)
    cfg_path = os.path.join(out_dir, f"scale_cli_{tag}.yaml")
    cfg = {
        "EXPERIMENT": {"NAME": "scale_cli"},
        "ENV": {"OUTPUT": {"BASE_DIR": os.path.abspath(run_base)}},
        "DATA": {
            "TASK_KEYS_H5": list(TASKS), "PARTIAL": {"LEVELS": True},
            "IMG_SIZE": img, "BATCH_SIZE": batch, "BATCH_SIZE_VAL": batch,
            "H5": {"LABELS_PATH": os.path.abspath(labels), "TRAIN_VAL_SPLIT_RATIO": 0.9},
            "HYBRID": {"USE_HYBRID": True, "IMAGES_DIR": os.path.abspath(images),
                       "FILE_EXTENSION": ".jpg"},
            "SAMPLER": {"GROUPED_MODE": "mixed-pairs"},
            "PREFETCH": {"MEM_CACHE_SIZE": 0},
        },
        "AUG": {"AUTOAUG": {"POLICY": "", "COLOR_JITTER": 0.0}, "RANDOM_ERASE": {"PROB": 0.0}},
        "MODEL": {
            "TYPE": "mFormerV1", "NAME": "tiny", "IMG_SIZE": img, "DROP_PATH_RATE": 0.0,
            "CONVNEXT_STAGES": {"DEPTHS": [1, 1, 1, 1], "DIMS": [8, 16, 32, 64]},
            "ROPE_STAGES": {"DEPTHS": [1, 1], "DIMS": [32, 64], "NUM_HEADS": [2, 2],
                            "MLP_RATIO": [2.0, 2.0]},
            "CLASSIFICATION": {"HEADS": {t: {"TYPE": "Linear"} for t in TASKS}},
        },
        "TRAIN": {"EPOCHS": 1, "MIXED_PRECISION": {"ENABLED": False}, "AUTO_RESUME": False},
        "LR_SCHEDULER": {"WARMUP_EPOCHS": 0, "WARMUP_STEPS": 1, "REFERENCE_BS": batch},
        "SCHEDULE": {"METRICS": {"CONSOLE_INTERVAL": 1}},
    }
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    cmd = [sys.executable, "-m", "linnaeus_tpu_torch.train.main", "--cfg", os.path.abspath(cfg_path)]
    if device:
        cmd += ["--device", device]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=ROOT)
    first_step_s = None
    lines: list[str] = []
    step_re = re.compile(r"epoch \d+ step \d+ ")
    try:
        for line in proc.stdout:
            lines.append(line)
            if step_re.search(line):
                first_step_s = round(time.perf_counter() - t0, 1)
                break
            if time.perf_counter() - t0 > timeout_s:
                break
    finally:
        proc.kill()  # SIGTERM would be the Trainer's preemption: a checkpoint first
        proc.wait()
    return {"wall_s": round(time.perf_counter() - t0, 1),
            "startup_to_first_step_s": first_step_s, "tail": "".join(lines[-3:])[-400:]}


PHASES = {"processor": phase_processor, "sampler": phase_sampler, "loader": phase_loader,
          "cli": phase_cli}


def _run_phase_subprocess(phase: str, kwargs: dict) -> dict:
    """This module again for ONE phase: its ru_maxrss is that phase's own
    peak, not the most of everything run before it."""
    r = subprocess.run([sys.executable, "-m", "linnaeus_tpu_torch.tools.scale_receipt",
                        "--phase", phase, "--phase-args", json.dumps(kwargs)],
                       capture_output=True, text=True, timeout=3600, cwd=ROOT)
    if r.returncode != 0:
        return {"error": (r.stdout + r.stderr)[-500:]}
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    p = argparse.ArgumentParser("scale_receipt")
    p.add_argument("--rows", type=int, nargs="+", default=[16384, 100000, 1000000])
    p.add_argument("--img", type=int, default=32)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--feed-batches", type=int, default=100)
    p.add_argument("--with-images", action="store_true",
                   help="also write the JPEG directory and run the loader and cli phases")
    p.add_argument("--device", default=None, help="the cli phase's --device (cpu); the card "
                                                  "by default")
    p.add_argument("--dir", default="build/scale_receipt")
    p.add_argument("--out", default="")
    p.add_argument("--keep", action="store_true",
                   help="keep the generated data (default: delete it after each size)")
    # internal: a single-phase child
    p.add_argument("--phase", default="")
    p.add_argument("--phase-args", default="{}")
    args = p.parse_args(argv)

    if args.phase:
        print(json.dumps(PHASES[args.phase](**json.loads(args.phase_args))))
        return

    os.makedirs(args.dir, exist_ok=True)
    record: dict = {"img": args.img, "batch": args.batch, "sizes": []}
    for n in args.rows:
        labels = os.path.join(args.dir, f"labels_{n}.npz")
        images = os.path.join(args.dir, f"images_{n}")
        row: dict = {"rows": n}
        t0 = time.perf_counter()
        if not os.path.isfile(labels):
            generate_labels(labels, n)
        row["gen_labels_s"] = round(time.perf_counter() - t0, 1)
        if args.with_images and not os.path.isdir(images):
            t1 = time.perf_counter()
            generate_images(images, n, args.img)
            row["gen_images_s"] = round(time.perf_counter() - t1, 1)
        row["processor"] = _run_phase_subprocess("processor", {"labels": labels, "img": args.img})
        row["sampler"] = _run_phase_subprocess(
            "sampler", {"labels": labels, "img": args.img, "batch": args.batch})
        if args.with_images:
            row["loader"] = _run_phase_subprocess(
                "loader", {"labels": labels, "images": images, "img": args.img,
                           "batch": args.batch, "feed_batches": args.feed_batches})
            row["cli"] = _run_phase_subprocess(
                "cli", {"labels": labels, "images": images, "img": args.img,
                        "batch": args.batch, "out_dir": args.dir, "device": args.device})
        record["sizes"].append(row)
        print(json.dumps(row), flush=True)
        if not args.keep:
            if os.path.isfile(labels):
                os.remove(labels)
            shutil.rmtree(images, ignore_errors=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({"scale_receipt": record["sizes"]}))


if __name__ == "__main__":
    main()
