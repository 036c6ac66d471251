"""Input-pipeline throughput benchmark (host side).

Port of linnaeus_tpu/tools/pipeline_benchmark.py. It measures the samples a
second of the port's prefetching loader alone (data/build.py's datasets and
loaders), on the card by default: the loader copies each batch to the device
as the Trainer's does, and no model runs. ``--device cpu`` leaves the batches
on the host.

Labels are written as HDF5 where h5py is installed and otherwise as ``.npz``
(data/processor.py::write_labels_npz); ``--gen-real`` (HDF5 images) needs
h5py. ``--gen-jpeg N`` writes N JPEGs (hybrid mode) of ``--stored-size``
pixels, ``W`` or ``WxH`` (default twice ``--img-size``, square: the data
plane's DCT-prescaled decode), the TPU package's files for a square size
(``WxH`` is the port's only addition); files already in the directory are
kept, so a caller can fill it with images of its own first. ``--native`` sets
DATA.NATIVE_DATAPLANE for the hybrid read path: 'on' and 'auto' read a batch
at a time through linnaeus_tpu_torch/native/, 'off' decodes per sample.

    python -m linnaeus_tpu_torch.tools.pipeline_benchmark --gen-jpeg 1024 \\
        --stored-size 1024x768 --img-size 384 --batch-size 64 --native on
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def benchmark_loader(loader, max_batches: int = 100) -> dict:
    n = 0
    start = time.perf_counter()
    for i, batch in enumerate(loader):
        n += batch["images"].shape[0]
        if i + 1 >= max_batches:
            break
    elapsed = max(time.perf_counter() - start, 1e-9)
    return {
        "samples": n,
        "seconds": elapsed,
        "samples_per_sec": n / elapsed,
        "wait_ms_per_batch": float(loader.pipeline_metrics()["avg_wait_ms"]),
    }


def write_labels(path_prefix: str, datasets: dict[str, np.ndarray]) -> str:
    """``<prefix>_labels.h5`` where h5py is installed, else ``.npz``."""
    if importlib.util.find_spec("h5py") is None:
        from linnaeus_tpu_torch.data.processor import write_labels_npz

        path = f"{path_prefix}_labels.npz"
        write_labels_npz(path, datasets)
        return path
    import h5py

    path = f"{path_prefix}_labels.h5"
    with h5py.File(path, "w") as f:
        for k, v in datasets.items():
            f.create_dataset(k, data=v)
    return path


def _labels(idents: list[str], rng: np.random.Generator, width: str,
            l10: int = 500, l20: tuple[int, int] = (501, 600)) -> dict:
    n = len(idents)
    return {
        "img_identifiers": np.array(idents, width),
        "taxa_L10": rng.integers(1, l10, n),
        "taxa_L20": rng.integers(l20[0], l20[1], n),
        "temporal": rng.normal(size=(n, 2)).astype("f4"),
        "spatial": rng.normal(size=(n, 3)).astype("f4"),
    }


def generate_real_dataset(path_prefix: str, n: int, img_size: int) -> tuple[str, str]:
    """A file-backed HDF5 dataset (random uint8 pixels, one image a chunk)
    and its labels, so that the benchmark reads real HDF5 chunks."""
    from linnaeus_tpu_torch.data.datasets import _import_h5py

    h5py = _import_h5py()
    rng = np.random.default_rng(0)
    labels_path = write_labels(path_prefix, _labels([f"i{i}" for i in range(n)], rng, "S12"))
    images_path = f"{path_prefix}_images.h5"
    with h5py.File(images_path, "w") as f:
        dset = f.create_dataset("images", shape=(n, img_size, img_size, 3), dtype="u1",
                                chunks=(1, img_size, img_size, 3))
        for s in range(0, n, 512):
            e = min(s + 512, n)
            dset[s:e] = rng.integers(0, 256, (e - s, img_size, img_size, 3), "u1")
    return labels_path, images_path


def generate_jpeg_dataset(dir_prefix: str, n: int,
                          stored_size: int | tuple[int, int]) -> tuple[str, str]:
    """An on-disk JPEG directory and its labels (hybrid mode), the layout
    DirImageSource reads: ``<prefix>_jpegs/img_<k>.jpg``, a diagonal ramp
    with noise, ``stored_size`` pixels (one side, or ``(width, height)``).
    The TPU package's generator: one generator seeded 0 draws each new
    file's noise in turn (a file already there is kept and draws nothing),
    then the labels, so a square size gives its files and labels bit for
    bit. The draws stay in order on the calling thread; the JPEG encodes
    run in threads (PIL's encoder releases the GIL)."""
    from PIL import Image

    width, height = (stored_size, stored_size) if isinstance(stored_size, int) else stored_size
    images_dir = f"{dir_prefix}_jpegs"
    os.makedirs(images_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    idents = [f"img_{i:06d}" for i in range(n)]
    base = np.add.outer(np.linspace(0, 255, height, dtype=np.float32),
                        np.linspace(0, 255, width, dtype=np.float32))[:, :, None] / 2

    def write(path: str, img: np.ndarray) -> None:
        Image.fromarray(np.repeat(img, 3, axis=2)).save(path, quality=88)

    workers = os.cpu_count() or 1
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending = []
        for ident in idents:
            p = os.path.join(images_dir, ident + ".jpg")
            if os.path.exists(p):
                continue
            img = (base + rng.normal(0, 12, (height, width, 1))).clip(0, 255).astype(np.uint8)
            pending.append(pool.submit(write, p, img))
            if len(pending) >= 2 * workers:  # bounds the images held in memory
                pending.pop(0).result()
        for f in pending:
            f.result()
    labels_path = write_labels(dir_prefix, _labels(idents, rng, "S16"))
    return labels_path, images_dir


def _stored_size(text: str) -> int | tuple[int, int]:
    if "x" in text:
        w, h = text.lower().split("x")
        return int(w), int(h)
    return int(text)


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser("pipeline_benchmark")
    parser.add_argument("--labels", default=None)
    parser.add_argument("--images", default=None)
    parser.add_argument("--img-size", type=int, default=224)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--synthetic-samples", type=int, default=4096,
                        help="used when no --labels given")
    parser.add_argument("--io-threads", type=int, default=8)
    parser.add_argument("--max-batches", type=int, default=50)
    parser.add_argument("--gen-real", type=int, default=0, metavar="N",
                        help="generate a file-backed HDF5 dataset of N samples first")
    parser.add_argument("--gen-prefix", default=os.path.join("build", "pipebench"))
    parser.add_argument("--sweep-threads", default=None,
                        help="comma list (e.g. 1,4,8): benchmark each IO-thread count")
    parser.add_argument("--batch-concurrency", type=int, default=None)
    parser.add_argument("--grouped", action="store_true",
                        help="use the mixed-pairs grouped sampler (production train path)")
    parser.add_argument("--gen-jpeg", type=int, default=0, metavar="N",
                        help="generate an on-disk JPEG dataset of N files (hybrid mode)")
    parser.add_argument("--stored-size", type=_stored_size, default=0,
                        help="stored JPEG size, W or WxH (default 2x --img-size: "
                             "exercises the DCT-prescaled decode)")
    parser.add_argument("--native", default="auto", choices=["auto", "off", "on"],
                        help="DATA.NATIVE_DATAPLANE for the hybrid read path")
    parser.add_argument("--device", default=None,
                        help="where the loader puts its batches (default: the card)")
    args = parser.parse_args(argv)

    from linnaeus_tpu_torch.configuration import get_default_config
    from linnaeus_tpu_torch.data.build import build_datasets, build_loaders
    from linnaeus_tpu_torch.data.processor import open_labels
    from linnaeus_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = get_default_config()
    cfg.DATA.IMG_SIZE = args.img_size
    cfg.DATA.BATCH_SIZE = args.batch_size
    cfg.DATA.PREFETCH.NUM_IO_THREADS = args.io_threads
    if args.batch_concurrency:
        cfg.DATA.PREFETCH.BATCH_CONCURRENCY = args.batch_concurrency
    if args.grouped:
        cfg.DATA.SAMPLER.TYPE = "grouped"
        cfg.DATA.SAMPLER.GROUPED_MODE = "mixed-pairs"
        cfg.SCHEDULE.MIX.GROUP_LEVELS = ["taxa_L20"]
    else:
        cfg.DATA.SAMPLER.TYPE = "standard"
    cfg.DATA.NATIVE_DATAPLANE = args.native
    os.makedirs(os.path.dirname(args.gen_prefix) or ".", exist_ok=True)

    if args.gen_real:
        args.labels, args.images = generate_real_dataset(
            args.gen_prefix, args.gen_real, args.img_size)
    if args.gen_jpeg:
        labels_path, images_dir = generate_jpeg_dataset(
            args.gen_prefix, args.gen_jpeg, args.stored_size or 2 * args.img_size)
        args.labels, args.images = labels_path, None
        cfg.DATA.HYBRID.USE_HYBRID = True
        cfg.DATA.HYBRID.IMAGES_DIR = images_dir

    if not args.labels:
        # a labels file of its own; no images file -> synthetic pixels
        n = args.synthetic_samples
        args.labels = write_labels(
            f"{args.gen_prefix}_synthetic",
            _labels([f"i{i}" for i in range(n)], np.random.default_rng(0), "S12",
                    l10=100, l20=(101, 120)))
    cfg.DATA.TASK_KEYS_H5 = ["taxa_L10", "taxa_L20"]
    cfg.DATA.H5.LABELS_PATH = args.labels
    cfg.DATA.H5.IMAGES_PATH = args.images
    # the tasks the labels file carries
    with open_labels(args.labels) as f:
        cfg.DATA.TASK_KEYS_H5 = [t for t in cfg.DATA.TASK_KEYS_H5 if t in f] or ["taxa_L10"]
    cfg.DATA.PARTIAL.LEVELS = True

    thread_counts = ([int(t) for t in args.sweep_threads.split(",")]
                     if args.sweep_threads else [args.io_threads])
    results = []
    for n_threads in thread_counts:
        cfg.DATA.PREFETCH.NUM_IO_THREADS = n_threads
        bundle = build_datasets(cfg)
        train_loader, val_loader = build_loaders(cfg, bundle, device=device)
        bulk = train_loader.dataset._can_bulk_read()
        result = benchmark_loader(train_loader, args.max_batches)
        train_loader.close()
        if val_loader is not None:
            val_loader.close()
        out = {
            "io_threads": n_threads,
            "batch_concurrency": int(cfg.DATA.PREFETCH.BATCH_CONCURRENCY),
            "grouped": bool(args.grouped),
            "native": args.native,
            "hybrid": bool(args.gen_jpeg),
            "bulk_read": bool(bulk),
            "device": str(device),
            **result,
        }
        print(json.dumps(out), flush=True)
        results.append(out)
    return results


if __name__ == "__main__":
    main()
