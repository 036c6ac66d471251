"""End-to-end training throughput: the port's loader feeding its train step.

Port of linnaeus_tpu/tools/e2e_train_bench.py. ``train_bench.py`` times the
step alone on one synthetic batch; this tool closes the gap: a dataset on
disk is read by the production ``H5DataLoader`` (threaded reads, a bounded
window of batch futures, pinned copies to the device on a side stream) and
fed to the production train step, one call a batch as in
``Trainer._train_one_epoch``.

``generate_dataset`` makes the synthetic receipt data (the same labels and
raw uint8 images as the JAX tool's, bit for bit, from the same arguments):
as the HDF5 pair (``<prefix>_labels.h5``, ``<prefix>_images.h5``; needs
h5py) or, with ``hybrid=True``, as the hybrid form that
``data/datasets.py::DirImageSource`` reads: ``<prefix>_labels.npz`` and one
JPEG an image under ``<prefix>_images/`` (quality 98 without chroma
subsampling: a mean |difference| of about 1.4 in uint8 from the raw arrays).
A machine without h5py runs on the hybrid form.

Reported:
  * ``e2e_ms_per_step`` / ``e2e_images_per_sec``: steady-state wall clock a
    step with the feed in the loop (a device synchronise closes the window);
  * ``device_ms_per_step``: the same geometry timed on one synthetic batch
    in the same process (``train_bench.measure``);
  * ``feed_overlap``: device / e2e, 1.0 when the feed hides under the step;
  * ``host_feed_images_per_sec_{cold,steady}``: the loader alone, batches
    left on the host;
  * ``loader``: the loader's ``pipeline_metrics``.

It runs on the CUDA device unless ``--device cpu`` is given; without a card
and without that flag it raises.

    python -m linnaeus_tpu_torch.tools.e2e_train_bench --gen-only --gen 8192 \\
        --gen-learnable --hybrid --img 384 --prefix /tmp/trainrun384
    python -m linnaeus_tpu_torch.tools.e2e_train_bench --hybrid --steps 150
    python -m linnaeus_tpu_torch.tools.e2e_train_bench --feed-ab   # needs h5py
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

JPEG_QUALITY = 98  # 4:4:4; mean |decoded - raw| about 1.4 on the noise images
BENCH_IMG = 224


def hierarchy_labels(n: int, species: int = 999, null_frac: float = 0.0,
                     learnable: bool = True,
                     rng: np.random.Generator | None = None):
    """The canonical synthetic 4-level taxonomy (999/399/99/29 id ranges):
    returns ``(l10, l20, l30, l40, nulls)``. Copied from the JAX tool."""
    rng = rng or np.random.default_rng(0)
    if learnable:
        # fixed per-row species id; ``species`` < 999 concentrates samples
        # per class
        l10 = 1 + (np.arange(n) * 7919) % species
        l20 = 1001 + (l10 - 1) % 399
        l30 = 1401 + (l20 - 1001) % 99
        l40 = 1501 + (l30 - 1401) % 29
    else:
        l10 = rng.integers(1, 1000, n)
        l20 = rng.integers(1001, 1400, n)
        l30 = rng.integers(1401, 1500, n)
        l40 = rng.integers(1501, 1530, n)
    nulls = np.zeros(n, bool)
    if null_frac > 0:
        nulls = rng.random(n) < float(null_frac)
        for lv in (l10, l20, l30, l40):
            lv[nulls] = 0
    return l10, l20, l30, l40, nulls


def _labels_and_images(n: int, img: int, learnable: bool, null_frac: float,
                       species: int):
    """The JAX generator's draws in its order: the label datasets, then a
    generator of ``(start, end, uint8 images)`` blocks of 512 rows."""
    rng = np.random.default_rng(0)
    l10, l20, l30, l40, _ = hierarchy_labels(
        n, species=species, null_frac=null_frac, learnable=learnable, rng=rng
    )
    datasets = {
        "img_identifiers": np.array([f"i{i}" for i in range(n)], "S12"),
        "taxa_L10": l10, "taxa_L20": l20, "taxa_L30": l30, "taxa_L40": l40,
        "temporal": rng.normal(size=(n, 2)).astype("f4"),
        "spatial": rng.normal(size=(n, 3)).astype("f4"),
    }
    # per-class visual signatures (learnable mode)
    colors = None
    if learnable:
        crng = np.random.default_rng(1234)
        colors = crng.integers(40, 216, (1000, 3)).astype(np.int16)

    def blocks():
        block = 512
        for s in range(0, n, block):
            e = min(s + block, n)
            noise = rng.integers(0, 256, (e - s, img, img, 3), np.int16)
            if not learnable:
                yield s, e, noise.astype("u1")
                continue
            cls = l10[s:e]
            blend = (noise + colors[cls][:, None, None, :]) // 2
            # bright patch whose position encodes the class
            p = img // 8
            for bi, c in enumerate(cls):
                if c == 0:  # null row: pure noise, no class signature
                    blend[bi] = noise[bi]
                    continue
                y = (int(c) * 37) % (img - p)
                x = (int(c) * 101) % (img - p)
                blend[bi, y:y + p, x:x + p] = colors[c] // 2 + 128
            yield s, e, blend.astype("u1")

    return datasets, blocks()


def generate_dataset(prefix: str, n: int, img: int,
                     learnable: bool = False,
                     null_frac: float = 0.0,
                     species: int = 999,
                     hybrid: bool = False) -> tuple[str, str]:
    """The flagship's 4 task levels + 5-dim meta on disk; returns
    ``(labels_path, images_path)``.

    ``learnable=True`` makes the data trainable: the taxonomy is
    hierarchy-consistent and every image carries its class's signal (a
    class-keyed colour cast plus a class-positioned bright patch under heavy
    noise). ``null_frac`` > 0 marks that fraction of rows null (label 0) at
    every level; their images stay pure noise, so null against known is
    visually decidable: the signal the abstention phase (rl/) learns.

    ``hybrid=False`` writes the JAX tool's HDF5 pair (one image a chunk) and
    needs h5py; ``hybrid=True`` writes ``<prefix>_labels.npz`` and
    ``<prefix>_images/i<k>.jpg`` (DATA.HYBRID), without h5py."""
    if not hybrid and importlib.util.find_spec("h5py") is None:
        raise ModuleNotFoundError(
            "generate_dataset: the HDF5 form needs h5py, which is not installed; "
            "pass hybrid=True (--hybrid) for JPEGs and .npz labels")
    datasets, blocks = _labels_and_images(n, img, learnable, null_frac, species)
    if hybrid:
        return _write_hybrid(prefix, datasets, blocks)
    import h5py

    labels_path = f"{prefix}_labels.h5"
    images_path = f"{prefix}_images.h5"
    with h5py.File(labels_path, "w") as f:
        for name, data in datasets.items():
            f.create_dataset(name, data=data)
    with h5py.File(images_path, "w") as f:
        dset = f.create_dataset(
            "images", shape=(n, img, img, 3), dtype="u1",
            chunks=(1, img, img, 3),
        )
        for s, e, images in blocks:
            dset[s:e] = images
    return labels_path, images_path


def _write_hybrid(prefix: str, datasets: dict, blocks) -> tuple[str, str]:
    from PIL import Image

    from linnaeus_tpu_torch.data.processor import write_labels_npz

    labels_path = f"{prefix}_labels.npz"
    images_dir = f"{prefix}_images"
    os.makedirs(images_dir, exist_ok=True)
    write_labels_npz(labels_path, datasets)
    ids = [i.decode() for i in datasets["img_identifiers"]]

    def save(k: int, pixels: np.ndarray) -> None:
        Image.fromarray(pixels).save(os.path.join(images_dir, ids[k] + ".jpg"),
                                     quality=JPEG_QUALITY, subsampling=0)

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        for s, e, images in blocks:
            list(pool.map(save, range(s, e), images))
    return labels_path, images_dir


def build_loader(labels: str, images: str, batch: int, io_threads: int,
                 window: int, depth: int, device=None,
                 direct_chunk: str = "auto", img: int = BENCH_IMG):
    """The production train loader over a generated dataset: HDF5 labels
    and images, or (``labels`` an ``.npz``) the hybrid form, ``images``
    then its JPEG directory. ``device`` None leaves the batches on the host."""
    from linnaeus_tpu_torch.configuration import get_default_config
    from linnaeus_tpu_torch.data.build import build_datasets, build_loaders

    cfg = get_default_config()
    cfg.DATA.IMG_SIZE = img
    cfg.DATA.BATCH_SIZE = batch
    cfg.DATA.H5.LABELS_PATH = labels
    if labels.endswith(".npz"):
        cfg.DATA.HYBRID.USE_HYBRID = True
        cfg.DATA.HYBRID.IMAGES_DIR = images
        cfg.DATA.HYBRID.FILE_EXTENSION = ".jpg"
    else:
        cfg.DATA.H5.IMAGES_PATH = images
    cfg.DATA.H5.DIRECT_CHUNK_READS = direct_chunk
    cfg.DATA.TASK_KEYS_H5 = ["taxa_L10", "taxa_L20", "taxa_L30", "taxa_L40"]
    cfg.DATA.PARTIAL.LEVELS = True
    cfg.DATA.PREFETCH.NUM_IO_THREADS = io_threads
    cfg.DATA.PREFETCH.BATCH_CONCURRENCY = window
    cfg.DATA.PREFETCH.DEVICE_PREFETCH_DEPTH = depth
    cfg.DATA.PREFETCH.MEM_CACHE_SIZE = 0  # force real reads
    cfg.DATA.SAMPLER.TYPE = "grouped"
    cfg.DATA.SAMPLER.GROUPED_MODE = "mixed-pairs"
    cfg.SCHEDULE.MIX.GROUP_LEVELS = ["taxa_L20"]
    bundle = build_datasets(cfg)
    train_loader, _ = build_loaders(cfg, bundle, device=device)
    return train_loader, bundle


def _check_batches(loader, batch: int) -> None:
    if len(loader) == 0:
        raise ValueError(
            f"loader yields zero batches (fewer same-genus pairs than a batch of {batch} in "
            "the train split): regenerate with a larger --gen or lower --batch")


def _steady_feed(labels: str, images: str, batch: int, io_threads: int,
                 window: int, depth: int, direct_chunk: str,
                 feed_warmup: int = 10,
                 feed_steady: int = 50, img: int = BENCH_IMG) -> tuple[float, float]:
    """Host-feed rate (img/s) of the production loader with no device
    transfer: ``(cold, steady)``, the first ``feed_warmup`` batches (thread
    spawn, cold caches) and the next ``feed_steady`` with the pipeline warm."""
    loader, _ = build_loader(labels, images, batch, io_threads, window, depth,
                             None, direct_chunk=direct_chunk, img=img)
    _check_batches(loader, batch)
    n = 0
    t0 = time.perf_counter()
    t_warm = t0
    cold = 0.0
    epoch = 0
    while n < feed_warmup + feed_steady:
        loader.set_epoch(epoch)
        for _ in loader:
            n += 1
            if n == feed_warmup:
                cold = feed_warmup * batch / max(time.perf_counter() - t0, 1e-9)
                t_warm = time.perf_counter()
            if n >= feed_warmup + feed_steady:
                break
        epoch += 1
    steady = feed_steady * batch / max(time.perf_counter() - t_warm, 1e-9)
    loader.close()
    return round(cold, 1), round(steady, 1)


def feed_ab(labels: str, images: str, batch: int = 128, pairs: int = 3,
            window: int = 4, depth: int = 2) -> dict:
    """Interleaved A/B of the direct-chunk gather against per-row h5py
    reads on the production loader (DATA.H5.DIRECT_CHUNK_READS 'on' / 'off',
    steady state), plus each path's scaling over io threads. HDF5 only: it
    raises by name without h5py."""
    if importlib.util.find_spec("h5py") is None:
        raise ModuleNotFoundError(
            "feed_ab compares DATA.H5.DIRECT_CHUNK_READS on HDF5 images and needs h5py, "
            "which is not installed")
    record: dict = {"batch": batch, "pairs": pairs}
    direct, per_row = [], []
    for _ in range(pairs):
        direct.append(_steady_feed(labels, images, batch, 8, window, depth, "on")[1])
        per_row.append(_steady_feed(labels, images, batch, 8, window, depth, "off")[1])
    record["direct_img_per_sec"] = direct
    record["per_row_img_per_sec"] = per_row
    record["direct_median"] = sorted(direct)[pairs // 2]
    record["per_row_median"] = sorted(per_row)[pairs // 2]
    record["speedup"] = round(
        record["direct_median"] / max(record["per_row_median"], 1e-9), 2
    )
    for mode in ("on", "off"):
        record[f"scaling_{mode}"] = {
            t: _steady_feed(labels, images, batch, t, window, depth, mode,
                            feed_steady=30)[1]
            for t in (1, 2, 4, 8)
        }
    return record


def run_e2e(steps: int = 150, warmup: int = 10, batch: int = 128,
            gen: int = 0, prefix: str = "/tmp/e2ebench",
            io_threads: int = 8, window: int = 4, depth: int = 2,
            skip_device_only: bool = False, progress: bool = False,
            dataset_samples: int | None = None, hybrid: bool = False,
            device=None, arch="mFormerV1_sm", img: int = BENCH_IMG) -> dict:
    """The end-to-end benchmark of ``arch`` at ``img`` px; returns the
    record. Reuses an existing dataset at ``prefix`` unless ``gen`` forces a
    new one; ``dataset_samples`` caps the generated size (epochs wrap)."""
    import torch

    from linnaeus_tpu_torch.tools.train_bench import build_step, measure
    from linnaeus_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    t_origin = time.perf_counter()

    def mark(msg: str) -> None:
        if progress:
            print(f"[{time.perf_counter() - t_origin:7.1f}s] {msg}", flush=True)

    labels = f"{prefix}_labels.npz" if hybrid else f"{prefix}_labels.h5"
    images = f"{prefix}_images" if hybrid else f"{prefix}_images.h5"
    need = gen or (
        0 if os.path.exists(labels) and os.path.exists(images)
        else (dataset_samples or (steps + warmup + 4) * batch)
    )
    if need:
        t0 = time.perf_counter()
        labels, images = generate_dataset(prefix, need, img, hybrid=hybrid)
        mark(f"generated {need} samples in {time.perf_counter() - t0:.1f}s")

    record = {"batch": batch, "io_threads": io_threads, "window": window, "depth": depth,
              "hybrid": hybrid, "device": device.type if device.type == "cpu"
              else torch.cuda.get_device_name(device)}
    cold, steady = _steady_feed(labels, images, batch, io_threads, window, depth, "auto",
                                img=img)
    record["host_feed_images_per_sec_cold"] = cold
    record["host_feed_images_per_sec_steady"] = steady
    record["host_feed_images_per_sec"] = steady
    mark(f"host-feed probe: cold {cold} / steady {steady} img/s")

    loader, bundle = build_loader(labels, images, batch, io_threads, window, depth, device,
                                  img=img)
    _check_batches(loader, batch)
    meta = (("TEMPORAL", 2), ("SPATIAL", 3))
    run, state = build_step(batch, img, True, arch=arch, num_classes=bundle["num_classes"],
                            meta_components=meta, device=device)
    mark("model and step built")
    total_batches = len(loader)
    needed = warmup + steps
    record["steps"] = steps

    def synchronize() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    done = 0
    epoch = 0
    losses = []
    t_timed_start = time.perf_counter()
    while done < needed:
        loader.set_epoch(epoch)
        for host_batch in loader:
            losses.append(run.step(state, host_batch, run.scalars)[1]["loss"])
            done += 1
            if done == 1 or done % 20 == 0:
                mark(f"step {done}/{needed}")
            if done == warmup:
                synchronize()
                t_timed_start = time.perf_counter()
            if done >= needed:
                break
        epoch += 1
    synchronize()
    elapsed = time.perf_counter() - t_timed_start
    final = float(losses[-1])
    if final != final:
        raise FloatingPointError("the last step's loss is NaN")
    e2e_ms = 1000.0 * elapsed / steps
    record["e2e_ms_per_step"] = round(e2e_ms, 2)
    record["e2e_images_per_sec"] = round(batch / (e2e_ms / 1000.0), 1)
    record["loader"] = {k: (round(v, 2) if isinstance(v, float) else v)
                        for k, v in loader.pipeline_metrics().items()
                        if not isinstance(v, dict)}
    record["total_batches_per_epoch"] = total_batches
    loader.close()

    if not skip_device_only:
        dev = measure(batch=batch, img=img, device=device, arch=arch,
                      num_classes=bundle["num_classes"], meta_components=meta)
        record["device_ms_per_step"] = dev["train_ms_per_step"]
        record["feed_overlap"] = round(dev["train_ms_per_step"] / e2e_ms, 4)
        # can the warm host pipeline outrun the step alone? (> 1.0 = yes)
        record["feed_margin"] = round(
            record["host_feed_images_per_sec_steady"] / dev["train_images_per_sec"], 3
        )
    return record


def main(argv=None) -> None:
    p = argparse.ArgumentParser("e2e_train_bench")
    p.add_argument("--steps", type=int, default=150, help="timed steps (after warmup)")
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--gen", type=int, default=0, metavar="N",
                   help="(re)generate the dataset with N samples")
    p.add_argument("--gen-learnable", action="store_true",
                   help="with --gen-only: hierarchy-consistent labels + class-signal "
                        "images (for training-run receipts)")
    p.add_argument("--gen-only", action="store_true",
                   help="generate the dataset and exit (no benchmark)")
    p.add_argument("--null-frac", type=float, default=0.0,
                   help="with --gen-only: the fraction of rows null at every level")
    p.add_argument("--img", type=int, default=BENCH_IMG,
                   help="with --gen-only: the image size")
    p.add_argument("--hybrid", action="store_true",
                   help="JPEGs and .npz labels instead of HDF5 (no h5py needed)")
    p.add_argument("--prefix", default="/tmp/e2ebench")
    p.add_argument("--io-threads", type=int, default=8)
    p.add_argument("--window", type=int, default=4)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--skip-device-only", action="store_true")
    p.add_argument("--progress", action="store_true", help="print stage markers")
    p.add_argument("--feed-ab", action="store_true",
                   help="interleaved steady-state A/B: direct-chunk gather vs per-row "
                        "h5py reads + io-thread scaling curves (HDF5, no device work)")
    p.add_argument("--device", default="cuda",
                   help='"cuda" (default; raises without a card), "cuda:N" or "cpu"')
    args = p.parse_args(argv)
    if args.feed_ab:
        print(json.dumps(feed_ab(
            f"{args.prefix}_labels.h5", f"{args.prefix}_images.h5",
            batch=args.batch, window=args.window, depth=args.depth,
        )))
        return
    if args.gen_only:
        t0 = time.perf_counter()
        labels, images = generate_dataset(
            args.prefix, args.gen or 16384, args.img,
            learnable=args.gen_learnable, null_frac=args.null_frac, hybrid=args.hybrid,
        )
        print(json.dumps({
            "labels": labels, "images": images,
            "gen_s": round(time.perf_counter() - t0, 1),
        }))
        return
    record = run_e2e(
        steps=args.steps, warmup=args.warmup, batch=args.batch,
        gen=args.gen, prefix=args.prefix, io_threads=args.io_threads,
        window=args.window, depth=args.depth,
        skip_device_only=args.skip_device_only, progress=args.progress,
        hybrid=args.hybrid, device=None if args.device == "cuda" else args.device,
    )
    print(json.dumps(record))


if __name__ == "__main__":
    main()
