"""Dataset/loader orchestration (reference parity: h5data/build.py:114-1381).

Supports the reference's four scenarios (docs/dev/98_architecture_notes.md):
  1. separate train + val label files        (DATA.H5.TRAIN_LABELS_PATH + VAL_LABELS_PATH)
  2. single label file, pure HDF5 images     (DATA.H5.LABELS_PATH + IMAGES_PATH)
  3. single label file, hybrid image dir     (+ DATA.HYBRID.USE_HYBRID)
  4. train-only (no validation file)

Port of linnaeus_tpu/data/build.py. The sampler runs with the host's
index and the number of hosts as its process index and count, as the TPU
package's does (one process a host there), so each host reads its
DATA.BATCH_SIZE rows; with a mesh (parallel/mesh.py) each rank's loader
reads and decodes only its rows of them (``rank_rows``: the rows of its data
coordinate, the same along the model axis). The labels may be
``.npz`` (data/processor.py::open_labels). The host augmentation path
(AUG.SINGLE_AUG_DEVICE 'cpu') runs the port's augmentation pipeline on CPU
tensors in the loader's thread.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from linnaeus_tpu_torch.utils.debug import check_debug_flag
from linnaeus_tpu_torch.utils.logging import get_main_logger
from .datasets import (
    DirImageSource,
    H5ImageSource,
    PrefetchingDataset,
    SyntheticImageSource,
)
from .loader import H5DataLoader
from .processor import DatasetProcessor, ProcessedLabels
from .sampler import build_sampler

logger = get_main_logger()


def _image_source(config, labels: ProcessedLabels, images_path: str | None):
    img_size = int(config.DATA.IMG_SIZE)
    if config.DATA.HYBRID.USE_HYBRID:
        return DirImageSource(
            config.DATA.HYBRID.IMAGES_DIR,
            labels.img_identifiers,
            img_size,
            file_extension=str(config.DATA.HYBRID.FILE_EXTENSION),
            allow_missing=bool(config.DATA.HYBRID.ALLOW_MISSING_IMAGES),
            native=str(config.DATA.get("NATIVE_DATAPLANE", "auto")),
        )
    if images_path:
        return H5ImageSource(
            images_path, img_size,
            direct_chunk=str(config.DATA.H5.get("DIRECT_CHUNK_READS", "auto")),
        )
    logger.warning("No image source configured; using synthetic images")
    return SyntheticImageSource(img_size, seed=int(config.MISC.SEED))


def build_datasets(config) -> dict[str, Any]:
    """Returns {train_dataset, val_dataset, processor, taxonomy_tree,
    num_classes, train_indices, val_indices}."""
    processor = DatasetProcessor(config)
    h5 = config.DATA.H5

    if h5.TRAIN_LABELS_PATH:
        train_labels, val_labels = processor.process(
            h5.TRAIN_LABELS_PATH, h5.VAL_LABELS_PATH
        )
        train_idx = train_labels.valid_indices()
        val_idx = val_labels.valid_indices() if val_labels else None
        train_images = h5.TRAIN_IMAGES_PATH or h5.IMAGES_PATH
        val_images = h5.VAL_IMAGES_PATH or h5.IMAGES_PATH
    elif h5.LABELS_PATH:
        train_labels, val_labels, train_idx, val_idx = processor.process_single_file(
            h5.LABELS_PATH,
            split_ratio=float(h5.TRAIN_VAL_SPLIT_RATIO),
            split_seed=int(h5.TRAIN_VAL_SPLIT_SEED),
        )
        train_images = val_images = h5.IMAGES_PATH
    else:
        raise ValueError(
            "DATA.H5 must provide TRAIN_LABELS_PATH or LABELS_PATH"
        )

    # pre-training image existence verification for hybrid datasets
    # (reference: vectorized_dataset_processor.py:263-288 verifies the
    # primary labels file's identifiers against the image dir BEFORE
    # processing; under-threshold missing samples are excluded from the
    # valid indices, over-threshold raises)
    if (
        config.DATA.HYBRID.USE_HYBRID
        and config.DATA.HYBRID.VERIFY_IMAGES.ENABLED
    ):
        from .image_verifier import ImageVerifier

        vi = config.DATA.HYBRID.VERIFY_IMAGES
        verifier = ImageVerifier(
            str(config.DATA.HYBRID.IMAGES_DIR),
            file_extension=str(config.DATA.HYBRID.FILE_EXTENSION),
            num_workers=int(vi.NUM_WORKERS),
            chunk_size=int(vi.CHUNK_SIZE),
            max_missing_ratio=float(vi.MAX_MISSING_RATIO),
            max_missing_count=int(vi.MAX_MISSING_COUNT),
            log_missing=bool(vi.LOG_MISSING),
        )
        missing_idx, _ = verifier.verify_images(
            [str(s) for s in train_labels.img_identifiers]
        )
        if missing_idx:
            missing_arr = np.fromiter(missing_idx, dtype=np.int64)
            train_idx = np.asarray(train_idx)
            train_idx = train_idx[~np.isin(train_idx, missing_arr)]
            if val_idx is not None and val_labels is train_labels:
                # single-file mode: the same file backs both splits
                val_idx = np.asarray(val_idx)
                val_idx = val_idx[~np.isin(val_idx, missing_arr)]
            logger.info(
                f"ImageVerifier: excluded {len(missing_idx)} samples with "
                "missing image files (within thresholds)"
            )
        # two-file mode: the val labels file has its own identifiers — a
        # missing val image would otherwise only surface mid-validation at
        # read time, the late failure this check exists to prevent
        if val_labels is not None and val_labels is not train_labels:
            val_missing, _ = verifier.verify_images(
                [str(s) for s in val_labels.img_identifiers]
            )
            if val_missing and val_idx is not None:
                vm = np.fromiter(val_missing, dtype=np.int64)
                val_idx = np.asarray(val_idx)
                val_idx = val_idx[~np.isin(val_idx, vm)]
                logger.info(
                    f"ImageVerifier: excluded {len(val_missing)} val samples "
                    "with missing image files (within thresholds)"
                )

    mem_cache = int(config.DATA.PREFETCH.MEM_CACHE_SIZE)
    train_dataset = PrefetchingDataset(
        train_labels,
        _image_source(config, train_labels, train_images),
        processor.task_keys,
        mem_cache_bytes=mem_cache,
        simulate_hpc=bool(config.DATA.SIMULATE_HPC),
        io_delay=float(config.DATA.IO_DELAY),
        verbose_reads=check_debug_flag(config, "DEBUG.DATASET.READ_ITEM_VERBOSE"),
    )
    val_dataset = None
    if val_labels is not None and val_idx is not None and len(val_idx) > 0:
        val_dataset = PrefetchingDataset(
            val_labels,
            _image_source(config, val_labels, val_images),
            processor.task_keys,
            mem_cache_bytes=0,
        )

    return {
        "train_dataset": train_dataset,
        "val_dataset": val_dataset,
        "processor": processor,
        "taxonomy_tree": processor.taxonomy_tree,
        "num_classes": dict(processor.num_classes),
        "train_indices": np.asarray(train_idx),
        "val_indices": np.asarray(val_idx) if val_idx is not None else None,
    }


def _make_host_augment(config):
    """Host-side batched augmentation for AUG.SINGLE_AUG_DEVICE='cpu'
    (reference: aug/factory.py device dispatch + the preprocess-thread
    pipeline, base_prefetching_dataset.py:612-711): the port's pipeline
    (data/augmentation/autoaugment.py) on CPU tensors, its draws from a
    generator seeded per batch. It costs float32 host->device copies (4x
    uint8); 'device' is the default."""
    if str(config.AUG.SINGLE_AUG_DEVICE) != "cpu":
        return None
    from .augmentation.autoaugment import AugmentationPipelineFactory

    fn = AugmentationPipelineFactory.create(config)
    if fn is None:
        return None

    def host_aug(images: np.ndarray, seed: int) -> np.ndarray:
        generator = torch.Generator().manual_seed(int(seed))
        return fn(torch.from_numpy(images), generator).numpy()

    return host_aug


def build_loaders(
    config,
    bundle: dict[str, Any],
    device: torch.device | str | None = None,
    mesh=None,
) -> tuple[H5DataLoader, H5DataLoader | None]:
    """Train and val loaders (the val loader is None without a val split);
    ``device`` is where they put their batches (data/loader.py); with a
    ``mesh`` each reads this rank's rows of the host's batches."""
    from linnaeus_tpu_torch.parallel.mesh import get_process_count, get_process_index, rank_rows

    pidx, pcnt = get_process_index(), get_process_count()
    prefetch = config.DATA.PREFETCH
    host_augment_fn = _make_host_augment(config)

    train_sampler = build_sampler(
        config,
        bundle["train_dataset"].labels.group_ids,
        bundle["train_indices"],
        int(config.DATA.BATCH_SIZE),
        is_train=True,
        process_index=pidx,
        process_count=pcnt,
    )
    train_loader = H5DataLoader(
        bundle["train_dataset"],
        train_sampler,
        num_io_threads=int(prefetch.NUM_IO_THREADS),
        batch_concurrency=int(prefetch.BATCH_CONCURRENCY),
        num_preprocess_threads=int(prefetch.NUM_PREPROCESS_THREADS),
        max_processed_batches=int(prefetch.MAX_PROCESSED_BATCHES),
        device_prefetch_depth=int(prefetch.get("DEVICE_PREFETCH_DEPTH", 2)),
        device=device,
        rows=rank_rows(int(config.DATA.BATCH_SIZE), mesh),
        sleep_time=float(prefetch.SLEEP_TIME),
        host_augment_fn=host_augment_fn,
        debug=check_debug_flag(config, "DEBUG.DATALOADER"),
    )

    # validation is never augmented (reference: VAL.DISABLE_AUGMENTATIONS)
    val_loader = None
    if bundle["val_dataset"] is not None:
        val_sampler = build_sampler(
            config,
            bundle["val_dataset"].labels.group_ids,
            bundle["val_indices"],
            int(config.DATA.BATCH_SIZE_VAL),
            is_train=False,
            process_index=pidx,
            process_count=pcnt,
        )
        val_loader = H5DataLoader(
            bundle["val_dataset"],
            val_sampler,
            num_io_threads=int(prefetch.NUM_IO_THREADS),
            batch_concurrency=int(prefetch.BATCH_CONCURRENCY),
            num_preprocess_threads=int(prefetch.NUM_PREPROCESS_THREADS),
            max_processed_batches=int(prefetch.MAX_PROCESSED_BATCHES),
            device_prefetch_depth=int(prefetch.get("DEVICE_PREFETCH_DEPTH", 2)),
            device=device,
            rows=rank_rows(int(config.DATA.BATCH_SIZE_VAL), mesh),
            debug=check_debug_flag(config, "DEBUG.DATALOADER"),
        )
        if len(val_loader) == 0:
            logger.warning(
                "Validation loader has ZERO batches: the val split "
                f"({len(bundle['val_indices'])} samples) is smaller than "
                f"DATA.BATCH_SIZE_VAL ({config.DATA.BATCH_SIZE_VAL}) with "
                "drop-last batching — validation passes will silently "
                "produce no metrics"
            )
    return train_loader, val_loader
