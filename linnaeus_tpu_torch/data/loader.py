"""Host-side prefetching loader: threaded HDF5/file reads -> numpy batches
-> double-buffered device transfer.

Port of linnaeus_tpu/data/loader.py. Where the TPU loader calls a
``device_put_fn`` on each finished batch, this one takes the ``device`` to
place batches on: None yields the numpy batches themselves; the CPU gets
tensors that share the arrays' memory; a CUDA device gets each batch copied
from pinned host buffers on a side stream (``CudaBatchMover``), an event
after each copy, and the consumer's stream made to wait on that event when
the batch is handed out, so the copy of the next DEVICE_PREFETCH_DEPTH
batches overlaps the step on the current one. The reader threads decode on
the host and never touch CUDA; pinning and the copies run on the thread
that iterates the loader.

Replaces the reference's 3-stage thread pipeline (queues + sentinels,
h5data/base_prefetching_dataset.py:22-807) with a simpler design: a thread
pool reads+decodes samples, a bounded futures window keeps BATCH_CONCURRENCY
batches in flight, and finished batches go to the device at once so transfer
overlaps compute (DEVICE_PREFETCH_DEPTH deep). Mixing/masking run on the
device inside the train step, so no per-sample CPU augmentation is required
in the default configuration (AUG.SINGLE_AUG_DEVICE='device'); host
augmentation plugs in as ``host_augment_fn``.

Pipeline telemetry mirrors the reference's monitor thread
(base_prefetching_dataset.py:729): throughput, in-flight depth, cache stats.
"""

from __future__ import annotations

import collections
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from linnaeus_tpu_torch.utils.logging import get_h5data_logger
from .datasets import PrefetchingDataset
from .sampler import GroupedBatchSampler

logger = get_h5data_logger()


def _tree_map(fn, batch):
    return {k: (_tree_map(fn, v) if isinstance(v, dict) else fn(v)) for k, v in batch.items()}


def _leaves(batch):
    for v in batch.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


class CudaBatchMover:
    """Host batch -> CUDA tensors, overlapped with the consumer's work.

    ``put`` copies a batch's numpy arrays into pinned host tensors and
    issues their copies to the device on a side stream, with an event
    recorded after them; ``take`` makes the caller's current stream wait on
    that event (the device orders the step after the copy without blocking
    the host) and marks the device tensors as used on that stream for the
    caching allocator. A pinned buffer is kept referenced until its copy's
    event has fired, so it is neither freed nor reused under the copy."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._stream: torch.cuda.Stream | None = None
        self._pinned: collections.deque = collections.deque()

    def put(self, host_batch: dict) -> tuple[dict, torch.cuda.Event]:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        pinned = _tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a)).pin_memory(),
                           host_batch)
        with torch.cuda.stream(self._stream):
            on_device = _tree_map(lambda t: t.to(self.device, non_blocking=True), pinned)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._pinned.append((event, pinned))
        return on_device, event

    def take(self, moved: tuple[dict, torch.cuda.Event]) -> dict:
        batch, event = moved
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(event)
        for t in _leaves(batch):
            t.record_stream(consumer)
        while self._pinned and self._pinned[0][0].query():
            self._pinned.popleft()
        return batch


class H5DataLoader:
    def __init__(
        self,
        dataset: PrefetchingDataset,
        sampler: GroupedBatchSampler,
        num_io_threads: int = 4,
        batch_concurrency: int = 4,
        num_preprocess_threads: int = 4,
        max_processed_batches: int = 10,
        device_prefetch_depth: int = 2,
        device: torch.device | str | None = None,
        rows: tuple[int, int] | None = None,
        sleep_time: float = 0.0,
        host_augment_fn=None,
        debug: bool = False,
    ):
        """``host_augment_fn(images_f32 [B,H,W,3], seed) -> images_f32``:
        optional batched augmentation applied to each host batch before
        device transfer (AUG.SINGLE_AUG_DEVICE='cpu'; the 'device' path runs
        augmentation inside the train step instead). ``device``: where the
        batches go (module docstring); None yields numpy batches. ``rows``
        (start, end): read only those rows of each sampled batch (a rank's
        share under parallel/; None: all)."""
        self.dataset = dataset
        self.sampler = sampler
        self.rows = None if rows is None else (int(rows[0]), int(rows[1]))
        self.host_augment_fn = host_augment_fn
        self.debug = debug  # DEBUG.DATALOADER
        self._epoch = 0
        self.num_io_threads = max(int(num_io_threads), 1)
        self.batch_concurrency = max(int(batch_concurrency), 1)
        # DATA.PREFETCH.NUM_PREPROCESS_THREADS sizes the batch-assembly pool;
        # MAX_PROCESSED_BATCHES bounds host batches alive at once (in-flight
        # reads + the ready queue) — the host-memory cap (reference:
        # h5data/build.py:1244-1246)
        self.num_preprocess_threads = max(int(num_preprocess_threads), 1)
        self.max_processed_batches = max(int(max_processed_batches), 2)
        self.device_prefetch_depth = max(int(device_prefetch_depth), 0)
        self.device = None if device is None else torch.device(device)
        self._mover = (CudaBatchMover(self.device)
                       if self.device is not None and self.device.type == "cuda" else None)
        # the index arrays of the current epoch's batches, in the order read
        self.epoch_indices: list[np.ndarray] = []
        self.sleep_time = sleep_time
        # two pools: per-sample IO reads fan out on _io_pool while batch
        # assembly futures run on _batch_pool (separate pools = no deadlock)
        self._io_pool: ThreadPoolExecutor | None = None
        self._pool: ThreadPoolExecutor | None = None
        self.metrics = {
            "batches_emitted": 0,
            "samples_emitted": 0,
            "throughput_samples_per_sec": 0.0,
            "avg_wait_ms": 0.0,
        }

    # -------------------------------------------------------------- epoch API
    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)
        self.sampler.set_epoch(epoch)

    def set_group_level(self, level: str) -> None:
        self.sampler.set_current_group_level(level)
        self.dataset.set_group_level(level)

    def __len__(self) -> int:
        return len(self.sampler)

    def _ensure_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.num_preprocess_threads,
                thread_name_prefix="h5batch",
            )
            self._io_pool = ThreadPoolExecutor(
                max_workers=self.num_io_threads, thread_name_prefix="h5io"
            )
        return self._pool

    def __iter__(self):
        pool = self._ensure_pool()
        batches = self.sampler.batches()
        if self.rows is not None:
            batches = [b[self.rows[0]:self.rows[1]] for b in batches]
        self.epoch_indices = list(batches)
        if self.debug:
            logger.debug(
                f"[DATALOADER] epoch={self._epoch} batches={len(batches)} "
                f"batch_size={self.sampler.batch_size} "
                f"io_threads={self.num_io_threads} "
                f"window={self.batch_concurrency} "
                f"device_depth={self.device_prefetch_depth} "
                f"host_aug={'on' if self.host_augment_fn else 'off'}"
            )
        futures = collections.deque()
        device_queue = collections.deque()
        epoch_start = time.perf_counter()
        total_wait = 0.0
        emitted = 0
        # reset per-epoch telemetry up front: an epoch that yields zero
        # batches (shard shrank below batch_size, autobatch raised it) must
        # report 0, not the previous epoch's numbers
        self.metrics["throughput_samples_per_sec"] = 0.0
        self.metrics["avg_wait_ms"] = 0.0

        def submit(idx_array):
            return pool.submit(
                self.dataset.read_batch, idx_array, pool=self._io_pool
            )

        def can_submit():
            return (
                len(futures) < self.batch_concurrency
                and len(futures) + len(device_queue)
                < self.max_processed_batches
            )

        bi = 0
        # prime the window
        while bi < len(batches) and can_submit():
            futures.append(submit(batches[bi]))
            bi += 1

        while futures or device_queue:
            # keep the read window full
            while bi < len(batches) and can_submit():
                futures.append(submit(batches[bi]))
                bi += 1
            # move finished host batches to the device queue
            while futures and (
                len(device_queue) < max(self.device_prefetch_depth, 1)
            ):
                t0 = time.perf_counter()
                host_batch = futures.popleft().result()
                total_wait += time.perf_counter() - t0
                if self.host_augment_fn is not None:
                    imgs = host_batch["images"]
                    if imgs.dtype == np.uint8:
                        imgs = imgs.astype(np.float32) / 255.0
                    seed = self._epoch * 1_000_003 + emitted + len(device_queue)
                    host_batch["images"] = np.asarray(
                        self.host_augment_fn(imgs, seed), np.float32
                    )
                if self._mover is not None:
                    host_batch = self._mover.put(host_batch)
                elif self.device is not None:
                    host_batch = _tree_map(
                        lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device),
                        host_batch)
                device_queue.append(host_batch)
                if self.sleep_time > 0:
                    time.sleep(self.sleep_time)
            batch = device_queue.popleft()
            if self._mover is not None:
                batch = self._mover.take(batch)
            emitted += 1
            self.metrics["batches_emitted"] += 1
            self.metrics["samples_emitted"] += self.sampler.batch_size
            # update running telemetry EVERY yield (a consumer that stops
            # mid-epoch — early exit, preemption, bench with a step budget —
            # must still see real numbers, and the Trainer logs
            # pipeline_metrics at step cadence, not epoch cadence)
            elapsed = max(time.perf_counter() - epoch_start, 1e-9)
            self.metrics["throughput_samples_per_sec"] = (
                emitted * self.sampler.batch_size / elapsed
            )
            self.metrics["avg_wait_ms"] = 1000.0 * total_wait / emitted
            yield batch
        if self.debug:
            logger.debug(
                f"[DATALOADER] epoch={self._epoch} done: "
                f"{self.metrics['throughput_samples_per_sec']:.1f} img/s, "
                f"avg_wait={self.metrics['avg_wait_ms']:.2f} ms"
            )

    def pipeline_metrics(self) -> dict:
        out = dict(self.metrics)
        if self.dataset.cache is not None:
            out["cache"] = self.dataset.cache.stats()
        return out

    def close(self) -> None:
        # wait=True quiesces the reader threads before the sources close:
        # an in-flight direct-chunk read racing H5ImageSource.close() could
        # otherwise preadv from a recycled fd. cancel_futures drops queued
        # work, so the wait is bounded by the currently-running batch.
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
        if self._io_pool is not None:
            self._io_pool.shutdown(wait=True, cancel_futures=True)
            self._io_pool = None
        self.dataset.close()
