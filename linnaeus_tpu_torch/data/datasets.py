"""Dataset readers: HDF5 images, image-directory (hybrid), synthetic.

Reference parity: h5data/prefetching_h5_dataset.py:15-389 (pure HDF5) and
prefetching_hybrid_dataset.py:16-598 (labels in HDF5, images on disk with
ALLOW_MISSING_IMAGES placeholder). Labels/metadata come pre-vectorized from
the DatasetProcessor (ProcessedLabels); readers only produce image pixels.

Threading: h5py handles are per-thread (threading.local) so the IO pool can
read concurrently; raw decoded images go through a byte-budgeted LRU cache.

Port of linnaeus_tpu/data/datasets.py. The readers run on the host in the
loader's threads and touch no CUDA state. h5py is imported where an HDF5
file is opened and cv2 where an image is decoded (PIL where cv2 is not
installed, as in the original). A directory of JPEGs reads a batch at a time
through the host data plane (linnaeus_tpu_torch/native/) under
DATA.NATIVE_DATAPLANE 'auto' or 'on'.
"""

from __future__ import annotations

import importlib.util
import os
import threading
import time

import numpy as np

from linnaeus_tpu_torch.utils.logging import get_h5data_logger
from .memcache import MemoryCache
from .processor import ProcessedLabels

logger = get_h5data_logger()

_HAS_CV2 = importlib.util.find_spec("cv2") is not None


def _import_h5py():
    if importlib.util.find_spec("h5py") is None:
        raise ModuleNotFoundError(
            "H5ImageSource: h5py is not installed; on this machine read the "
            "images from a directory (DATA.HYBRID.USE_HYBRID, IMAGES_DIR)"
        )
    import h5py

    return h5py


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    if img.shape[0] == size and img.shape[1] == size:
        return img
    if _HAS_CV2:
        import cv2

        return cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA)
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize((size, size), Image.BILINEAR))


class ImageSource:
    """Abstract per-index image provider returning HWC uint8."""

    def read(self, idx: int) -> np.ndarray:
        raise NotImplementedError

    def close(self) -> None:
        pass


class _DirectChunkTable:
    """Resolved state for the direct-chunk gather fast path."""

    __slots__ = ("fd", "offsets", "sizes", "row_shape", "row_bytes")

    def __init__(self, fd, offsets, sizes, row_shape):
        self.fd = fd
        self.offsets = offsets
        self.sizes = sizes
        self.row_shape = row_shape
        self.row_bytes = int(np.prod(row_shape))


class H5ImageSource(ImageSource):
    """Images from an HDF5 'images' dataset (one handle per thread).

    Batch reads take the DIRECT-CHUNK GATHER fast path when the dataset is
    one-row-per-chunk, filterless uint8 at the target size: chunk byte
    offsets are resolved ONCE via ``chunk_iter`` (4-5 us/chunk) and each
    batch is then plain ``os.preadv`` straight into the output buffer —
    no HDF5 selection machinery, no intermediate copies. Measured on the
    1-core bench host (warm page cache): 8,600 img/s vs 1,830 img/s for
    per-row h5py reads, 4.0x the device-only train rate (the reference's
    prefetching pipeline never beats its GPU rate on one core —
    base_prefetching_dataset.py:22-803 relies on worker fan-out).
    ``direct_chunk='off'`` (DATA.H5.DIRECT_CHUNK_READS) forces the per-row
    h5py path; 'on' raises when the layout is ineligible."""

    def __init__(self, path: str, img_size: int, dataset: str = "images",
                 direct_chunk: str = "auto"):
        self.path = path
        self.img_size = img_size
        self.dataset = dataset
        self.direct_chunk = str(direct_chunk)
        self._local = threading.local()
        self._direct: _DirectChunkTable | None | bool = False  # unresolved
        self._direct_lock = threading.Lock()

    def _file(self):
        h5py = _import_h5py()
        if not hasattr(self._local, "f"):
            self._local.f = h5py.File(self.path, "r")
        return self._local.f

    def read(self, idx: int) -> np.ndarray:
        img = self._file()[self.dataset][idx]
        return _resize(np.asarray(img), self.img_size)

    # ------------------------------------------- direct-chunk gather path
    def _direct_state(self) -> _DirectChunkTable | None:
        if self._direct is not False:
            return self._direct  # type: ignore[return-value]
        with self._direct_lock:
            if self._direct is not False:
                return self._direct  # type: ignore[return-value]
            self._direct = self._resolve_direct()
            return self._direct

    def _resolve_direct(self) -> _DirectChunkTable | None:
        if self.direct_chunk == "off":
            return None
        why = None
        try:
            d = self._file()[self.dataset]
            n = d.shape[0]
            row_shape = tuple(d.shape[1:])
            if d.dtype != np.uint8:
                why = f"dtype {d.dtype} != uint8"
            elif d.chunks != (1,) + row_shape:
                why = f"chunks {d.chunks} != one row per chunk"
            elif row_shape[:2] != (self.img_size, self.img_size):
                why = (f"stored size {row_shape[:2]} needs resize to "
                       f"{self.img_size}")
            elif d.id.get_create_plist().get_nfilters() != 0:
                why = "dataset has filters (compression)"
            elif not hasattr(d.id, "chunk_iter"):
                why = "h5py too old for chunk_iter"
            elif not hasattr(os, "preadv"):
                why = "os.preadv unavailable on this platform"
            if why is None:
                offsets = np.zeros(n, np.int64)
                sizes = np.zeros(n, np.int64)

                def cb(info):
                    r = info.chunk_offset[0]
                    offsets[r] = info.byte_offset
                    sizes[r] = info.size

                d.id.chunk_iter(cb)
                if (sizes == 0).any():
                    why = "unallocated chunks present"
                elif (sizes != int(np.prod(row_shape))).any():
                    why = "chunk sizes != raw row bytes"
                else:
                    fd = os.open(self.path, os.O_RDONLY)
                    logger.info(
                        f"H5ImageSource: direct-chunk gather enabled for "
                        f"{self.path} ({n} rows)"
                    )
                    return _DirectChunkTable(fd, offsets, sizes, row_shape)
        except Exception as e:  # pragma: no cover - defensive
            why = f"probe failed: {e}"
        if self.direct_chunk == "on":
            raise ValueError(
                f"DATA.H5.DIRECT_CHUNK_READS=on but {self.path} is "
                f"ineligible: {why}"
            )
        logger.info(
            f"H5ImageSource: direct-chunk gather unavailable for "
            f"{self.path} ({why}); using per-row h5py reads"
        )
        return None

    def supports_batch_read(self) -> bool:
        return self._direct_state() is not None

    def read_batch_rows(self, indices: np.ndarray) -> np.ndarray:
        """Whole-batch gather via per-row ``os.preadv`` directly into the
        batch buffer (thread-safe on the shared fd: pread is stateless).
        Only called when ``supports_batch_read()``."""
        st = self._direct_state()
        assert st is not None
        idx = np.asarray(indices, np.int64)
        out = np.empty((len(idx),) + st.row_shape, np.uint8)
        offs = st.offsets
        rb = st.row_bytes
        view = memoryview(out.reshape(-1))  # 1D: sliceable for preadv
        for pos in range(len(idx)):
            got = os.preadv(
                st.fd, [view[pos * rb:(pos + 1) * rb]], int(offs[idx[pos]])
            )
            if got != st.row_bytes:  # pragma: no cover - torn file
                raise OSError(
                    f"short chunk read at row {int(idx[pos])}: "
                    f"{got} != {st.row_bytes}"
                )
        return out

    # NOTE — two OTHER whole-batch HDF5 read strategies were tried and
    # retired with measured negative results (docs/performance.md,
    # host-pipeline section):
    # (a) h5py fancy indexing (``dset[sorted_idx]``) builds an HDF5 POINT
    #     selection whose per-point hyperslab union is pathological: 67
    #     img/s vs 22,000 img/s for the same rows read per-chunk (warm);
    # (b) a sequential per-row ``dset[i]`` loop inside one batch-pool worker
    #     hits a GIL convoy against the loader's other threads — each of the
    #     B row reads re-acquires the GIL, and the production loader
    #     measured it 2-4x slower than per-sample pool.map reads in 7/7
    #     interleaved A/B runs.
    # The direct-chunk gather above is neither: it bypasses the HDF5
    # selection machinery entirely (one preadv syscall per row, page-cache
    # memcpy, GIL released during the syscall).

    def close(self) -> None:
        """Close the calling thread's h5py handle and the shared
        direct-chunk fd. The caller must have quiesced reader threads
        first (the loader joins its IO pool before closing sources):
        an in-flight ``read_batch_rows`` racing ``close`` could read a
        recycled fd. ``_direct`` is parked at ``None`` (terminal
        "unavailable"), NOT ``False`` ("unresolved"), so a post-close
        read falls back to per-row h5py reads instead of silently
        reopening the direct-chunk fd."""
        f = getattr(self._local, "f", None)
        if f is not None:
            f.close()
            del self._local.f  # a post-close read reopens cleanly
        with self._direct_lock:
            st = self._direct
            self._direct = None
            if isinstance(st, _DirectChunkTable):
                try:
                    os.close(st.fd)
                except OSError:
                    pass


class DirImageSource(ImageSource):
    """Images from a directory keyed by img_identifier (hybrid mode)."""

    def __init__(
        self,
        images_dir: str,
        identifiers: list[str],
        img_size: int,
        file_extension: str = ".jpg",
        allow_missing: bool = False,
        native: str = "auto",
    ):
        self.images_dir = images_dir
        self.identifiers = identifiers
        self.img_size = img_size
        self.ext = file_extension
        self.allow_missing = allow_missing
        # 'auto': the host data plane's batch decode when it can be had and
        # the files are JPEG; 'off': always the per-sample cv2/PIL path;
        # 'on': raise where the data plane is unavailable (DATA.NATIVE_DATAPLANE)
        self.native_mode = str(native)
        self._dataplane = False  # not resolved yet

    def _native_plane(self):
        if self._dataplane is False:
            if self.native_mode == "off" or self.ext.lower() not in (".jpg", ".jpeg"):
                self._dataplane = None
            else:
                from linnaeus_tpu_torch.native import get_dataplane

                self._dataplane = get_dataplane()
                if self._dataplane is None and self.native_mode == "on":
                    raise RuntimeError(
                        "DATA.NATIVE_DATAPLANE='on' but the host data plane is unavailable "
                        "(cv2 cannot be imported, or LINNAEUS_TPU_NATIVE=0)")
        return self._dataplane

    def supports_batch_read(self) -> bool:
        return self._native_plane() is not None

    def read_batch_rows(self, indices: np.ndarray) -> np.ndarray:
        """File read, JPEG decode (DCT prescale) and area resize of a whole
        batch in the data plane's threads, one call. Missing files zero-fill
        under ALLOW_MISSING (the placeholder of ``read``) and raise
        otherwise. A row the data plane cannot parse (PNG content behind a
        .jpg name, a CMYK JPEG) goes through the per-sample decoder ``read``
        instead of failing the batch."""
        dp = self._native_plane()
        idx = np.asarray(indices)
        paths = [self._path(int(i)) for i in idx]
        images, status = dp.decode_jpeg_batch(
            paths, self.img_size, allow_missing=self.allow_missing)
        for pos in np.nonzero(status == 2)[0]:
            images[pos] = self.read(int(idx[pos]))
        return images

    def _path(self, idx: int) -> str:
        ident = self.identifiers[idx]
        if not ident.endswith(self.ext):
            ident = ident + self.ext
        return os.path.join(self.images_dir, ident)

    def read(self, idx: int) -> np.ndarray:
        path = self._path(idx)
        if not os.path.exists(path):
            if self.allow_missing:
                return np.zeros((self.img_size, self.img_size, 3), np.uint8)
            raise FileNotFoundError(path)
        if _HAS_CV2:
            import cv2

            img = cv2.imread(path, cv2.IMREAD_COLOR)
            if img is None:
                raise ValueError(f"undecodable image file: {path}")
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        else:
            from PIL import Image

            img = np.asarray(Image.open(path).convert("RGB"))
        return _resize(img, self.img_size)


class SyntheticImageSource(ImageSource):
    """Deterministic pseudo-random images (benchmarks / tests)."""

    def __init__(self, img_size: int, seed: int = 0):
        self.img_size = img_size
        self.seed = seed

    def read(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, idx))
        return rng.integers(
            0, 256, (self.img_size, self.img_size, 3), dtype=np.uint8
        ).astype(np.uint8)


class PrefetchingDataset:
    """Combines an ImageSource with pre-vectorized labels into batches.

    ``read_batch(indices)`` returns a dict of numpy arrays ready for
    the loader's device copy: images [B,H,W,3] float32 in [0,1], one int32 label
    vector per task, aux [B,meta_dim] float32, group_ids [B] int32.
    """

    def __init__(
        self,
        labels: ProcessedLabels,
        image_source: ImageSource,
        task_keys: list[str],
        mem_cache_bytes: int = 0,
        transform=None,
        group_level: str | None = None,
        simulate_hpc: bool = False,
        io_delay: float = 0.0,
        verbose_reads: bool = False,
    ):
        self.verbose_reads = verbose_reads  # DEBUG.DATASET.READ_ITEM_VERBOSE
        self.labels = labels
        self.source = image_source
        self.task_keys = list(task_keys)
        self.cache = MemoryCache(mem_cache_bytes) if mem_cache_bytes > 0 else None
        self.transform = transform
        self.group_level = group_level or (
            list(labels.group_ids.keys())[0] if labels.group_ids else None
        )
        self.simulate_hpc = simulate_hpc
        self.io_delay = io_delay

    def __len__(self) -> int:
        return self.labels.num_samples

    def set_group_level(self, level: str) -> None:
        if level in self.labels.group_ids:
            self.group_level = level

    def _read_image(self, idx: int) -> np.ndarray:
        if self.simulate_hpc and self.io_delay > 0:
            time.sleep(self.io_delay)
        if self.cache is not None:
            cached = self.cache.get(idx)
            if cached is not None:
                return cached
        img = self.source.read(int(idx))
        if self.cache is not None:
            self.cache.put(idx, img, img.nbytes)
        return img

    # transient-IO retry (reference: the "RETRY" sentinel in
    # base_prefetching_dataset.py:148-164 re-queues failed reads; here the
    # read path is synchronous per sample, so a bounded retry with backoff
    # gives the same resilience to flaky HPC filesystems)
    READ_RETRIES = 2

    def read_sample(self, idx: int):
        if self.verbose_reads:
            logger.debug(f"[READ_ITEM] idx={int(idx)}")
        last_err: Exception | None = None
        for attempt in range(self.READ_RETRIES + 1):
            try:
                img = self._read_image(idx)
                break
            except OSError as e:
                last_err = e
                if attempt == self.READ_RETRIES:
                    raise
                time.sleep(0.05 * (attempt + 1))
        if self.transform is not None:
            img = self.transform(img)
        return img

    def _can_bulk_read(self) -> bool:
        """Batch-at-a-time reads apply when the source does the whole batch
        in one call (H5ImageSource's direct-chunk gather, DirImageSource's
        data-plane decode) and no
        per-sample hook (transform, HPC read simulation, verbose read
        logging) needs the per-sample path."""
        return (
            hasattr(self.source, "supports_batch_read")
            and self.source.supports_batch_read()
            and self.transform is None
            and not (self.simulate_hpc and self.io_delay > 0)
            and not self.verbose_reads
        )

    def _bulk_images(self, indices: np.ndarray, pool=None) -> np.ndarray:
        """One-gather batch read: cache hits are taken per index, the
        misses go through the source's single batch call
        (``read_batch_rows``: the direct-chunk gather, or the data plane's
        file read, decode and resize), and rows land in their requested
        order."""
        idx = np.asarray(indices, np.int64)
        if len(idx) == 0:
            size = self.source.img_size
            return np.zeros((0, size, size, 3), np.uint8)
        hit_rows: dict[int, np.ndarray] = {}
        if self.cache is not None:
            for pos, i in enumerate(idx):
                cached = self.cache.get(int(i))
                if cached is not None:
                    hit_rows[pos] = cached
        miss_pos = [p for p in range(len(idx)) if p not in hit_rows]
        rows = None  # miss rows, aligned to miss_pos order
        if miss_pos:
            miss_idx = idx[miss_pos]
            for attempt in range(self.READ_RETRIES + 1):
                try:
                    rows = self._read_miss_rows(miss_idx, pool)
                    break
                except OSError:  # same transient-IO retry as read_sample
                    if attempt == self.READ_RETRIES:
                        raise
                    time.sleep(0.05 * (attempt + 1))
            if self.cache is not None:
                for row, i in zip(rows, miss_idx):
                    # copy: a view would pin the whole block in the cache
                    self.cache.put(int(i), row.copy(), row.nbytes)
        proto = rows[0] if rows is not None else next(iter(hit_rows.values()))
        out = np.empty((len(idx),) + tuple(proto.shape), dtype=proto.dtype)
        if miss_pos:
            out[miss_pos] = rows
        for pos, row in hit_rows.items():
            out[pos] = row
        return out

    def _read_miss_rows(self, miss_idx: np.ndarray, pool=None) -> np.ndarray:
        """Read rows for cache-miss indices, in the given order."""
        del pool  # the batch call reads the rows itself
        return self.source.read_batch_rows(miss_idx)

    def read_batch(self, indices: np.ndarray, pool=None) -> dict:
        indices = np.asarray(indices)
        if self._can_bulk_read():
            images = self._bulk_images(indices, pool=pool)
        elif pool is not None:
            images = np.stack(list(pool.map(self.read_sample, indices)))
        else:
            images = np.stack([self.read_sample(i) for i in indices])
        # Keep uint8 through the host pipeline: 4x less host work and
        # host->HBM bandwidth; the jitted step converts to the compute dtype
        # and scales by 1/255 on device (fused into the stem conv's input).
        if images.dtype != np.uint8:
            images = images.astype(np.float32)
            if images.max() > 1.5:  # transform emitted uint8 range
                images = images / 255.0
        batch = {
            "images": images,
            "targets": {
                t: self.labels.labels[t][indices].astype(np.int32)
                for t in self.task_keys
            },
            "aux": self.labels.aux[indices].astype(np.float32),
            "group_ids": (
                self.labels.group_ids[self.group_level][indices].astype(np.int32)
                if self.group_level
                else np.zeros(len(indices), np.int32)
            ),
        }
        return batch

    def close(self) -> None:
        self.source.close()
