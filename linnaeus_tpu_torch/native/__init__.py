"""Host data plane: batched JPEG decode with DCT prescale and area resize,
in worker threads that do not hold the GIL.

Port of linnaeus_tpu/native/ (``__init__.py`` and ``dataplane.cpp``). The
interface and its contract are the original's: ``get_dataplane()`` (a
singleton, ``None`` under ``LINNAEUS_TPU_NATIVE=0``), and
``DataPlane.decode_jpeg_batch`` / ``decode_jpeg_mem_batch`` returning
``(uint8 [n, t, t, 3], int32 status [n])`` with the statuses 0 ok, 1 missing
(ENOENT, ENOTDIR), 2 decode error, 3 open error, every non-OK row zero-filled.

The inside is cv2 instead of a C++ library over libjpeg, and it computes what
``dataplane.cpp`` computes, step by step:

- the frame header is read first (``jpeg_header``: width, height and
  components from the SOF marker, no decode), and the DCT scale denominator
  is the largest of 8, 4, 2 whose output still covers the target on both
  sides, else 1 (``scale_denom``);
- the decode is ``cv2.imdecode`` under ``IMREAD_REDUCED_COLOR_{d}`` (the
  same libjpeg-turbo ``scale_denom``), with the EXIF orientation ignored as
  libjpeg ignores it; cv2 replicates a grayscale frame to three channels;
- the resize: the same size is a copy; a source that covers the target on
  both sides is area-resized (``INTER_AREA``); any other is bilinear with
  the half-pixel convention (``INTER_LINEAR``); both in float32, rounded
  as the original rounds (v + 0.5, truncated);
- status 2 wherever libjpeg refuses, even where cv2 would decode: bytes
  without the SOI marker (PNG content behind a ``.jpg`` name), a frame of
  other than 1 or 3 components (CMYK, YCCK), no frame header, an empty file,
  and data ``imdecode`` cannot decode. Data that ends early decodes as
  libjpeg decodes it, the missing blocks empty (status 0).

cv2's decode and resize release the GIL, and so does the file read. One
process-wide pool of ``os.cpu_count() - 1`` threads serves every call, the
caller working too; ``threads=k`` bounds one call's concurrency to k, as the
original's shared pool does. cv2's own threads (``cv2.setNumThreads``) are
left as the process set them.

cv2 is imported where an image is decoded, never when this module is: where
it cannot be imported ``get_dataplane()`` returns ``None``, the counterpart
of the original's failed build.
"""

from __future__ import annotations

import importlib.util
import itertools
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np

from linnaeus_tpu_torch.utils.logging import get_main_logger

logger = get_main_logger()

OK, MISSING, DECODE_ERR, OPEN_ERR = 0, 1, 2, 3

_LOCK = threading.Lock()
_CACHED: "DataPlane | None | bool" = False  # False = not attempted yet

# SOF markers: every 0xC0-0xCF but DHT (C4), JPG (C8) and DAC (CC)
_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}
# markers without a length field: TEM and RST0-7 (SOI and EOI end the scan)
_STANDALONE = frozenset([0x01, *range(0xD0, 0xD8)])


def jpeg_header(buf: bytes) -> tuple[int, int, int] | None:
    """(width, height, components) of the first frame header of JPEG bytes,
    or None where there is no SOI marker or no readable frame header."""
    n = len(buf)
    if n < 4 or buf[0] != 0xFF or buf[1] != 0xD8:
        return None
    pos = 2
    while pos < n:
        if buf[pos] != 0xFF:  # libjpeg skips garbage between markers
            pos += 1
            continue
        while pos < n and buf[pos] == 0xFF:  # fill bytes
            pos += 1
        if pos >= n:
            return None
        marker = buf[pos]
        pos += 1
        if marker in _STANDALONE:
            continue
        if marker in (0xD8, 0xD9, 0xDA):  # SOI, EOI or a scan before any frame
            return None
        if pos + 2 > n:
            return None
        length = (buf[pos] << 8) | buf[pos + 1]
        if marker in _SOF:
            if length < 8 or pos + 8 > n:
                return None
            height = (buf[pos + 3] << 8) | buf[pos + 4]
            width = (buf[pos + 5] << 8) | buf[pos + 6]
            return width, height, buf[pos + 7]
        if length < 2:
            return None
        pos += length
    return None


def scale_denom(width: int, height: int, target: int) -> int:
    """The largest DCT scale denominator of 8, 4, 2 whose output still
    covers ``target`` on both sides, else 1 (dataplane.cpp:157-163)."""
    for d in (8, 4, 2):
        if width // d >= target and height // d >= target:
            return d
    return 1


def _decode_mem(buf: bytes, target: int, out: np.ndarray) -> int:
    """Decode JPEG bytes into ``out`` (uint8 [target, target, 3], RGB);
    returns the status and leaves ``out`` unwritten on a failure."""
    import cv2

    header = jpeg_header(buf)
    if header is None:
        return DECODE_ERR
    width, height, components = header
    if components not in (1, 3) or width == 0 or height == 0:
        return DECODE_ERR
    d = scale_denom(width, height, target)
    flags = {1: cv2.IMREAD_COLOR, 2: cv2.IMREAD_REDUCED_COLOR_2,
             4: cv2.IMREAD_REDUCED_COLOR_4, 8: cv2.IMREAD_REDUCED_COLOR_8}[d]
    flags |= cv2.IMREAD_IGNORE_ORIENTATION
    try:
        bgr = cv2.imdecode(np.frombuffer(buf, np.uint8), flags)
        if bgr is None:
            # data that ends early: libjpeg's memory source inserts an EOI
            # marker there and decodes the rest as empty blocks (a warning,
            # not an error); cv2 stops instead unless the marker is there
            bgr = cv2.imdecode(np.frombuffer(buf + b"\xff\xd9", np.uint8), flags)
    except cv2.error:
        return DECODE_ERR
    if bgr is None or bgr.ndim != 3 or bgr.shape[2] != 3:
        return DECODE_ERR
    sh, sw = bgr.shape[:2]
    if (sh, sw) == (target, target):
        cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB, dst=out)
        return OK
    # in float32, then v + 0.5 truncated as dataplane.cpp rounds (cv2's
    # uint8 resize rounds halves to even: 1 u8 off on a sixth of the pixels
    # at a scale of 4/3)
    interp = cv2.INTER_AREA if sh >= target and sw >= target else cv2.INTER_LINEAR
    rgb = cv2.cvtColor(cv2.resize(bgr.astype(np.float32), (target, target),
                                  interpolation=interp), cv2.COLOR_BGR2RGB)
    np.add(rgb, 0.5, out=rgb)
    np.clip(rgb, 0.0, 255.0, out=rgb)
    np.copyto(out, rgb, casting="unsafe")
    return OK


def _decode_file(path: str, target: int, out: np.ndarray) -> int:
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except (FileNotFoundError, NotADirectoryError):
        return MISSING
    except OSError:
        return OPEN_ERR
    if not buf:
        return DECODE_ERR
    return _decode_mem(buf, target, out)


class _Pool:
    """One fixed set of worker threads for every call in the process.
    ``run(n, cap, fn)`` calls ``fn(i)`` for i < n with at most ``cap`` of
    them at once, the caller among them; concurrent callers share the
    workers instead of each spawning its own (dataplane.cpp's ``Pool``)."""

    def __init__(self, workers: int):
        self.workers = workers
        self._executor: ThreadPoolExecutor | None = None
        self._lock = threading.Lock()

    def _get(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=self.workers, thread_name_prefix="dataplane")
            return self._executor

    def run(self, n: int, cap: int, fn: Callable[[int], None]) -> None:
        cap = max(1, min(cap, n))
        if cap == 1 or self.workers == 0:
            for i in range(n):
                fn(i)
            return
        counter = itertools.count()  # next() is atomic under the GIL

        def drain():
            for i in iter(counter.__next__, None):
                if i >= n:
                    return
                fn(i)

        executor = self._get()
        helpers = [executor.submit(drain) for _ in range(cap - 1)]
        drain()
        for h in helpers:
            h.result()


class DataPlane:
    """The batched decode over cv2 and the shared pool. ``file_batches``
    and ``mem_batches`` count the calls of each kind."""

    version = 3  # the original's contract: v3, `threads` bounds a call

    def __init__(self):
        self.default_threads = max(os.cpu_count() or 1, 1)
        self._pool = _Pool(self.default_threads - 1)
        self._count_lock = threading.Lock()
        self.file_batches = 0
        self.mem_batches = 0

    def _batch(self, decode, items: list, target: int, threads: int | None):
        n = len(items)
        out = np.empty((n, target, target, 3), np.uint8)
        status = np.empty(n, np.int32)

        def one(i):
            st = decode(items[i], target, out[i])
            status[i] = st
            if st != OK:  # every failed row reads as an obvious placeholder
                out[i] = 0

        self._pool.run(n, int(threads or self.default_threads), one)
        return out, status

    def decode_jpeg_batch(
        self,
        paths: list[str],
        target: int,
        allow_missing: bool = False,
        threads: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Decode and resize a batch of JPEG files -> (images [n, t, t, 3]
        uint8, status [n] int32: 0 ok / 1 missing / 2 decode error / 3 open
        error). Raises OSError where a file exists but cannot be opened
        (never zero-filled: retryable) and FileNotFoundError for a missing
        file unless ``allow_missing``. Rows of status 2 do not raise: the
        caller retries them with its per-sample decoder."""
        with self._count_lock:
            self.file_batches += 1
        out, status = self._batch(_decode_file, [os.fsdecode(p) for p in paths],
                                  int(target), threads)
        unreadable = [paths[i] for i in np.nonzero(status == OPEN_ERR)[0][:3]]
        if unreadable:
            raise OSError(
                f"{int((status == OPEN_ERR).sum())} image files exist but could "
                f"not be opened (fd exhaustion / permissions / IO?), e.g. {unreadable}")
        if not allow_missing and (status == MISSING).any():
            missing = [paths[i] for i in np.nonzero(status == MISSING)[0][:3]]
            raise FileNotFoundError(
                f"{int((status == MISSING).sum())} missing image files, e.g. {missing}")
        return out, status

    def decode_jpeg_mem_batch(
        self,
        buffers: list[bytes],
        target: int,
        threads: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Decode and resize in-memory JPEG buffers -> (images [n, t, t, 3]
        uint8, status [n] int32: 0 ok / 2 decode error, its row zero-filled).
        Never raises on a bad buffer: a shared serving batch must not fail
        whole, the caller decides per sample."""
        with self._count_lock:
            self.mem_batches += 1
        return self._batch(_decode_mem, list(buffers), int(target), threads)


def get_dataplane() -> DataPlane | None:
    """The process's data plane, built on the first call; None under
    LINNAEUS_TPU_NATIVE=0 or where cv2 cannot be imported."""
    global _CACHED
    with _LOCK:
        if _CACHED is not False:
            return _CACHED  # type: ignore[return-value]
        if os.environ.get("LINNAEUS_TPU_NATIVE", "1") == "0":
            _CACHED = None
        elif importlib.util.find_spec("cv2") is None:
            logger.info("host data plane unavailable: cv2 is not installed")
            _CACHED = None
        else:
            _CACHED = DataPlane()
        return _CACHED
