"""AutoBatch: the largest batch whose step fits a share of the card's memory.

Port of linnaeus_tpu/train/autobatch.py (reference parity:
utils/autobatch.py:111-610). The search, ``auto_find_batch_size``, is the
TPU package's as it is: the bounds aligned to ``multiple_of``, the minimum
taken when even it does not fit, the maximum when it fits, else a binary
search between them. Where the TPU package reads the compiled step's memory
analysis, a trial here runs DATA.AUTOBATCH.STEPS_PER_TRIAL (default 2: the
first step allocates the optimizer's moments, the second runs with them
resident, as every later step does) real steps at the candidate batch and
reads ``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats`` (``measure_peak_bytes``), against
``total_memory`` of the card times the target fraction. A trial that runs
out of memory (``torch.cuda.OutOfMemoryError``) does not fit, as a failed
compile does in the TPU package; its memory is released before the next.
Without a card there is nothing to measure, and the probe raises by name.
"""

from __future__ import annotations

import gc
from typing import Callable

import torch

from linnaeus_tpu_torch.utils.logging import get_main_logger

logger = get_main_logger()


def device_memory_bytes(device: torch.device) -> int:
    """The card's memory in bytes; raises by name for any other device."""
    device = torch.device(device)
    if device.type != "cuda":
        raise NotImplementedError(
            f"DATA.AUTOBATCH: the batch-size probe measures CUDA memory; on {device} there is "
            "none to measure (set DATA.BATCH_SIZE / BATCH_SIZE_VAL instead)")
    return int(torch.cuda.get_device_properties(device).total_memory)


def measure_peak_bytes(run_trial: Callable[[int], None], batch_size: int,
                       device: torch.device) -> int:
    """Peak bytes allocated on ``device`` while ``run_trial(batch_size)``
    runs, the memory held before it included. The trial's tensors are
    released before this returns."""
    device_memory_bytes(device)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    run_trial(batch_size)
    torch.cuda.synchronize(device)
    peak = int(torch.cuda.max_memory_allocated(device))
    gc.collect()
    torch.cuda.empty_cache()
    return peak


def auto_find_batch_size(
    measure: Callable[[int], int],
    target_memory_fraction: float = 0.8,
    min_batch_size: int = 1,
    max_batch_size: int = 512,
    total_bytes: int = 0,
    multiple_of: int = 1,
    trials: dict[int, int | None] | None = None,
) -> int:
    """Binary search the largest batch whose measured need fits the budget,
    ``total_bytes * target_memory_fraction``. ``measure(batch_size)``
    returns the bytes a step at that batch needs; raising
    ``torch.cuda.OutOfMemoryError`` means it does not fit. ``trials``, when
    given, collects each tried batch's bytes (None: out of memory)."""
    budget = int(total_bytes * target_memory_fraction)
    logger.info(
        f"AutoBatch: budget {budget / 1e9:.2f} GB "
        f"(fraction {target_memory_fraction} of {total_bytes / 1e9:.1f} GB)"
    )

    def fits(bs: int) -> bool:
        need = None
        try:
            need = measure(bs)
        except torch.cuda.OutOfMemoryError as e:  # out of memory == does not fit
            logger.warning(f"AutoBatch: out of memory at batch {bs}: {str(e)[:200]}")
        if trials is not None:
            trials[bs] = need
        if need is None:
            # outside the handler: its traceback held the trial's tensors
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            return False
        ok = need <= budget
        logger.info(
            f"AutoBatch trial bs={bs}: {need / 1e9:.2f} GB -> "
            f"{'fits' if ok else 'exceeds budget'}"
        )
        return ok

    def align(bs: int) -> int:
        return max((bs // multiple_of) * multiple_of, multiple_of)

    lo, hi = align(min_batch_size), align(max_batch_size)
    if not fits(lo):
        logger.warning(f"AutoBatch: even min batch {lo} exceeds budget; using it")
        return lo
    if fits(hi):
        return hi
    # invariant: fits(lo), not fits(hi)
    while hi - lo > multiple_of:
        mid = align((lo + hi) // 2)
        if mid in (lo, hi):
            break
        if fits(mid):
            lo = mid
        else:
            hi = mid
    logger.info(f"AutoBatch result: {lo}")
    return lo
