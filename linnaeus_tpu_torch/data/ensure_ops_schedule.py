"""Defensive late-binding of an OpsSchedule onto loaders.

Copy of linnaeus_tpu/data/ensure_ops_schedule.py (reference parity:
h5data/ensure_ops_schedule.py:14). In this framework the
schedule never lives on the loader (probabilities flow into the step as
operands), so this shim only validates wiring for code written against
the reference API.
"""

from __future__ import annotations

from linnaeus_tpu_torch.utils.logging import get_h5data_logger

logger = get_h5data_logger()


def ensure_ops_schedule(loader, ops_schedule) -> None:
    """Attach an ops_schedule attribute if a consumer expects one."""
    if ops_schedule is None:
        logger.warning("ensure_ops_schedule called with None schedule")
        return
    if getattr(loader, "ops_schedule", None) is None:
        loader.ops_schedule = ops_schedule
        logger.debug("ops_schedule late-bound onto loader")
