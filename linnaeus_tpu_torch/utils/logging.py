"""Dual-logger setup (main + data pipeline), per-process file/console logging.

Copy of linnaeus_tpu/utils/logging.py.

Reimplements the surface of the reference loggers
(/root/reference/linnaeus/utils/logging/logger.py:16-150): a ``linnaeus``
main logger and a separate ``h5data`` logger, each optionally writing to a
per-process log file.

Port of linnaeus_tpu/utils/logging.py, under the port's own logger names
(``linnaeus_tpu_torch``), so the two packages' loggers stay apart in one
process. Reconfiguring a logger removes its handlers first, so building
several Trainers in one process does not pile handlers up.
"""

from __future__ import annotations

import logging
import os
import sys

MAIN_LOGGER_NAME = "linnaeus_tpu_torch"
H5DATA_LOGGER_NAME = "linnaeus_tpu_torch.h5data"

_FORMAT = "[%(asctime)s] (%(filename)s:%(lineno)d) %(levelname)s: %(message)s"


class SafeLogger(logging.Logger):
    """Logger that never raises from a logging call."""

    def handle(self, record):
        try:
            super().handle(record)
        except Exception:
            pass


logging.setLoggerClass(SafeLogger)


def _configure(
    name: str,
    level: str = "INFO",
    log_dir: str | None = None,
    file_prefix: str | None = None,
    process_index: int = 0,
    to_console: bool = True,
) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(getattr(logging, str(level).upper(), logging.INFO))
    logger.propagate = False
    # Reset handlers to allow reconfiguration in tests
    for h in list(logger.handlers):
        logger.removeHandler(h)
    fmt = logging.Formatter(_FORMAT, datefmt="%Y-%m-%d %H:%M:%S")
    if to_console:
        ch = logging.StreamHandler(sys.stdout)
        ch.setFormatter(fmt)
        logger.addHandler(ch)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fname = f"{file_prefix or name}_p{process_index}.log"
        fh = logging.FileHandler(os.path.join(log_dir, fname))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def create_logger(
    log_dir: str | None = None,
    level: str = "INFO",
    process_index: int = 0,
    to_console: bool | None = None,
) -> logging.Logger:
    """Create/reconfigure the main framework logger."""
    if to_console is None:
        to_console = process_index == 0
    return _configure(
        MAIN_LOGGER_NAME,
        level=level,
        log_dir=log_dir,
        file_prefix="main",
        process_index=process_index,
        to_console=to_console,
    )


def create_h5data_logger(
    log_dir: str | None = None,
    level: str = "INFO",
    process_index: int = 0,
    to_console: bool = False,
) -> logging.Logger:
    """Create/reconfigure the data-pipeline logger."""
    return _configure(
        H5DATA_LOGGER_NAME,
        level=level,
        log_dir=log_dir,
        file_prefix="h5data",
        process_index=process_index,
        to_console=to_console,
    )


def get_main_logger() -> logging.Logger:
    logger = logging.getLogger(MAIN_LOGGER_NAME)
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    return logger


def get_h5data_logger() -> logging.Logger:
    logger = logging.getLogger(H5DATA_LOGGER_NAME)
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    return logger
