"""HPC / preemption utilities.

Copy of linnaeus_tpu/utils/hpc.py (held against the original by
tests/test_torch_trainer.py).

Reference parity: utils/hpc_utils.py:16-43 — SLURM preemption handling via
SIGUSR1/SIGTERM: mark the run preempting (wandb tag), request a checkpoint,
and rely on AUTO_RESUME for recovery. Also the layered graceful-shutdown
registry from main.py:104-352 (atexit + signals + excepthook draining a
weakref resource registry).
"""

from __future__ import annotations

import atexit
import signal
import sys
import threading
import weakref
from typing import Callable

from linnaeus_tpu_torch.utils.logging import get_main_logger

logger = get_main_logger()


class ShutdownRegistry:
    """Weakref registry of closeable resources, drained exactly once on
    exit/signal/exception (reference: main.py:104-352)."""

    def __init__(self):
        self._resources: weakref.WeakSet = weakref.WeakSet()
        self._callbacks: list[Callable] = []
        self._lock = threading.Lock()
        self._drained = False
        self.preempted = threading.Event()

    def register(self, resource) -> None:
        """Register anything with a .close() method."""
        self._resources.add(resource)

    def unregister(self, resource) -> None:
        """Drop a resource that was replaced before it was used."""
        self._resources.discard(resource)

    def register_callback(self, fn: Callable) -> None:
        self._callbacks.append(fn)

    def unregister_callback(self, fn: Callable) -> None:
        """Drop a callback (a Trainer that is closed before the process
        ends), so the registry no longer holds what it refers to."""
        self._callbacks = [f for f in self._callbacks if f != fn]

    def drain(self) -> None:
        with self._lock:
            if self._drained:
                return
            self._drained = True
        for fn in self._callbacks:
            try:
                fn()
            except Exception as e:
                logger.warning(f"shutdown callback failed: {e}")
        for r in list(self._resources):
            try:
                r.close()
            except Exception as e:
                logger.warning(f"resource close failed: {e}")
        logger.info("Shutdown registry drained")

    def install_handlers(self) -> None:
        atexit.register(self.drain)

        def on_signal(signum, frame):
            logger.warning(f"Received signal {signum}; initiating shutdown")
            if signum in (signal.SIGUSR1, signal.SIGTERM):
                self.preempted.set()
            self.drain()
            if signum == signal.SIGINT:
                raise KeyboardInterrupt

        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                signal.signal(sig, on_signal)
            except (ValueError, OSError):
                pass  # not the main thread
        try:
            signal.signal(signal.SIGUSR1, on_signal)
        except (ValueError, OSError, AttributeError):
            pass

        prev_hook = sys.excepthook

        def hook(exc_type, exc, tb):
            self.drain()
            prev_hook(exc_type, exc, tb)

        sys.excepthook = hook


_registry: ShutdownRegistry | None = None


def get_shutdown_registry() -> ShutdownRegistry:
    global _registry
    if _registry is None:
        _registry = ShutdownRegistry()
    return _registry


def mark_wandb_preempting(wandb_run) -> None:
    """Tag the wandb run as preempting (utils/hpc_utils.py:16-43)."""
    if wandb_run is None:
        return
    try:
        wandb_run.mark_preempting()
    except Exception as e:
        logger.warning(f"wandb mark_preempting failed: {e}")
