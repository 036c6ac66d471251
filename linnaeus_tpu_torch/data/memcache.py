"""Byte-budgeted LRU cache for raw samples (reference: h5data/memcache.py:10).

Copy of linnaeus_tpu/data/memcache.py (held against the original by
tests/test_torch_data_pipeline.py).
"""

from __future__ import annotations

import threading
from collections import OrderedDict


class MemoryCache:
    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._store: OrderedDict = OrderedDict()
        self._sizes: dict = {}
        self._used = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key):
        with self._lock:
            if key in self._store:
                self._store.move_to_end(key)
                self.hits += 1
                return self._store[key]
            self.misses += 1
            return None

    def put(self, key, value, size: int | None = None) -> None:
        if size is None:
            size = getattr(value, "nbytes", 0) or 1
        if size > self.max_bytes:
            return
        with self._lock:
            if key in self._store:
                self._used -= self._sizes[key]
                del self._store[key]
            while self._used + size > self.max_bytes and self._store:
                old_key, _ = self._store.popitem(last=False)
                self._used -= self._sizes.pop(old_key)
                self.evictions += 1
            self._store[key] = value
            self._sizes[key] = size
            self._used += size

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "items": len(self._store),
                "bytes": self._used,
                "hit_rate": self.hits / total if total else 0.0,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }
