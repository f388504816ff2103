"""Bounded result caches for the lock-free read tier; counterpart of
coreth_tpu/eth/cache.py.

Two read paths would pay repeated work per request at saturation: the
gasprice oracle re-walks
CHECK_BLOCKS accepted blocks on every eth_gasPrice, and eth_getLogs
re-runs the bloom-bit index candidate scan for identical criteria.
Both results are pure functions of immutable inputs (an accepted head
hash; a fully-indexed section), so a small LRU in front of each turns
the hot-path cost into a dict hit.

Aggregate `eth/cache/{hits,misses}` counters plus a per-cache pair
(`eth/cache/<name>/{hits,misses}`) make the hit rate visible per knob.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Hashable

from ..metrics import default_registry as _metrics

_SENTINEL = object()


class BoundedCache:
    """Thread-safe LRU of [size] entries. size <= 0 disables the cache
    entirely (every get misses, puts drop) — the knobs' off switch.

    The lock is held only for the OrderedDict bookkeeping, never across
    value computation: callers do get → compute → put, accepting that
    two racing readers may compute the same value once each (cheap and
    correct — values are immutable)."""

    def __init__(self, name: str, size: int):
        self.name = name
        self.size = size
        self._mu = threading.Lock()
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._hits = _metrics.counter(f"eth/cache/{name}/hits")
        self._misses = _metrics.counter(f"eth/cache/{name}/misses")
        self._agg_hits = _metrics.counter("eth/cache/hits")
        self._agg_misses = _metrics.counter("eth/cache/misses")

    def get(self, key: Hashable, default: Any = None) -> Any:
        with self._mu:
            val = self._entries.get(key, _SENTINEL)
            if val is not _SENTINEL:
                self._entries.move_to_end(key)
        if val is _SENTINEL:
            self._misses.inc()
            self._agg_misses.inc()
            return default
        self._hits.inc()
        self._agg_hits.inc()
        return val

    def put(self, key: Hashable, value: Any) -> None:
        if self.size <= 0:
            return
        with self._mu:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.size:
                self._entries.popitem(last=False)

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)

    def clear(self) -> None:
        with self._mu:
            self._entries.clear()
