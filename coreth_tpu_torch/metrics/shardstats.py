"""Shard-worker telemetry accumulator; counterpart of
coreth_tpu/metrics/shardstats.py.

Exec-shard workers (core/shard_worker.py) hold no metrics registry: the
registry carries locks, spans and an export thread that belong to the
parent. This module is the worker's alternative: pure stdlib, no
package-relative imports, no module-level mutable state, no threads. A
worker builds ONE `ShardStats` function-locally, accumulates counter/timer
deltas while executing, and ships `snapshot_and_reset()`'s compact dict
piggybacked on each write-set reply; the PARENT (core/exec_shards.py)
merges those deltas into the real registry under `exec/shard/worker/<i>/*`
and stamps per-shard execute time into the pipeline flight records.

The wire shape is two flat str->number dicts, picklable by the
multiprocessing Connection with no custom reduction:

    {"counts": {"txs": 17, "errors": 0},
     "seconds": {"execute": 0.0123}}

tests/test_torch_isolation.py holds shard_worker's module-level imports to
the stdlib, `fault` and this module.
"""

from __future__ import annotations

import time
from typing import Dict


class ShardStats:
    """Local counter/timer delta accumulator; one per worker loop."""

    __slots__ = ("counts", "seconds")

    def __init__(self) -> None:
        self.counts: Dict[str, int] = {}
        self.seconds: Dict[str, float] = {}

    def inc(self, key: str, n: int = 1) -> None:
        self.counts[key] = self.counts.get(key, 0) + n

    def add_seconds(self, key: str, s: float) -> None:
        self.seconds[key] = self.seconds.get(key, 0.0) + s

    def timed(self, key: str) -> "_Timed":
        return _Timed(self, key)

    def snapshot_and_reset(self) -> Dict[str, Dict[str, float]]:
        """The piggyback payload: current deltas, then zeroed — each
        dispatch reply carries only what THAT dispatch accumulated, so
        the parent-side merge is exactly-once by construction."""
        snap = {"counts": dict(self.counts), "seconds": dict(self.seconds)}
        self.counts.clear()
        self.seconds.clear()
        return snap


class _Timed:
    """`with stats.timed("execute"):` — monotonic span accumulator."""

    __slots__ = ("_stats", "_key", "_t0")

    def __init__(self, stats: ShardStats, key: str) -> None:
        self._stats = stats
        self._key = key
        self._t0 = 0.0

    def __enter__(self) -> "_Timed":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        self._stats.add_seconds(self._key, time.monotonic() - self._t0)
        return False
