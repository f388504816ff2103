"""Background batched sender recovery (semantics of coreth
core/sender_cacher.go); counterpart of coreth_tpu/core/sender_cacher.py.

The reference fans ecrecover across N goroutines with a strided split
(sender_cacher.go:88-115). Here the seam is batch-first: recover() takes
the whole tx slice and dispatches strided shards of it to a thread pool,
each shard one native batched recovery (native/secp.py, through
Signer.sender_batch), so the Python-side item building of one shard
overlaps the GIL-released native recovery of the others. A failed native
build raises, as everywhere in the port: there is no pure-Python path.

recover() tags each dispatch with a batch token so wait(token) joins one
block's futures only: with the insert pipeline keeping two blocks in
flight, a global wait would serialize block k+1's recovery behind block
k's. A cacher that crossed a fork rebuilds its thread pool before use
(_ensure_pool).

Not ported: the reference's caller-supplied `batch_recover` and
`recover_from_block`, which only its tests use.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from ..metrics import default_registry as _metrics
from ..metrics.spans import span
from ..native import default_cpu_threads
from .types import Signer, Transaction

# txs below this per shard aren't worth a second dispatch wave: the
# shard's Python-side item building is cheaper than the bookkeeping
_SHARD_MIN = 64

# per-shard wall time; rolls up under the chain/phase/recover clock the
# insert path wraps around wait()
_shard_timer = _metrics.timer("chain/recover/shard")


class TxSenderCacher:
    def __init__(self, threads: int = 4):
        self.threads = max(threads, 1)
        self._pool = ThreadPoolExecutor(max_workers=self.threads)
        self._lock = threading.Lock()
        # batch token -> outstanding futures for that recover() call
        self._batches: Dict[int, list] = {}  # guarded-by: _lock
        self._tokens = itertools.count(1)
        # fork guard: fork copies only the calling thread, so an inherited
        # ThreadPoolExecutor is a threadless shell — submit() would queue
        # work nobody runs and wait() would hang forever on it
        self._owner_pid = os.getpid()  # guarded-by: _lock

    def _ensure_pool(self) -> None:
        """Respawn-after-fork guard: if this cacher object crossed a
        fork, its pool's worker threads did not — submits would queue
        work nobody runs and waits would hang. Rebuild the pool (and
        drop the parent's futures — they can never complete here) before
        any dispatch or join. The unlocked pre-check is benign: the pid
        only changes across fork, and a forked child starts single-
        threaded."""
        if os.getpid() == self._owner_pid:
            return
        with self._lock:
            pid = os.getpid()
            if pid == self._owner_pid:
                return
            _metrics.counter("exec/shard/fork_guard_trips").inc()
            self._pool = ThreadPoolExecutor(max_workers=self.threads)
            self._batches.clear()
            self._owner_pid = pid

    def recover(self, signer: Signer, txs: List[Transaction]) -> Optional[int]:
        """Kick off sender recovery for txs; results land in each tx's
        _sender cache so later Sender() calls are free. Returns a batch
        token for wait(token) (None when there was nothing to do)."""
        if not txs:
            return None
        self._ensure_pool()
        # prune finished batches so the fire-and-forget path stays bounded
        with self._lock:
            for tok in [t for t, fs in self._batches.items()
                        if all(f.done() for f in fs)]:
                del self._batches[tok]
            token = next(self._tokens)

        def work_batch(chunk, shard=0, of=1, native_threads=0):
            t0 = time.perf_counter()
            try:
                with span("chain/recover/shard", shard=shard, of=of,
                          txs=len(chunk)):
                    signer.sender_batch(chunk, native_threads=native_threads)
            except Exception:
                for tx in chunk:
                    try:
                        signer.sender(tx)
                    except Exception:
                        # recovery here is a prefetch — the insert path
                        # re-derives senders and surfaces the real error —
                        # but a malformed-signature flood must be visible
                        _metrics.counter(
                            "core/sender_cacher/recover_error").inc()
            _shard_timer.update(time.perf_counter() - t0)

        # strided shards across the CPU-thread pool, each pinned to ONE
        # native thread (sender_cacher.go:88-115's strided split)
        n = min(self.threads, max(1, len(txs) // _SHARD_MIN))
        if n <= 1:
            futs = [self._pool.submit(work_batch, txs)]
        else:
            futs = [self._pool.submit(work_batch, txs[i::n], i, n, 1)
                    for i in range(n)]
        # under _lock: a concurrent wait() pops the batch, and an unlocked
        # store can land after the pop and be lost
        with self._lock:
            self._batches[token] = futs
        return token

    def wait(self, token: Optional[int] = None) -> None:
        """Join one recover() batch (by token), or every outstanding
        batch when token is None. A token that already completed (or was
        pruned, or is None from an empty recover) is a no-op — senders
        for those txs are cached either way."""
        self._ensure_pool()
        with self._lock:
            if token is None:
                futures = [f for fs in self._batches.values() for f in fs]
                self._batches.clear()
            else:
                futures = self._batches.pop(token, [])
        for f in futures:
            f.result()

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False)


# module-level shared cacher (core/sender_cacher.go txSenderCacher
# singleton), as wide as the shared CPU-thread policy (the
# CORETH_TPU_CPU_THREADS env override, else min(16, cores)). Its pool
# starts no thread until the first recover().
sender_cacher = TxSenderCacher(threads=default_cpu_threads())
