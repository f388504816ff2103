"""Concurrent trie prefetcher (semantics of coreth
core/state/trie_prefetcher.go); counterpart of
coreth_tpu/state/trie_prefetcher.py.

During tx execution the StateDB schedules (owner, keys) onto subfetchers —
one worker per trie — which resolve the touched paths so the commit-phase
hash walk hits warm nodes instead of disk: a warm dirty set means the
device hashers spend their time hashing, not faulting node reads. A
resident account trie starts no prefetcher (StateDB.start_prefetcher)."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ..metrics import count_drop


class _SubFetcher:
    """One background worker warming one trie (trie_prefetcher.go:212+)."""

    def __init__(self, db, owner: bytes, root: bytes):
        self.db = db
        self.owner = owner
        self.root = root
        self.tasks: List[bytes] = []
        self.seen: set = set()
        self.lock = threading.Lock()
        self.wake = threading.Event()
        self.stop_flag = False
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def schedule(self, keys: List[bytes]) -> None:
        with self.lock:
            self.tasks.extend(keys)
        self.wake.set()

    def _loop(self) -> None:
        try:
            trie = (
                self.db.open_trie(self.root)
                if self.owner == b""
                else self.db.open_storage_trie(self.owner, self.root)
            )
        except Exception:
            # a warmer that cannot even open its trie is a silent no-op
            # for correctness, but the drop must be visible
            count_drop("state/prefetch/error")
            return
        while True:
            self.wake.wait(timeout=0.5)
            self.wake.clear()
            if self.stop_flag:
                return
            with self.lock:
                tasks, self.tasks = self.tasks, []
            for key in tasks:
                if key in self.seen:
                    continue
                self.seen.add(key)
                try:
                    trie.get(key)  # resolves + caches the path's nodes
                except Exception:
                    # prefetch is best-effort — the real read will fault
                    # the node in — but never drop silently
                    count_drop("state/prefetch/error")

    def stop(self) -> None:
        self.stop_flag = True
        self.wake.set()
        self.thread.join(timeout=2)


class TriePrefetcher:
    """trie_prefetcher.go:47-62: a fetcher per (owner, root)."""

    def __init__(self, db, namespace: str = "chain"):
        self.db = db
        self.namespace = namespace
        self.fetchers: Dict[Tuple[bytes, bytes], _SubFetcher] = {}
        self.closed = False

    def prefetch(self, owner: bytes, root: bytes, keys: List[bytes]) -> None:
        if self.closed:
            return
        f = self.fetchers.get((owner, root))
        if f is None:
            f = _SubFetcher(self.db, owner, root)
            self.fetchers[(owner, root)] = f
        f.schedule(keys)

    def close(self) -> None:
        self.closed = True
        for f in self.fetchers.values():
            f.stop()
        self.fetchers = {}
