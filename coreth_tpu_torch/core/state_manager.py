"""Trie commitment policy (semantics of coreth core/state_manager.go);
counterpart of coreth_tpu/core/state_manager.py.

Two TrieWriter flavors drive the TrieDatabase from the chain, and a third
drives the resident account mirror:

  NoPruningTrieWriter      — archival: commit every block's root to disk
                             (state_manager.go:97-113).
  CappedMemoryTrieWriter   — pruning: keep roots in the in-memory forest,
                             commit to disk every COMMIT_INTERVAL accepted
                             blocks, keep a TIP_BUFFER of dereferenceable
                             roots, and optimistically flush within the last
                             FLUSH_WINDOW blocks before a commit boundary
                             (state_manager.go:43-58,126-186).
  ResidentTrieWriter       — resident mode: the account trie's lifecycle
                             rides trie/resident_mirror.py, with an interval
                             export of changed account nodes to disk.
"""

from __future__ import annotations

from ..trie.node import EMPTY_ROOT
from ..trie.triedb import TrieDatabase

COMMIT_INTERVAL = 4096
TIP_BUFFER_SIZE = 32
FLUSH_WINDOW = 768


class TrieWriter:
    def insert_trie(self, block) -> None:
        raise NotImplementedError

    def accept_trie(self, block) -> None:
        raise NotImplementedError

    def reject_trie(self, block) -> None:
        raise NotImplementedError

    def shutdown(self) -> None:
        raise NotImplementedError


class NoPruningTrieWriter(TrieWriter):
    def __init__(self, triedb: TrieDatabase):
        self.db = triedb

    def insert_trie(self, block) -> None:
        self.db.reference(block.root)

    def accept_trie(self, block) -> None:
        self.db.commit(block.root)

    def reject_trie(self, block) -> None:
        self.db.dereference(block.root)

    def shutdown(self) -> None:
        pass


class CappedMemoryTrieWriter(TrieWriter):
    def __init__(
        self,
        triedb: TrieDatabase,
        commit_interval: int = COMMIT_INTERVAL,
        memory_cap: int = 512 * 1024 * 1024,
        image_cap: int = 4 * 1024 * 1024,
    ):
        self.db = triedb
        self.commit_interval = commit_interval
        self.memory_cap = memory_cap
        self.image_cap = image_cap
        # targetCommitSize / flushStepSize (state_manager.go:79-84): the
        # window walks targetMemory down stepwise so the boundary commit
        # only has ~target_commit_size left to write
        self.target_commit_size = 20 * 1024 * 1024
        self.flush_step_size = max(
            (memory_cap - self.target_commit_size) // FLUSH_WINDOW, 1
        )
        self.tip_buffer = _BoundedBuffer(TIP_BUFFER_SIZE, self._dereference)
        self._last_accepted_root = EMPTY_ROOT

    def _dereference(self, root: bytes) -> None:
        self.db.dereference(root)

    def insert_trie(self, block) -> None:
        self.db.reference(block.root)
        if self.db.dirty_size + 0 > self.memory_cap:
            self.db.cap(self.memory_cap - self.image_cap)

    def accept_trie(self, block) -> None:
        root = block.root
        if root != EMPTY_ROOT:
            self.tip_buffer.insert(root)
        height = block.number
        if self.commit_interval and height % self.commit_interval == 0:
            self.db.commit(root)
            self._last_accepted_root = root
            return
        # optimistic flush window: spread the big interval commit's IO over
        # the preceding FLUSH_WINDOW blocks — targetMemory decreases
        # stepwise toward target_commit_size at the boundary
        # (state_manager.go:160-186)
        distance = self.commit_interval - (height % self.commit_interval)
        if distance > FLUSH_WINDOW:
            return
        target_memory = self.target_commit_size + self.flush_step_size * distance
        if self.db.dirty_size <= target_memory:
            return
        self.db.cap(max(target_memory - self.image_cap, 0))

    def reject_trie(self, block) -> None:
        self.db.dereference(block.root)

    def shutdown(self) -> None:
        """Commit the last accepted root so restart can recover from <=
        commit_interval blocks back (state_manager.go Shutdown)."""
        last = self.tip_buffer.last()
        if last is not None:
            self.db.commit(last)


class ResidentTrieWriter(TrieWriter):
    """Trie policy for resident mode:
    the account trie's lifecycle rides the ResidentAccountMirror instead
    of the dirty forest, while storage-trie nodes (still committed into
    the TrieDatabase by StateDB.commit) flush on the same interval.

    accept  -> mirror.accept (journal reclaim on linear finality) and, at
               the commit interval, the delta export of changed account
               nodes to disk (the hashdb-image flush the reference does in
               state_manager.go:126-186 via triedb Commit) plus a full cap
               of the storage-node forest.
    reject  -> mirror.reject (rewind through the losing branch).
    shutdown-> final export at the last accepted block so restart recovers
               from <= commit_interval blocks back.
    """

    def __init__(self, triedb: TrieDatabase, mirror,
                 commit_interval: int = COMMIT_INTERVAL,
                 memory_cap: int = 256 * 1024 * 1024):
        self.db = triedb
        self.mirror = mirror
        self.commit_interval = commit_interval
        self.memory_cap = memory_cap
        self._last_accepted = None
        self._capped = None  # detached-mode delegate, created on demand
        # block ids whose roots the capped delegate referenced on insert
        # and has not yet balanced with an accept/reject — the ONLY
        # reliable detached-block marker (mirror.reject is silent for
        # blocks it never saw, so MirrorError can't key the delegation)
        self._capped_inflight: set = set()

    # After a disk fallback the mirror never re-registers roots, so every
    # later block runs the default forest path. Delegating its lifecycle
    # to a CappedMemoryTrieWriter keeps the <= commit_interval recovery
    # guarantee alive while detached: interval db.commit + tip buffer +
    # shutdown commit, exactly the pruning policy the chain would have
    # booted with if resident mode were off.
    @property
    def _detached(self) -> bool:
        return getattr(self.mirror, "detached", False)

    def _capped_writer(self) -> "CappedMemoryTrieWriter":
        if self._capped is None:
            self._capped = CappedMemoryTrieWriter(
                self.db, commit_interval=self.commit_interval,
                memory_cap=self.memory_cap)
        return self._capped

    def insert_trie(self, block) -> None:
        if self._detached:
            self._capped_writer().insert_trie(block)
            self._capped_inflight.add(block.hash())
            return
        # account nodes never enter the forest; storage nodes ride the
        # memory cap below. Nothing to pin: the mirror's applied stack is
        # the reference's "root reference" for in-flight blocks.
        if self.db.dirty_size > self.memory_cap:
            self.db.cap(self.memory_cap * 3 // 4)

    def accept_trie(self, block) -> None:
        from ..trie.resident_mirror import MirrorError

        try:
            self.mirror.accept(block.hash())
        except MirrorError as e:
            from ..log import get_logger
            from ..metrics import default_registry

            if block.hash() in self._capped_inflight:
                # post-fallback block: its account nodes live in the
                # forest, so the capped policy (interval commit + tip
                # buffer) carries durability from here. NOT a miss — the
                # delegate accepts it by design, so it gets its own
                # counter (an accept_misses alert must mean real misses)
                default_registry.counter(
                    "state/resident/detached_accepts").inc(1)
                self._capped_inflight.discard(block.hash())
                self._capped_writer().accept_trie(block)
                return
            # blocks the mirror never saw and no detach: boot-recovery
            # replays through the default path (benign)
            default_registry.counter("state/resident/accept_misses").inc(1)
            get_logger("state").warning(
                "resident accept miss for block %d (%s) — interval export "
                "skipped", block.number, e)
            return
        self._last_accepted = block
        if self.commit_interval and block.number % self.commit_interval == 0:
            self._export(block)

    def reject_trie(self, block) -> None:
        from ..trie.resident_mirror import MirrorError

        if block.hash() in self._capped_inflight:
            # post-detach block: referenced by the capped delegate's
            # insert_trie; balance it (blockchain.go:1361-1365
            # discipline). The mirror never saw it — do NOT touch the
            # mirror, whose reject() only raises for ACCEPTED blocks and
            # is silent for unknown ones, so an exception can't key this.
            self._capped_inflight.discard(block.hash())
            self._capped_writer().reject_trie(block)
            return
        try:
            self.mirror.reject(block.hash())
        except MirrorError:
            pass  # duplicate/out-of-order reject of an accepted block

    def _export(self, block) -> None:
        from ..trie.resident_mirror import MirrorError

        try:
            # pre_write flushes storage-trie nodes BEFORE the account
            # batch whose root node makes has_state() true — a crash
            # between the writes must leave a root that either fully
            # resolves or triggers reprocess_state, never a root with
            # missing storage subtrees (triedb._commit_walk's
            # children-first ordering); export_to owns the batch so a
            # failed write degrades the next export to a full image
            self.mirror.export_to(
                self.db.diskdb, at_block=block.hash(),
                pre_write=lambda: self.db.cap(0))
        except MirrorError:
            return  # block already beyond the rewind horizon; the next
            #         boundary export covers its nodes

    def shutdown(self) -> None:
        if self._last_accepted is not None:
            self._export(self._last_accepted)
        if self._capped is not None:
            # detached tail: commit the newest forest root so restart
            # recovers from <= commit_interval back of the true head,
            # not of the last mirror-accepted block
            self._capped.shutdown()


class _BoundedBuffer:
    """FIFO of size N; evicted items get the callback (state_manager.go:189+)."""

    def __init__(self, size: int, on_evict):
        self._size = size
        self._on_evict = on_evict
        self._items: list = []

    def insert(self, item) -> None:
        self._items.append(item)
        if len(self._items) > self._size:
            self._on_evict(self._items.pop(0))

    def last(self):
        return self._items[-1] if self._items else None
