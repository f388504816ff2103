"""Account-trie facade over the device-resident mirror.

In resident mode the account trie does not live as Python node objects
at all: values sit in the native IncrementalTrie, digests in the
executor's device store, and per-block hashing is one resident commit
(trie/resident_mirror.py, kernel K1 on CUDA). This facade is what a
StateDB sees as `self.trie`: the same get/update/delete/hash surface as
trie/secure.py StateTrie, with hash() previewing through the mirror and
the commit landing as a named block via commit_block().

The reference analog is the (SecureTrie over hashdb) account trie of
statedb.go — reads trie/trie.go:87, hash/commit trie/trie.go:573-626 —
with the hashing leg moved onto the device. Counterpart of
coreth_tpu/state/resident_trie.py; keys hash with the port's native
keccak256.

Storage tries are NOT resident: they stay on the Python/planned path
(per-account dirty sets are small; the account trie dominates the
block-commit node count).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..native import keccak256
from ..trie.resident_mirror import MirrorError, ResidentAccountMirror


class MirrorStateTrie:
    """StateTrie-shaped view of one state root served by the mirror.

    Mutations buffer locally (keyed by hashed address, exactly the
    update batch the mirror replays on branch switches); hash() previews
    the batch anonymously, commit_block() names it. If the mirror has
    meanwhile dropped this root (flushed history), reads fall back to a
    disk-backed Trie at the same root. So do hash() and commit_block() on
    a mirror in host mode, counted in state/resident/fallbacks; on a
    device mirror their MirrorError reaches the caller, because the disk
    Trie would hash the block on the host. The fallback only has data
    for roots whose nodes reached disk (exported interval boundaries and
    older): a root finalized mid-interval and already dropped by the
    mirror surfaces MissingNodeError — the same answer a pruning
    reference node gives for state it no longer holds
    (trie/trie.go:87 via a pruned hashdb). Lower commit_interval to
    shrink that window.
    """

    resident = True

    def __init__(self, mirror: ResidentAccountMirror, root: bytes,
                 triedb) -> None:
        self.mirror = mirror
        self.root = root
        self.triedb = triedb
        # insertion-ordered; materialised sorted so identical state
        # transitions always produce the identical mirror batch
        self._buffer: Dict[bytes, bytes] = {}
        self._preview_root: Optional[bytes] = None
        self._fallback = None
        # the header root the chain expects this block's state to have
        # (the chain sets it before validate): with pipelining on,
        # the mirror dispatches against it and defers the device-root
        # compare to the next drain point. None = serial (miners,
        # generation, tests — anywhere the true root is the answer).
        self.expected_root: Optional[bytes] = None

    # ---- secure-trie key handling ---------------------------------------

    @staticmethod
    def hash_key(key: bytes) -> bytes:
        return keccak256(key)

    # ---- reads -----------------------------------------------------------

    def get(self, key: bytes) -> Optional[bytes]:
        hk = self.hash_key(key)
        if hk in self._buffer:
            v = self._buffer[hk]
            return v if v else None
        try:
            return self.mirror.read(self.root, hk)
        except MirrorError:
            return self._disk().get(hk)

    # ---- writes (buffered) ----------------------------------------------

    def update(self, key: bytes, value: bytes) -> None:
        if not value:
            self.delete(key)
            return
        self._buffer[self.hash_key(key)] = value
        self._preview_root = None

    def delete(self, key: bytes) -> None:
        self._buffer[self.hash_key(key)] = b""
        self._preview_root = None

    # ---- hashing / committing -------------------------------------------

    def _batch(self):
        return sorted(self._buffer.items())

    def hash(self) -> bytes:
        if self._preview_root is not None:
            return self._preview_root
        batch = self._batch()
        try:
            parent = self.mirror.key_for_root(self.root)
            if parent is None:
                raise MirrorError("root not resident")
            root = self.mirror.preview(parent, batch,
                                       expected_root=self.expected_root)
        except MirrorError as e:
            if not self.mirror.host_mode:
                raise
            self._count_fallback(e, "")
            root = self._disk_apply().hash()
        self._preview_root = root
        return root

    def commit_block(self, block_hash: Optional[bytes],
                     parent_block_hash: Optional[bytes]):
        """Land the buffered batch as a block state. Returns
        (root, nodeset-or-None); the nodeset is only non-None on the
        disk fallback path, where the caller must merge it into the
        TrieDatabase exactly as the default path does."""
        batch = self._batch()
        parent = None
        if parent_block_hash is not None and (
            self.mirror.root_of(parent_block_hash) == self.root
        ):
            parent = parent_block_hash
        if parent is None:
            parent = self.mirror.key_for_root(self.root)
        try:
            if parent is None:
                raise MirrorError("root not resident")
            if block_hash is None:
                return self.mirror.preview(
                    parent, batch,
                    expected_root=self.expected_root), None
            return self.mirror.verify(
                parent, block_hash, batch,
                expected_root=self.expected_root), None
        except MirrorError as e:
            if not self.mirror.host_mode:
                raise
            # a fallen-back block's root never registers in the mirror, so
            # every descendant falls back too: resident mode is effectively
            # DETACHED from here until restart rebuilds the mirror. Loud on
            # purpose — silent detach would look like a perf regression.
            self._count_fallback(e, " — resident mode detaches until "
                                    "restart")
            # the flag ResidentTrieWriter keys its detached-mode interval
            # commits on (state_manager.py): without it, accept-side
            # interval exports silently stop while blocks keep landing in
            # the forest, and the <= commit_interval recovery guarantee
            # dies with them
            self.mirror.detached = True
            t = self._disk_apply()
            root, nodeset = t.commit(collect_leaf=True)
            return root, nodeset

    # ---- disk fallback ---------------------------------------------------

    @staticmethod
    def _count_fallback(e: MirrorError, then: str) -> None:
        from ..log import get_logger
        from ..metrics import default_registry

        default_registry.counter("state/resident/fallbacks").inc(1)
        get_logger("state").warning(
            "resident account trie falling back to the disk path (%s)%s",
            e, then)

    def _disk(self):
        """Plain Trie at this root over the TrieDatabase (hashed keys)."""
        if self._fallback is None:
            self._fallback = self.triedb.open_trie(self.root)
        return self._fallback

    def _disk_apply(self):
        """Fresh disk trie with the buffered batch applied."""
        t = self.triedb.open_trie(self.root)
        for hk, v in self._batch():
            if v:
                t.update(hk, v)
            else:
                t.delete(hk)
        return t

    # ---- misc StateTrie surface -----------------------------------------

    def copy(self) -> "MirrorStateTrie":
        t = MirrorStateTrie(self.mirror, self.root, self.triedb)
        t._buffer = dict(self._buffer)
        t._preview_root = self._preview_root
        t.expected_root = self.expected_root
        return t

    def preimages(self) -> Dict[bytes, bytes]:
        return {}
