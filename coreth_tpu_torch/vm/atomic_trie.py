"""Atomic operations trie (semantics of coreth plugin/evm/
{atomic_trie,atomic_trie_iterator,atomic_syncer}.go); counterpart of
coreth_tpu/vm/atomic_trie.py.

Indexes every accepted block's atomic shared-memory requests in its own
merkle trie keyed (height, peer chain id), committing a root every
COMMIT_INTERVAL heights (atomic_trie.go:333). The committed roots anchor
state-sync summaries. Its TrieDatabase carries the VM's device seam
(ops/device.get_batch_keccak(device_hasher, device)), so a commit of at
least BATCH_THRESHOLD dirty nodes runs as one planned program on K1 under
the degradation ladder, as the state trie's does. The atomic syncer
(AtomicSyncer) rebuilds a state-synced trie from range-proofed leaves,
and the state-sync client replays it into shared memory.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

from .. import rlp
from ..trie.node import EMPTY_ROOT
from ..trie.triedb import TrieDatabase
from .shared_memory import Element, Requests

ATOMIC_TRIE_COMMIT_INTERVAL = 4096

# db keys (atomic_trie.go appliedSharedMemoryCursorKey etc.)
LAST_COMMITTED_KEY = b"atomicTrieLastCommitted"


def _height_key(height: int, chain_id: bytes) -> bytes:
    """Keys sort by height so iteration replays in order (atomic_trie.go)."""
    return height.to_bytes(8, "big") + chain_id


def _encode_requests(req: Requests) -> bytes:
    return rlp.encode([
        list(req.remove_requests),
        [[e.key, e.value, list(e.traits)] for e in req.put_requests],
    ])


def _decode_requests(blob: bytes) -> Requests:
    items = rlp.decode(blob)
    return Requests(
        remove_requests=[bytes(k) for k in items[0]],
        put_requests=[
            Element(bytes(e[0]), bytes(e[1]), [bytes(t) for t in e[2]])
            for e in items[1]
        ],
    )


class AtomicTrie:
    def __init__(self, diskdb, commit_interval: int = ATOMIC_TRIE_COMMIT_INTERVAL,
                 batch_keccak=None):
        self.diskdb = diskdb
        self.triedb = TrieDatabase(diskdb, batch_keccak=batch_keccak)
        self.commit_interval = commit_interval

        stored = diskdb.get(LAST_COMMITTED_KEY)
        if stored is not None:
            self.last_committed_root = stored[:32]
            self.last_committed_height = int.from_bytes(stored[32:40], "big")
        else:
            self.last_committed_root = EMPTY_ROOT
            self.last_committed_height = 0
        self._open_trie = self.triedb.open_trie(self.last_committed_root)

    # --- indexing ---------------------------------------------------------

    def update_trie(self, height: int, requests: Dict[bytes, Requests]) -> None:
        """Index one accepted block's atomic ops (atomic_trie.go Index)."""
        for chain_id, req in requests.items():
            self._open_trie.update(_height_key(height, chain_id), _encode_requests(req))

    def index(self, height: int, requests: Dict[bytes, Requests]) -> Optional[bytes]:
        """Index + commit at interval boundaries; returns the committed root
        when a commit happened."""
        self.update_trie(height, requests)
        if height % self.commit_interval == 0:
            return self.commit(height)
        return None

    def commit(self, height: int) -> bytes:
        root, nodes = self._open_trie.commit(collect_leaf=False)
        if nodes is not None:
            from ..trie.trienode import MergedNodeSet

            merged = MergedNodeSet()
            merged.merge(nodes)
            self.triedb.update(root, self.last_committed_root, merged)
        self.triedb.commit(root)
        self.diskdb.put(
            LAST_COMMITTED_KEY, root + height.to_bytes(8, "big")
        )
        self.last_committed_root = root
        self.last_committed_height = height
        self._open_trie = self.triedb.open_trie(root)
        return root

    # --- queries ----------------------------------------------------------

    def root_at(self) -> Tuple[bytes, int]:
        return self.last_committed_root, self.last_committed_height

    def iterate(self, root: Optional[bytes] = None) -> Iterator[Tuple[int, bytes, Requests]]:
        """Yield (height, chain_id, requests) in height order
        (atomic_trie_iterator.go)."""
        from ..trie.iterator import iterate_leaves

        trie = self.triedb.open_trie(root if root is not None else self.last_committed_root)
        for key, value in iterate_leaves(trie):
            height = int.from_bytes(key[:8], "big")
            chain_id = key[8:]
            yield height, chain_id, _decode_requests(value)

    def apply_to_shared_memory(self, shared_memory, last_height: int,
                               from_height: int = 0) -> int:
        """Replay indexed ops into shared memory (state-sync finish path,
        atomic_backend.go ApplyToSharedMemory). Returns ops applied."""
        applied = 0
        for height, chain_id, req in self.iterate():
            if height <= from_height or height > last_height:
                continue
            try:
                shared_memory.apply({chain_id: req})
                applied += 1
            except KeyError:
                # already-consumed UTXOs on replay are fine (idempotent)
                pass
        return applied


class AtomicSyncer:
    """atomic_syncer.go: fetch the atomic trie's leaves via the sync client,
    rebuilding it locally with interval commits. `batch_keccak` is the
    rebuilt trie's device seam, as AtomicTrie takes it (the VM passes its
    own); the rebuild itself hashes on the StackTrie, as the reference's
    does."""

    def __init__(self, client, diskdb, target_root: bytes, target_height: int,
                 commit_interval: int = ATOMIC_TRIE_COMMIT_INTERVAL,
                 batch_keccak=None):
        self.client = client
        self.trie = AtomicTrie(diskdb, commit_interval,
                               batch_keccak=batch_keccak)
        self.target_root = target_root
        self.target_height = target_height

    def sync(self) -> None:
        if self.target_root == EMPTY_ROOT:
            return
        from ..trie.stacktrie import StackTrie

        batch = self.trie.diskdb.new_batch()

        def write_node(path: bytes, node_hash: bytes, blob: bytes) -> None:
            batch.put(node_hash, blob)

        st = StackTrie(write_fn=write_node)
        start = b""
        while True:
            resp = self.client.get_leafs(self.target_root, start=start)
            for k, v in zip(resp.keys, resp.vals):
                st.update(k, v)
            if not resp.more or not resp.keys:
                break
            from ..sync.statesync import _next_key

            start = _next_key(resp.keys[-1])
        got = st.hash()
        if got != self.target_root:
            raise RuntimeError(
                f"atomic trie root mismatch: want {self.target_root.hex()[:12]} "
                f"got {got.hex()[:12]}"
            )
        batch.write()
        self.trie.diskdb.put(
            LAST_COMMITTED_KEY,
            self.target_root + self.target_height.to_bytes(8, "big"),
        )
        self.trie.last_committed_root = self.target_root
        self.trie.last_committed_height = self.target_height
        self.trie._open_trie = self.trie.triedb.open_trie(self.target_root)
