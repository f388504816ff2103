"""In-memory dirty-node forest with ref-counting GC; counterpart of
coreth_tpu/trie/triedb.py.

Semantics of coreth trie/triedb/hashdb/database.go (dirties map,
reference/dereference, Cap, Commit) plus the trie/database_wrap.go:82-277
wrapper: Update merges a commit's NodeSets, UpdateAndReferenceRoot pins the
accepted chain's roots, Cap flushes oldest-first when over the memory limit,
Commit(root) persists a root's whole subtree to disk.

Nodes are stored on disk keyed by their hash (legacy hashdb scheme the
reference uses). Unlike coreth_tpu's, commit(root) also persists the
storage tries that root's account leaves hold, as the reference hashdb
does (ROADMAP Queue 3). The database also owns the batch keccak (a marker from
ops/device.get_batch_keccak, or None for the recursive CPU Hasher) that
every trie it opens hashes with, so the marker's device is where the
state's commits hash.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ..ethdb import KeyValueStore
from .node import EMPTY_ROOT
from .secure import StateTrie
from .trie import Trie
from .trienode import MergedNodeSet, NodeSet
from .. import rlp


class _CachedNode:
    __slots__ = ("blob", "parents", "external", "storage")

    def __init__(self, blob: bytes):
        self.blob = blob
        self.parents = 0
        self.external = 0  # root pins from the chain (versiondb analog)
        # dirty storage-trie roots this account leaf holds (hashdb's
        # external children): commit persists them before the leaf
        self.storage: tuple = ()


def _child_hashes(blob: bytes):
    """Walk a node blob for 32-byte child references (incl. embedded),
    on its RLP items: a full node's 16 children, an extension's child (a
    short node whose compact key has no terminator flag); a leaf's value
    holds none."""
    out = []

    def walk(items):
        if len(items) == 17:
            for c in items[:16]:
                ref(c)
        elif not (items[0] and items[0][0] & 0x20):
            ref(items[1])

    def ref(c):
        if isinstance(c, list):
            walk(c)
        elif len(c) == 32:
            out.append(c)

    walk(rlp.decode(blob))
    return out


class TrieDatabase:
    def __init__(
        self,
        diskdb: KeyValueStore,
        batch_keccak: Optional[Callable] = None,
        dirty_limit_bytes: int = 512 * 1024 * 1024,
    ):
        self.diskdb = diskdb
        self.batch_keccak = batch_keccak
        self.dirty_limit = dirty_limit_bytes
        self._dirties: Dict[bytes, _CachedNode] = {}  # insertion-ordered
        self._dirty_size = 0
        self._cleans: Dict[bytes, bytes] = {}  # simple clean cache
        self._clean_limit = 64 * 1024 * 1024
        self._clean_size = 0

    # ----------------------------------------------------------- node reads

    def node(self, path: bytes, node_hash: bytes) -> Optional[bytes]:
        c = self._dirties.get(node_hash)
        if c is not None:
            return c.blob
        blob = self._cleans.get(node_hash)
        if blob is not None:
            return blob
        blob = self.diskdb.get(node_hash)
        if blob is not None and self._clean_size < self._clean_limit:
            self._cleans[node_hash] = blob
            self._clean_size += len(blob)
        return blob

    def open_trie(self, root: bytes = EMPTY_ROOT) -> Trie:
        return Trie(root, self, self.batch_keccak)

    def open_state_trie(self, root: bytes = EMPTY_ROOT, **kw) -> StateTrie:
        return StateTrie(root, self, self.batch_keccak, **kw)

    # --------------------------------------------------------------- update

    def _insert(self, node_hash: bytes, blob: bytes) -> None:
        if node_hash in self._dirties:
            return
        entry = _CachedNode(blob)
        self._dirties[node_hash] = entry
        self._dirty_size += len(blob) + 32
        for child in _child_hashes(blob):
            c = self._dirties.get(child)
            if c is not None:
                c.parents += 1

    def update(self, root: bytes, parent: bytes, nodes: MergedNodeSet) -> None:
        """Merge one block's commit into the forest (database_wrap Update)."""
        # insert storage tries first, then the account trie, so children
        # exist when parent references are counted
        account_set = nodes.sets.get(b"")
        for owner, ns in nodes.sets.items():
            if owner != b"":
                self._insert_set(ns)
        if account_set is not None:
            self._insert_set(account_set)
            # reference storage roots held by committed account leaves
            for parent_hash, account_blob in account_set.leaves:
                try:
                    fields = rlp.decode(account_blob)
                    storage_root = fields[2] if isinstance(fields, list) and len(fields) >= 3 else None
                except rlp.DecodeError:
                    storage_root = None
                if storage_root and storage_root != EMPTY_ROOT:
                    storage_root = bytes(storage_root)
                    c = self._dirties.get(storage_root)
                    if c is not None:
                        c.parents += 1
                        leaf = self._dirties.get(parent_hash)
                        if leaf is not None and storage_root not in leaf.storage:
                            leaf.storage += (storage_root,)

    def _insert_set(self, ns: NodeSet) -> None:
        # children-first: longer paths are deeper
        for path in sorted(ns.nodes, key=len, reverse=True):
            node = ns.nodes[path]
            if not node.is_deleted:
                self._insert(node.hash, node.blob)

    def update_and_reference_root(self, root: bytes, parent: bytes, nodes: MergedNodeSet) -> None:
        """Coreth's accepted-chain pinning (database_wrap.go:141)."""
        self.update(root, parent, nodes)
        self.reference(root)

    # ----------------------------------------------------- refcounting / GC

    def reference(self, root: bytes) -> None:
        c = self._dirties.get(root)
        if c is not None:
            c.external += 1

    def dereference(self, root: bytes) -> None:
        """Drop an external pin; GC any now-unreachable subtree."""
        c = self._dirties.get(root)
        if c is None:
            return
        if c.external > 0:
            c.external -= 1
        self._maybe_gc(root)

    def _maybe_gc(self, node_hash: bytes) -> None:
        c = self._dirties.get(node_hash)
        if c is None or c.parents > 0 or c.external > 0:
            return
        del self._dirties[node_hash]
        self._dirty_size -= len(c.blob) + 32
        for child in _child_hashes(c.blob):
            cc = self._dirties.get(child)
            if cc is not None and cc.parents > 0:
                cc.parents -= 1
                self._maybe_gc(child)

    # ------------------------------------------------------- commit / flush

    def commit(self, root: bytes) -> None:
        """Persist root's subtree to disk, children first, the storage tries
        its account leaves hold before each leaf; drop from dirties."""
        if root == EMPTY_ROOT or root not in self._dirties:
            return
        batch = self.diskdb.new_batch()
        self._commit_walk(root, batch, set())
        batch.write()

    def _commit_walk(self, node_hash: bytes, batch, seen: set) -> None:
        if node_hash in seen:
            return
        seen.add(node_hash)
        c = self._dirties.get(node_hash)
        if c is None:
            return
        for child in c.storage + tuple(_child_hashes(c.blob)):
            self._commit_walk(child, batch, seen)
        batch.put(node_hash, c.blob)
        # committed nodes leave the dirty set (refs from remaining dirty
        # parents no longer matter: reads fall through to disk)
        del self._dirties[node_hash]
        self._dirty_size -= len(c.blob) + 32
        if self._clean_size < self._clean_limit:
            self._cleans[node_hash] = c.blob
            self._clean_size += len(c.blob)

    def save_clean_cache(self, path: str) -> int:
        """Journal the clean cache to disk (trie/database_wrap.go:195-236
        saveCache): a warm restart skips re-reading hot nodes from the KV
        store. Atomic (tmp+rename); returns entries written."""
        import os
        import tempfile

        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
        n = 0
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(b"CTCJ\x01")  # magic + version
                for h, blob in self._cleans.items():
                    f.write(h)
                    f.write(len(blob).to_bytes(4, "big"))
                    f.write(blob)
                    n += 1
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return n

    def load_clean_cache(self, path: str) -> int:
        """Restore a journaled clean cache; entries are verified by hash
        (a corrupt/stale journal can never poison reads). Returns entries
        loaded; 0 for missing/invalid journals."""
        import os

        from ..native import keccak256

        if not os.path.exists(path):
            return 0
        with open(path, "rb") as f:
            blob = f.read()
        if blob[:5] != b"CTCJ\x01":
            return 0
        n = 0
        pos = 5
        while pos + 36 <= len(blob):
            h = blob[pos:pos + 32]
            ln = int.from_bytes(blob[pos + 32:pos + 36], "big")
            pos += 36
            if pos + ln > len(blob):
                break  # torn tail
            node = blob[pos:pos + ln]
            pos += ln
            if keccak256(node) != h:
                continue  # verify-or-skip, never trust the file
            if h in self._cleans:
                continue  # already resident: size must not double-count
            if self._clean_size + ln > self._clean_limit:
                break
            self._cleans[h] = node
            self._clean_size += ln
            n += 1
        return n

    def cap(self, limit_bytes: int) -> None:
        """Flush oldest nodes to disk until memory usage <= limit."""
        if self._dirty_size <= limit_bytes:
            return
        batch = self.diskdb.new_batch()
        for node_hash in list(self._dirties):
            if self._dirty_size <= limit_bytes:
                break
            c = self._dirties.pop(node_hash)
            self._dirty_size -= len(c.blob) + 32
            batch.put(node_hash, c.blob)
            # Deliberately do NOT decrement refcounts of still-dirty
            # children: a re-inserted child can sit later in FIFO than a
            # flushed parent, and dropping its pin would let a future GC
            # delete it before it is ever written — leaving the on-disk
            # parent pointing at a missing node. Retaining the count leaks
            # (node stays dirty until a later cap/commit writes it) but can
            # never lose data — the same trade the reference hashdb makes.
        batch.write()

    @property
    def dirty_size(self) -> int:
        return self._dirty_size

    def __contains__(self, node_hash: bytes) -> bool:
        return node_hash in self._dirties
