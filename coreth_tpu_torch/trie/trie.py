"""Merkle-Patricia-Trie (semantics of coreth trie/trie.go); counterpart of
coreth_tpu/trie/trie.py.

Insert/delete/get with lazy node resolution through a NodeReader, hashing
through the recursive CPU Hasher or, for large dirty sets, the planned
device commit (trie/planned.py, under a PlannedMode marker), the fused
commit (FusedHasher, under a FusedModeKeccak marker) or the level-batched
BatchedHasher (any other batch keccak), and commit into a
trienode.NodeSet.

Writes after commit are rejected the same way the reference forbids them
(trie/trie.go:87 'committed' flag).
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

from .encoding import key_to_hex, prefix_len
from .hasher import BATCH_THRESHOLD, BatchedHasher, FusedHasher, Hasher, \
    node_to_bytes
from .node import (
    EMPTY_ROOT,
    FullNode,
    HashNode,
    MissingNodeError,
    ShortNode,
    ValueNode,
    must_decode_node,
    new_flag,
)
from .trienode import Node, NodeSet


class NodeReader:
    """Resolves node blobs by (path, hash). Dict-backed default."""

    def __init__(self, store=None):
        self._store = store if store is not None else {}

    def node(self, path: bytes, node_hash: bytes) -> Optional[bytes]:
        return self._store.get(node_hash)


class Trie:
    def __init__(
        self,
        root: bytes = EMPTY_ROOT,
        reader: Optional[NodeReader] = None,
        batch_keccak=None,
    ):
        self._reader = reader or NodeReader()
        self._batch_keccak = batch_keccak
        self.root = None if root == EMPTY_ROOT or root == b"" else HashNode(root)
        self.unhashed = 0
        self.committed = False

    @property
    def batch_keccak(self):
        """The batch keccak (or planned marker) this trie hashes with."""
        return self._batch_keccak

    def copy(self) -> "Trie":
        t = Trie.__new__(Trie)
        t._reader = self._reader
        t._batch_keccak = self._batch_keccak
        t.root = _copy_node(self.root)
        t.unhashed = self.unhashed
        t.committed = self.committed
        return t

    # ------------------------------------------------------------------ get

    def get(self, key: bytes) -> Optional[bytes]:
        if self.committed:
            raise RuntimeError("trie is already committed")
        value, newroot, resolved = self._get(self.root, key_to_hex(key), 0)
        if resolved:
            self.root = newroot
        return value

    def _get(self, n, key: bytes, pos: int):
        if n is None:
            return None, None, False
        if isinstance(n, ValueNode):
            return bytes(n), n, False
        if isinstance(n, ShortNode):
            klen = len(n.key)
            if len(key) - pos < klen or n.key != key[pos:pos + klen]:
                return None, n, False
            value, newval, resolved = self._get(n.val, key, pos + klen)
            if resolved:
                n = n.copy()
                n.val = newval
            return value, n, resolved
        if isinstance(n, FullNode):
            value, newchild, resolved = self._get(n.children[key[pos]], key, pos + 1)
            if resolved:
                n = n.copy()
                n.children[key[pos]] = newchild
            return value, n, resolved
        if isinstance(n, HashNode):
            child = self._resolve(n, key[:pos])
            value, newnode, _ = self._get(child, key, pos)
            return value, newnode, True
        raise TypeError(f"invalid node {type(n)}")

    # --------------------------------------------------------------- update

    def update(self, key: bytes, value: bytes) -> None:
        if self.committed:
            raise RuntimeError("trie is already committed")
        self.unhashed += 1
        hexkey = key_to_hex(key)
        if value:
            _, self.root = self._insert(self.root, b"", hexkey, ValueNode(value))
        else:
            _, self.root = self._delete(self.root, b"", hexkey)

    def delete(self, key: bytes) -> None:
        self.update(key, b"")

    def _insert(self, n, prefix: bytes, key: bytes, value) -> Tuple[bool, object]:
        if len(key) == 0:
            if isinstance(n, ValueNode):
                return bytes(value) != bytes(n), value
            return True, value
        if n is None:
            return True, ShortNode(key, value, new_flag())
        if isinstance(n, ShortNode):
            matchlen = prefix_len(key, n.key)
            if matchlen == len(n.key):
                dirty, nn = self._insert(
                    n.val, prefix + key[:matchlen], key[matchlen:], value
                )
                if not dirty:
                    return False, n
                return True, ShortNode(n.key, nn, new_flag())
            # diverge: create a branch at the split point
            branch = FullNode(flags=new_flag())
            _, branch.children[n.key[matchlen]] = self._insert(
                None, prefix + n.key[:matchlen + 1], n.key[matchlen + 1:], n.val
            )
            _, branch.children[key[matchlen]] = self._insert(
                None, prefix + key[:matchlen + 1], key[matchlen + 1:], value
            )
            if matchlen == 0:
                return True, branch
            return True, ShortNode(key[:matchlen], branch, new_flag())
        if isinstance(n, FullNode):
            dirty, nn = self._insert(
                n.children[key[0]], prefix + key[:1], key[1:], value
            )
            if not dirty:
                return False, n
            n = n.copy()
            n.flags = new_flag()
            n.children[key[0]] = nn
            return True, n
        if isinstance(n, HashNode):
            rn = self._resolve(n, prefix)
            dirty, nn = self._insert(rn, prefix, key, value)
            if not dirty:
                return False, rn
            return True, nn
        raise TypeError(f"invalid node {type(n)}")

    # --------------------------------------------------------------- delete

    def _delete(self, n, prefix: bytes, key: bytes) -> Tuple[bool, object]:
        if n is None:
            return False, None
        if isinstance(n, ShortNode):
            matchlen = prefix_len(key, n.key)
            if matchlen < len(n.key):
                return False, n
            if matchlen == len(key):
                return True, None  # exact match: remove
            dirty, child = self._delete(
                n.val, prefix + key[:len(n.key)], key[len(n.key):]
            )
            if not dirty:
                return False, n
            if isinstance(child, ShortNode):
                # merge the two short nodes (deletion collapsed the child)
                return True, ShortNode(n.key + child.key, child.val, new_flag())
            return True, ShortNode(n.key, child, new_flag())
        if isinstance(n, FullNode):
            dirty, nn = self._delete(n.children[key[0]], prefix + key[:1], key[1:])
            if not dirty:
                return False, n
            n = n.copy()
            n.flags = new_flag()
            n.children[key[0]] = nn
            # if only one child remains, collapse into a short node
            pos = -1
            for i, cld in enumerate(n.children):
                if cld is not None:
                    if pos == -1:
                        pos = i
                    else:
                        pos = -2
                        break
            if pos >= 0:
                if pos != 16:
                    cnode = n.children[pos]
                    if isinstance(cnode, HashNode):
                        cnode = self._resolve(cnode, prefix + bytes([pos]))
                    if isinstance(cnode, ShortNode):
                        return True, ShortNode(
                            bytes([pos]) + cnode.key, cnode.val, new_flag()
                        )
                    return True, ShortNode(bytes([pos]), cnode, new_flag())
                return True, ShortNode(bytes([16]), n.children[16], new_flag())
            return True, n
        if isinstance(n, ValueNode):
            return True, None
        if isinstance(n, HashNode):
            rn = self._resolve(n, prefix)
            dirty, nn = self._delete(rn, prefix, key)
            if not dirty:
                return False, rn
            return True, nn
        raise TypeError(f"invalid node {type(n)}")

    # -------------------------------------------------------------- resolve

    def _resolve(self, n: HashNode, prefix: bytes):
        blob = self._reader.node(prefix, bytes(n))
        if not blob:
            raise MissingNodeError(bytes(n), prefix)
        return must_decode_node(bytes(n), blob)

    # ------------------------------------------------------- hash & commit

    def hash(self) -> bytes:
        """Root hash (coreth_tpu/trie/trie.py:225-258). With at least
        BATCH_THRESHOLD unhashed updates and a batch keccak: a PlannedMode
        marker (while the degradation ladder is healthy) hashes the dirty
        nodes in one planned device commit, and a graph with more segments
        than the executor's table (counted in
        trie.planned.planned_fallbacks) or a dispatch the ladder refused
        (DeviceDegradedError: a caller demoted it) goes to the
        BatchedHasher on the marker instead, which runs on the host batch
        keccak while demoted; a FusedModeKeccak marker (while healthy)
        hashes them in one fused commit (FusedHasher), going to the
        BatchedHasher on a refused dispatch the same way; any
        other batch keccak runs the BatchedHasher, one batch per level.
        Otherwise the recursive CPU Hasher."""
        if self.root is None:
            return EMPTY_ROOT
        if isinstance(self.root, HashNode):
            return bytes(self.root)
        bk = self._batch_keccak
        if bk is not None and self.unhashed >= BATCH_THRESHOLD:
            if getattr(bk, "planned", False):
                from ..ops.device import DeviceDegradedError
                from . import planned

                try:
                    h = planned.PlannedHasher(bk.commit).hash_root(self.root)
                except planned.TooManySegments:
                    planned.planned_fallbacks += 1
                    h = BatchedHasher(bk).hash_root(self.root)
                except DeviceDegradedError:
                    h = BatchedHasher(bk).hash_root(self.root)
            elif getattr(bk, "fused", False):
                # one fused commit for the whole dirty set, child digests
                # patched on the device between levels
                from ..ops.device import DeviceDegradedError

                try:
                    h = FusedHasher(bk.fused_commit).hash_root(self.root)
                except DeviceDegradedError:
                    h = BatchedHasher(bk).hash_root(self.root)
            else:
                h = BatchedHasher(bk).hash_root(self.root)
        else:
            h, _ = Hasher().hash(self.root, True)
        self.unhashed = 0
        return bytes(h)

    def commit(self, collect_leaf: bool = False) -> Tuple[bytes, Optional[NodeSet]]:
        """Hash and collect all dirty nodes into a NodeSet.

        Returns (root_hash, nodeset); nodeset is None when nothing changed.
        The trie stays usable for reads but rejects writes afterwards
        (matching trie/trie.go:585 semantics).
        """
        root_hash = self.hash()
        self.committed = True
        if self.root is None or isinstance(self.root, HashNode):
            return root_hash, None
        if self.root.flags.hash is not None and not self.root.flags.dirty:
            self.root = HashNode(root_hash)
            return root_hash, None
        nodeset = NodeSet()
        _Committer(nodeset, collect_leaf).commit(b"", self.root)
        self.root = HashNode(root_hash)
        return root_hash, nodeset


class _Committer:
    """Commit walk (semantics of coreth trie/committer.go:60-160):
    collapse the hashed dirty tree into (path -> blob) entries; nodes whose
    RLP stayed <32 bytes are embedded in their parent, not stored."""

    def __init__(self, nodeset: NodeSet, collect_leaf: bool):
        self._set = nodeset
        self._collect_leaf = collect_leaf

    def commit(self, path: bytes, n):
        h = n.flags.hash if isinstance(n, (ShortNode, FullNode)) else None
        if h is not None and not n.flags.dirty:
            return HashNode(h)
        if isinstance(n, ShortNode):
            collapsed = ShortNode(n.key, n.val, n.flags)
            if isinstance(n.val, (ShortNode, FullNode)):
                collapsed.val = self.commit(path + n.key, n.val)
            elif isinstance(n.val, HashNode):
                collapsed.val = n.val
            return self._store(path, collapsed, n)
        if isinstance(n, FullNode):
            children = [None] * 17
            for i in range(16):
                c = n.children[i]
                if c is None:
                    continue
                if isinstance(c, (ShortNode, FullNode)):
                    children[i] = self.commit(path + bytes([i]), c)
                else:
                    children[i] = c
            children[16] = n.children[16]
            collapsed = FullNode(children, n.flags)
            return self._store(path, collapsed, n)
        raise TypeError(f"cannot commit {type(n)}")

    def _store(self, path: bytes, collapsed, orig):
        h = orig.flags.hash
        if h is None:
            # small node embedded in its parent; not stored on its own
            return collapsed
        blob = node_to_bytes(collapsed)
        self._set.add_node(path, Node(h, blob))
        orig.flags.dirty = False
        if self._collect_leaf and isinstance(collapsed, ShortNode):
            if isinstance(collapsed.val, ValueNode):
                self._set.add_leaf(h, bytes(collapsed.val))
        return HashNode(h)


def _copy_node(n):
    if isinstance(n, (ShortNode, FullNode)):
        c = n.copy()
        if isinstance(c, ShortNode):
            c.val = _copy_node(c.val)
        else:
            c.children = [_copy_node(x) for x in c.children]
        return c
    return n


def trie_from_items(items: Iterable[Tuple[bytes, bytes]],
                    batch_keccak=None) -> Trie:
    """A fresh trie holding (key, value) items, inserted in order."""
    t = Trie(batch_keccak=batch_keccak)
    for k, v in items:
        t.update(k, v)
    return t
