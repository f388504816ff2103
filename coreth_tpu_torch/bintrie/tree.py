"""Canonical sparse binary Merkle tree over a content-addressed store;
counterpart of coreth_tpu/bintrie/tree.py.

Shape (deterministic from the key set alone, so the root is a pure
function of content — the property every divergence check below leans
on):

  * keys are 32 bytes; key bits, MSB-first, are the path
  * a leaf sits at the SHALLOWEST depth where its key prefix is unique
  * an internal node exists at depth d for prefix p iff >= 2 keys share
    p; its children may be leaves, internals, or the EMPTY subtree

Hashing (domain separation by message width — an internal preimage is
exactly 64 bytes, a leaf preimage exactly 65, so the two can never
collide):

  * internal: keccak256(left_hash || right_hash)
  * leaf:     keccak256(0x00 || key || keccak256(value))
  * the empty subtree is the 32-zero-byte constant EMPTY (never hashed)

Persistence: commit() writes every freshly hashed node's preimage into
the NodeStore keyed by its hash. Old roots stay readable — the store is
append-only, so a BinaryTrie can open at ANY previously committed root
(witnesses for historical blocks, reorg-safe shadow commits).

The planned/lane-batched device commit lives in planned.py; this module
is the host reference it must match bit-exactly.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple, Union

from ..native import keccak256

EMPTY = b"\x00" * 32
LEAF_TAG = b"\x00"
KEY_BITS = 256


class BinTrieMissingNode(Exception):
    """A node referenced by hash is absent from the store (pruned store,
    or a witness set that does not cover the touched path)."""

    def __init__(self, node_hash: bytes, context: str = ""):
        self.node_hash = node_hash
        self.context = context
        suffix = f" ({context})" if context else ""
        super().__init__(f"bintrie node missing: {node_hash.hex()}{suffix}")


def bit(key: bytes, depth: int) -> int:
    """MSB-first bit of a 32-byte key at [depth] (0 = left)."""
    return (key[depth >> 3] >> (7 - (depth & 7))) & 1


def leaf_hash(key: bytes, vhash: bytes) -> bytes:
    return keccak256(LEAF_TAG + key + vhash)


def internal_hash(left: bytes, right: bytes) -> bytes:
    return keccak256(left + right)


class NodeStore:
    """Append-only preimage store: hash -> 64B (internal) | 65B (leaf)
    preimage, plus value_hash -> value for leaf payload reads. Purely
    in-memory: the bintrie backend runs only as the shadow, and its
    durability is ROADMAP work."""

    def __init__(self):
        self.nodes: Dict[bytes, bytes] = {}
        self.values: Dict[bytes, bytes] = {}

    def put_node(self, h: bytes, preimage: bytes) -> None:
        self.nodes[h] = preimage

    def get_node(self, h: bytes, context: str = "") -> bytes:
        pre = self.nodes.get(h)
        if pre is None:
            raise BinTrieMissingNode(h, context)
        return pre

    def put_value(self, value: bytes) -> bytes:
        vh = keccak256(value)
        self.values[vh] = value
        return vh

    def get_value(self, vhash: bytes) -> Optional[bytes]:
        return self.values.get(vhash)

    def __len__(self) -> int:
        return len(self.nodes)


class _Leaf:
    __slots__ = ("key", "vhash", "hash")

    def __init__(self, key: bytes, vhash: bytes, h: Optional[bytes] = None):
        self.key = key
        self.vhash = vhash
        self.hash = h


class _Internal:
    __slots__ = ("left", "right", "hash")

    def __init__(self, left, right, h: Optional[bytes] = None):
        # children: None (EMPTY) | bytes (hash ref into the store) |
        # _Leaf | _Internal
        self.left = left
        self.right = right
        self.hash = h


_Node = Union[None, bytes, _Leaf, _Internal]


class BinaryTrie:
    """One mutable overlay over a NodeStore, opened at a committed root.

    get/update/delete mutate an in-memory partial tree expanded lazily
    from the store; commit() hashes the dirty subtree (host keccak here,
    or the planned device path via planned.commit_planned), persists the
    new preimages, and returns the new root hash. Nodes loaded from the
    store are fresh objects per trie instance, so in-place mutation
    never corrupts another open trie.
    """

    def __init__(self, store: NodeStore, root: bytes = EMPTY):
        self.store = store
        self._root: _Node = None if root == EMPTY else root

    # ----------------------------------------------------------- loading

    def _load(self, h: bytes) -> Union[_Leaf, _Internal]:
        pre = self.store.get_node(h)
        if len(pre) == 65:
            return _Leaf(pre[1:33], pre[33:65], h)
        if len(pre) == 64:
            left: _Node = pre[:32] if pre[:32] != EMPTY else None
            right: _Node = pre[32:] if pre[32:] != EMPTY else None
            return _Internal(left, right, h)
        raise BinTrieMissingNode(h, f"corrupt preimage width {len(pre)}")

    def _resolve(self, n: _Node) -> _Node:
        return self._load(n) if isinstance(n, bytes) else n

    # ----------------------------------------------------------- reading

    def get(self, key: bytes) -> Optional[bytes]:
        """Value bytes for [key], or None when absent."""
        vh = self.get_value_hash(key)
        if vh is None:
            return None
        return self.store.get_value(vh)

    def get_value_hash(self, key: bytes) -> Optional[bytes]:
        n = self._root
        depth = 0
        while True:
            n = self._resolve(n)
            if n is None:
                return None
            if isinstance(n, _Leaf):
                return n.vhash if n.key == key else None
            n = n.left if bit(key, depth) == 0 else n.right
            depth += 1

    # ---------------------------------------------------------- writing

    def update(self, key: bytes, value: bytes) -> None:
        if len(key) != 32:
            raise ValueError(f"bintrie keys are 32 bytes (got {len(key)})")
        if not value:
            self.delete(key)
            return
        vh = self.store.put_value(value)
        self._root = self._insert(self._root, 0, key, vh)

    def _insert(self, n: _Node, depth: int, key: bytes, vh: bytes) -> _Node:
        if n is None:
            return _Leaf(key, vh)
        n = self._resolve(n)
        if isinstance(n, _Leaf):
            if n.key == key:
                return n if n.vhash == vh else _Leaf(key, vh)
            return self._split(n, _Leaf(key, vh), depth)
        if bit(key, depth) == 0:
            n.left = self._insert(n.left, depth + 1, key, vh)
        else:
            n.right = self._insert(n.right, depth + 1, key, vh)
        n.hash = None
        return n

    def _split(self, a: _Leaf, b: _Leaf, depth: int) -> _Internal:
        """Internal chain from [depth] down to the first bit where the
        two leaf keys diverge (they must — keys are distinct)."""
        if depth >= KEY_BITS:
            raise ValueError("duplicate key reached split depth 256")
        ba, bb = bit(a.key, depth), bit(b.key, depth)
        if ba != bb:
            return (_Internal(a, b) if ba == 0 else _Internal(b, a))
        child = self._split(a, b, depth + 1)
        return _Internal(child, None) if ba == 0 else _Internal(None, child)

    def delete(self, key: bytes) -> bool:
        new_root, removed = self._delete(self._root, 0, key)
        if removed:
            self._root = new_root
        return removed

    def _is_leaf(self, n: _Node) -> bool:
        if isinstance(n, bytes):
            return len(self.store.get_node(n)) == 65
        return isinstance(n, _Leaf)

    def _delete(self, n: _Node, depth: int, key: bytes) -> Tuple[_Node, bool]:
        if n is None:
            return None, False
        n = self._resolve(n)
        if isinstance(n, _Leaf):
            return (None, True) if n.key == key else (n, False)
        if bit(key, depth) == 0:
            child, removed = self._delete(n.left, depth + 1, key)
            n.left = child
        else:
            child, removed = self._delete(n.right, depth + 1, key)
            n.right = child
        if not removed:
            return n, False
        n.hash = None
        # canonical collapse: a lone leaf pulls up past empty siblings
        # to the shallowest depth where its prefix is unique
        if n.left is None and n.right is None:
            return None, True
        if n.left is None and self._is_leaf(n.right):
            return n.right, True
        if n.right is None and self._is_leaf(n.left):
            return n.left, True
        return n, True

    # --------------------------------------------------------- hashing

    def root(self) -> bytes:
        """Current root hash; hashes (and persists) any dirty subtree on
        the host. Alias of commit() — the tree has no deferred node set
        beyond the store write that hashing itself performs."""
        return self.commit()

    def commit(self) -> bytes:
        if self._root is None:
            return EMPTY
        if isinstance(self._root, bytes):
            return self._root
        return self._hash_host(self._root)

    def _hash_host(self, n: _Node) -> bytes:
        if n is None:
            return EMPTY
        if isinstance(n, bytes):
            return n
        if n.hash is not None:
            return n.hash
        if isinstance(n, _Leaf):
            pre = LEAF_TAG + n.key + n.vhash
        else:
            pre = (self._hash_host(n.left) + self._hash_host(n.right))
        h = keccak256(pre)
        n.hash = h
        self.store.put_node(h, pre)
        return h

    def dirty_levels(self) -> List[List[object]]:
        """Dirty (unhashed) nodes grouped by depth, for the planned
        commit: levels[d] holds this overlay's hash-less nodes at depth
        d. Children of a dirty internal are either dirty (deeper level)
        or carry a known hash — exactly the patch/direct-write split the
        planned executor wants."""
        levels: List[List[object]] = []
        stack: List[Tuple[_Node, int]] = [(self._root, 0)]
        while stack:
            n, d = stack.pop()
            if n is None or isinstance(n, bytes):
                continue
            if n.hash is not None:
                continue
            while len(levels) <= d:
                levels.append([])
            levels[d].append(n)
            if isinstance(n, _Internal):
                stack.append((n.left, d + 1))
                stack.append((n.right, d + 1))
        return levels

    # ------------------------------------------------------- iteration

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """(key, value_hash) pairs in key order, walked from the store/
        overlay. Used by the shadow's canonical-rebuild spot check."""
        yield from self._walk_items(self._root)

    def _walk_items(self, n: _Node) -> Iterator[Tuple[bytes, bytes]]:
        n = self._resolve(n)
        if n is None:
            return
        if isinstance(n, _Leaf):
            yield n.key, n.vhash
            return
        yield from self._walk_items(n.left)
        yield from self._walk_items(n.right)


def reference_root(items: Dict[bytes, bytes], hashed_values: bool = False) -> bytes:
    """Pure-Python reference fold: the root of the canonical tree over
    {key32 -> value} computed WITHOUT any tree machinery — the
    differential oracle for the incremental/planned paths.

    hashed_values=True means the dict already maps key -> value_hash
    (the shadow's rebuild check feeds leaf vhashes straight through)."""
    pairs = [
        (k, v if hashed_values else keccak256(v)) for k, v in items.items()
    ]
    pairs.sort()

    def fold(lo: int, hi: int, depth: int) -> bytes:
        if lo == hi:
            return EMPTY
        if lo + 1 == hi:
            k, vh = pairs[lo]
            return leaf_hash(k, vh)
        mid = lo
        while mid < hi and bit(pairs[mid][0], depth) == 0:
            mid += 1
        return internal_hash(fold(lo, mid, depth + 1),
                             fold(mid, hi, depth + 1))

    return fold(0, len(pairs), 0)
