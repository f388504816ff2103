"""Trie iteration in key order (coreth trie/iterator.go); counterpart of
coreth_tpu/trie/iterator.py.

`iterate_leaves` yields (key_bytes, value) pairs in ascending key order,
resolving nodes lazily; `iterate_nodes` yields every resolved node with its
path (used by sync handlers and dumps).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

from .encoding import hex_to_keybytes, key_to_hex
from .node import FullNode, HashNode, ShortNode, ValueNode
from .trie import Trie


def _strip_term(hexkey: bytes) -> bytes:
    return hexkey[:-1] if hexkey and hexkey[-1] == 16 else hexkey


def diff_leaves(trie_a: Trie, trie_b: Trie):
    """Yield (key_bytes, val_a, val_b) for every leaf whose value differs
    between the two tries, PRUNING shared subtrees by node hash — the
    role of the reference's trie.NewDifferenceIterator
    (trie/iterator.go): cost is O(changed subtrees), not O(total
    leaves). Either val may be None (key only on one side)."""

    def expand(trie, node, path):
        """-> (terminal value | None, {nibble: child}) one level down.
        ShortNodes are consumed one nibble at a time so both sides stay
        aligned on the SAME path regardless of structural shape."""
        if isinstance(node, HashNode):
            node = trie._resolve(node, path)
        if node is None:
            return None, {}
        if isinstance(node, ValueNode):
            return bytes(node), {}
        if isinstance(node, ShortNode):
            k = node.key
            if len(k) == 1 and k[0] == 16:  # terminator only: a value
                v = node.val
                return (bytes(v) if isinstance(v, ValueNode) else None), {}
            child = (ShortNode(k[1:], node.val) if len(k) > 1
                     else node.val)
            return None, {k[0]: child}
        if isinstance(node, FullNode):
            v = node.children[16]
            kids = {i: c for i, c in enumerate(node.children[:16])
                    if c is not None}
            return (bytes(v) if v is not None else None), kids
        raise TypeError(f"unexpected node {type(node)}")

    def walk(na, nb, path):
        if na is None and nb is None:
            return
        if (isinstance(na, HashNode) and isinstance(nb, HashNode)
                and bytes(na) == bytes(nb)):
            return  # identical subtree: the whole point of the pruning
        va, ca = expand(trie_a, na, path)
        vb, cb = expand(trie_b, nb, path)
        if va != vb:
            yield hex_to_keybytes(path), va, vb
        for nib in sorted(set(ca) | set(cb)):
            yield from walk(ca.get(nib), cb.get(nib), path + bytes([nib]))

    yield from walk(trie_a.root, trie_b.root, b"")


def iterate_leaves(
    trie: Trie, start: Optional[bytes] = None
) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (key_bytes, value) in key order, keys >= ``start``.

    Hex paths compare lexicographically in the same order as keys, so a
    subtree rooted at path P can be pruned iff P < start_hex[:len(P)]
    (i.e. every key below it sorts before start).
    """
    start_hex = _strip_term(key_to_hex(start)) if start else b""

    def before_start(path: bytes) -> bool:
        return path < start_hex[: len(path)]

    def walk(n, path: bytes):
        if isinstance(n, HashNode):
            n = trie._resolve(n, path)
        if n is None:
            return
        if isinstance(n, ValueNode):
            if path >= start_hex:
                yield hex_to_keybytes(path), bytes(n)
            return
        if isinstance(n, ShortNode):
            child_path = path + _strip_term(n.key)
            if isinstance(n.val, ValueNode):
                if child_path >= start_hex:
                    yield hex_to_keybytes(child_path), bytes(n.val)
            elif not before_start(child_path):
                yield from walk(n.val, child_path)
            return
        if isinstance(n, FullNode):
            if n.children[16] is not None and path >= start_hex:
                yield hex_to_keybytes(path), bytes(n.children[16])
            for i in range(16):
                c = n.children[i]
                if c is None:
                    continue
                child_path = path + bytes([i])
                if not before_start(child_path):
                    yield from walk(c, child_path)
            return
        raise TypeError(f"invalid node {type(n)}")

    yield from walk(trie.root, b"")


def iterate_nodes(trie: Trie) -> Iterator[Tuple[bytes, object]]:
    """Yield (path, node) for every resolved node, preorder."""

    def walk(n, path: bytes):
        if isinstance(n, HashNode):
            n = trie._resolve(n, path)
        if n is None:
            return
        yield path, n
        if isinstance(n, ShortNode):
            if not isinstance(n.val, ValueNode):
                yield from walk(n.val, path + n.key)
        elif isinstance(n, FullNode):
            for i in range(16):
                if n.children[i] is not None:
                    yield from walk(n.children[i], path + bytes([i]))

    yield from walk(trie.root, b"")
