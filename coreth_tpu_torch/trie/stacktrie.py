"""StackTrie — streaming trie for sorted-key insertion.

Semantics of coreth trie/stacktrie.go:69-94: keys must arrive in
strictly increasing order; subtrees left of the insertion path are complete
and get hashed (and handed to ``write_fn``) immediately, so memory stays
O(depth). Used for DeriveSha (tx/receipt roots), state sync leaf streaming,
and range-proof verification.

``write_fn(path, hash, blob)`` is the NodeWriteFunc seam
(trie/stacktrie.go:52) that lets sync persist nodes as they complete.

Counterpart of coreth_tpu/trie/stacktrie.py.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from .. import rlp
from ..native import keccak256
from .encoding import hex_to_compact
from .node import EMPTY_ROOT

_EMPTY, _LEAF, _EXT, _BRANCH, _HASHED = range(5)


def _key_nibbles(key: bytes) -> bytes:
    out = bytearray(len(key) * 2)
    for i, b in enumerate(key):
        out[2 * i] = b >> 4
        out[2 * i + 1] = b & 0x0F
    return bytes(out)


def _common(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class _Node:
    __slots__ = ("typ", "key", "val", "children")

    def __init__(self, typ: int, key: bytes = b"", val: bytes = b""):
        self.typ = typ
        self.key = key  # nibbles, no terminator
        self.val = val  # leaf value; after hashing: 32B hash or <32B raw rlp
        self.children: List[Optional["_Node"]] = [None] * 16


class StackTrie:
    def __init__(
        self,
        write_fn: Optional[Callable[[bytes, bytes, bytes], None]] = None,
        keccak: Callable[[bytes], bytes] = keccak256,
    ):
        self._root = _Node(_EMPTY)
        self._write = write_fn
        self._keccak = keccak
        self._last_key: Optional[bytes] = None

    def update(self, key: bytes, value: bytes) -> None:
        if not value:
            raise ValueError("stacktrie cannot store empty values")
        if self._last_key is not None and key <= self._last_key:
            raise ValueError("stacktrie keys must be strictly increasing")
        self._last_key = key
        self._insert(self._root, _key_nibbles(key), value, b"")

    def _insert(self, st: _Node, key: bytes, value: bytes, path: bytes) -> None:
        if st.typ == _EMPTY:
            st.typ = _LEAF
            st.key = key
            st.val = value
            return

        if st.typ == _BRANCH:
            idx = key[0]
            # children left of the insertion point are complete; only the
            # rightmost existing one can still be unhashed
            for i in range(idx - 1, -1, -1):
                if st.children[i] is not None:
                    if st.children[i].typ != _HASHED:
                        self._hash_node(st.children[i], path + bytes([i]))
                    break
            child = st.children[idx]
            if child is None:
                st.children[idx] = _Node(_LEAF, key[1:], value)
            else:
                self._insert(child, key[1:], value, path + key[:1])
            return

        if st.typ == _EXT:
            diff = _common(st.key, key)
            if diff == len(st.key):
                self._insert(st.children[0], key[diff:], value, path + key[:diff])
                return
            # split: the existing subtree below the divergence is complete
            if diff < len(st.key) - 1:
                n = _Node(_EXT, st.key[diff + 1:])
                n.children[0] = st.children[0]
            else:
                n = st.children[0]
            self._hash_node(n, path + st.key[: diff + 1])
            o = _Node(_LEAF, key[diff + 1:], value)
            old_nib, new_nib = st.key[diff], key[diff]
            if diff == 0:
                st.typ = _BRANCH
                st.key = b""
                st.children = [None] * 16
                branch = st
            else:
                branch = _Node(_BRANCH)
                st.key = st.key[:diff]
                st.children = [None] * 16
                st.children[0] = branch
            branch.children[old_nib] = n
            branch.children[new_nib] = o
            return

        if st.typ == _LEAF:
            diff = _common(st.key, key)
            if diff == len(st.key):
                raise ValueError("duplicate key in stacktrie")
            # freeze the old leaf below the split point
            n = _Node(_LEAF, st.key[diff + 1:], st.val)
            self._hash_node(n, path + st.key[: diff + 1])
            o = _Node(_LEAF, key[diff + 1:], value)
            old_nib, new_nib = st.key[diff], key[diff]
            if diff == 0:
                st.typ = _BRANCH
                st.key = b""
                st.val = b""
                st.children = [None] * 16
                branch = st
            else:
                branch = _Node(_BRANCH)
                st.typ = _EXT
                st.key = st.key[:diff]
                st.val = b""
                st.children = [None] * 16
                st.children[0] = branch
            branch.children[old_nib] = n
            branch.children[new_nib] = o
            return

        raise ValueError("insert into hashed subtree")

    def _hash_node(self, st: _Node, path: bytes) -> None:
        """Encode st (whose children are complete), hash if >=32B."""
        if st.typ == _HASHED:
            return
        if st.typ == _BRANCH:
            items = []
            for i in range(16):
                c = st.children[i]
                if c is None:
                    items.append(b"")
                    continue
                if c.typ != _HASHED:
                    self._hash_node(c, path + bytes([i]))
                items.append(c.val if len(c.val) == 32 else rlp.decode(c.val))
            items.append(b"")
            enc = rlp.encode(items)
        elif st.typ == _EXT:
            c = st.children[0]
            if c.typ != _HASHED:
                self._hash_node(c, path + st.key)
            ref = c.val if len(c.val) == 32 else rlp.decode(c.val)
            enc = rlp.encode([hex_to_compact(st.key), ref])
        elif st.typ == _LEAF:
            enc = rlp.encode([hex_to_compact(st.key + b"\x10"), st.val])
        else:
            raise ValueError("cannot hash empty node")
        st.typ = _HASHED
        st.children = [None] * 16
        st.key = b""
        if len(enc) < 32:
            st.val = enc  # embedded in the parent
        else:
            h = self._keccak(enc)
            st.val = h
            if self._write is not None:
                self._write(path, h, enc)

    def hash(self) -> bytes:
        """Finalize and return the root hash (root is always hashed)."""
        if self._root.typ == _EMPTY:
            return EMPTY_ROOT
        self._hash_node(self._root, b"")
        val = self._root.val
        if len(val) < 32:
            h = self._keccak(val)
            if self._write is not None:
                self._write(b"", h, val)
            self._root.val = h
            return h
        return val
