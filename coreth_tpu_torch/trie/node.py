"""Merkle-Patricia-Trie node model (semantics of coreth trie/node.go).

Node kinds:
  FullNode  — 17-way branch: 16 nibble children + value slot.
  ShortNode — extension (val is a node) or leaf (val is ValueNode),
              key stored in HEX form.
  HashNode  — 32-byte reference to a node stored elsewhere.
  ValueNode — leaf payload bytes.
  None      — empty slot.
"""

from __future__ import annotations

from typing import List, Optional

from .. import rlp
from .encoding import compact_to_hex, has_term

EMPTY_ROOT = bytes.fromhex(
    "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421"
)


class NodeFlags:
    __slots__ = ("hash", "dirty")

    def __init__(self, hash: Optional[bytes] = None, dirty: bool = False):
        self.hash = hash
        self.dirty = dirty

    def copy(self) -> "NodeFlags":
        return NodeFlags(self.hash, self.dirty)


class FullNode:
    __slots__ = ("children", "flags")

    def __init__(self, children: Optional[List] = None, flags: Optional[NodeFlags] = None):
        self.children: List = children if children is not None else [None] * 17
        self.flags = flags or NodeFlags()

    def copy(self) -> "FullNode":
        return FullNode(list(self.children), self.flags.copy())

    def cached_hash(self):
        return self.flags.hash


class ShortNode:
    __slots__ = ("key", "val", "flags")

    def __init__(self, key: bytes, val, flags: Optional[NodeFlags] = None):
        self.key = key  # HEX form
        self.val = val
        self.flags = flags or NodeFlags()

    def copy(self) -> "ShortNode":
        return ShortNode(self.key, self.val, self.flags.copy())

    def cached_hash(self):
        return self.flags.hash


class HashNode(bytes):
    __slots__ = ()


class ValueNode(bytes):
    __slots__ = ()


def new_flag() -> NodeFlags:
    """Flags for a freshly modified (dirty, unhashed) node."""
    return NodeFlags(hash=None, dirty=True)


class MissingNodeError(Exception):
    def __init__(self, node_hash: bytes, path: bytes):
        super().__init__(f"missing trie node {node_hash.hex()} (path {path.hex()})")
        self.node_hash = node_hash
        self.path = path


class ProofError(ValueError):
    """Invalid merkle proof. Subclasses ValueError so pre-typed callers
    (everything caught `except ValueError` before proof errors were
    typed) keep working; new triage code catches the subclasses to tell
    an incomplete proof set from a corrupt one."""


class ProofMissingNodeError(ProofError):
    """The proof set never supplied a referenced node blob — the proof
    is INCOMPLETE (retry / refetch territory), not corrupt."""

    def __init__(self, node_hash: bytes, context: str = ""):
        self.node_hash = node_hash
        self.context = context
        suffix = f" ({context})" if context else ""
        super().__init__(f"proof node missing: {node_hash.hex()}{suffix}")


class ProofCorruptNodeError(ProofError):
    """A supplied proof blob fails its hash check or does not decode —
    the DATA is bad (peer misbehavior / bitrot), not merely absent."""

    def __init__(self, node_hash: bytes, context: str = ""):
        self.node_hash = node_hash
        self.context = context
        suffix = f" ({context})" if context else ""
        super().__init__(f"proof node corrupt: {node_hash.hex()}{suffix}")


def must_decode_node(node_hash: Optional[bytes], blob: bytes):
    """Decode an RLP-stored node; hash is cached into flags if given."""
    items = rlp.decode(blob)
    return _decode_from_items(node_hash, items)


def _decode_from_items(node_hash, items):
    if not isinstance(items, list):
        raise rlp.DecodeError("trie node must be an RLP list")
    if len(items) == 2:
        key = compact_to_hex(items[0])
        if has_term(key):
            return ShortNode(key, ValueNode(items[1]), NodeFlags(hash=node_hash))
        return ShortNode(key, _decode_ref(items[1]), NodeFlags(hash=node_hash))
    if len(items) == 17:
        n = FullNode(flags=NodeFlags(hash=node_hash))
        for i in range(16):
            n.children[i] = _decode_ref(items[i])
        if items[16] != b"" and not isinstance(items[16], list):
            n.children[16] = ValueNode(items[16])
        return n
    raise rlp.DecodeError(f"invalid number of list elements: {len(items)}")


def _decode_ref(item):
    if isinstance(item, list):
        # embedded node (total RLP < 32 bytes)
        return _decode_from_items(None, item)
    if item == b"":
        return None
    if len(item) == 32:
        return HashNode(item)
    raise rlp.DecodeError(f"invalid RLP reference, {len(item)} bytes")
