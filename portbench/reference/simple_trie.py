"""A Merkle-Patricia trie root computed the textbook way: recursively, one
node at a time, over keys of any length, with nodes shorter than 32
bytes embedded in their parent. Slow and plain: it anchors the batched
reference (mpt.py) to the published trie vectors in the tests, and reads
single nodes when the benchmark walks a stored trie."""

from __future__ import annotations

from . import rlp
from .keccak import keccak256_bytes


def _nibbles(key: bytes) -> list:
    out = []
    for b in key:
        out += [b >> 4, b & 15]
    return out


def hex_prefix(nibs, leaf: bool) -> bytes:
    flag = (2 if leaf else 0) + (len(nibs) & 1)
    if len(nibs) & 1:
        nibs = [flag] + list(nibs)
    else:
        nibs = [flag, 0] + list(nibs)
    return bytes(nibs[i] << 4 | nibs[i + 1] for i in range(0, len(nibs), 2))


def decode_hex_prefix(b: bytes):
    """(nibbles, is_leaf) of a hex-prefix encoded path."""
    nibs = _nibbles(b)
    flag = nibs[0]
    return nibs[2 - (flag & 1):], flag >= 2


def _ref(node: bytes):
    """How a parent holds a child node: inline when shorter than 32
    bytes, else by digest."""
    if len(node) < 32:
        return rlp.decode(node)
    return keccak256_bytes(node)


def _encode(items, depth: int) -> bytes:
    """RLP of the node over [(nibbles, value)], all sharing their first
    `depth` nibbles."""
    if len(items) == 1:
        nibs, value = items[0]
        return rlp.encode([hex_prefix(nibs[depth:], True), value])
    # the common prefix beyond depth
    first = items[0][0]
    n = depth
    while all(len(k) > n and k[n] == first[n] for k, _ in items):
        n += 1
    if n > depth:
        child = _encode(items, n)
        return rlp.encode([hex_prefix(first[depth:n], False), _ref(child)])
    slots = [b""] * 16
    value = b""
    for v in range(16):
        sub = [(k, val) for k, val in items if len(k) > depth and k[depth] == v]
        if sub:
            slots[v] = _ref(_encode(sub, depth + 1))
    for k, val in items:
        if len(k) == depth:
            value = val
    return rlp.encode(slots + [value])


def root(items) -> bytes:
    """The root of the trie holding (key, value) items (no empty value)."""
    if not items:
        return keccak256_bytes(rlp.encode(b""))
    data = {}
    for k, v in items:
        data[bytes(k)] = bytes(v)
    nib_items = sorted((_nibbles(k), v) for k, v in data.items())
    return keccak256_bytes(_encode(nib_items, 0))
