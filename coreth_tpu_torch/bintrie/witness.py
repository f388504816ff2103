"""Compact stateless witnesses for binary-Merkle reads (COMMITMENT.md);
counterpart of coreth_tpu/bintrie/witness.py, byte for byte.

A witness proves one key's presence (with its value) or absence against
a bintrie root using only the sibling hashes along the key's path. The
encoding omits EMPTY siblings behind a bitmap — for random keccak keys
most of the path IS empty, so witnesses stay compact (~depth/2 hashes).

Wire format (all integers big-endian):

  version   1B   0x01
  key       32B
  depth     2B   number of path levels (siblings) below the root
  kind      1B   0 = leaf (inclusion), 1 = other-leaf (exclusion),
                 2 = empty (exclusion)
  terminal  kind 0: value_hash(32) || value_len(4) || value
            kind 1: other_key(32) || other_value_hash(32)
            kind 2: (nothing)
  bitmap    ceil(depth/8)B  bit i set => sibling at depth i is non-EMPTY
  siblings  32B each, only the non-EMPTY ones, root-to-leaf order

Verification folds the terminal hash up through the siblings along the
key's bits and compares against the root — any tampering (value, vhash,
sibling, depth, bitmap) moves the recomputed root. absorb_witness()
additionally reconstructs every internal preimage on the path into a
NodeStore, so a set of witnesses becomes a partial tree a BinaryTrie
can open, READ AND MUTATE — stateless block re-execution is
`BinaryTrie(witness_store, pre_root)` plus the block's writes.
"""

from __future__ import annotations

from typing import Optional, Tuple

from .tree import (
    EMPTY,
    LEAF_TAG,
    BinTrieMissingNode,
    NodeStore,
    bit,
    internal_hash,
    leaf_hash,
)

WITNESS_VERSION = 1

KIND_LEAF = 0
KIND_OTHER_LEAF = 1
KIND_EMPTY = 2


class WitnessError(ValueError):
    """Malformed or non-verifying witness."""


def prove(store: NodeStore, root: bytes, key: bytes) -> bytes:
    """Build a witness for [key] against [root] from the node store.
    Works for any root the store has preimages for (the store is
    append-only, so historical shadow roots stay provable)."""
    if len(key) != 32:
        raise WitnessError(f"bintrie keys are 32 bytes (got {len(key)})")
    siblings = []
    depth = 0
    kind = KIND_EMPTY
    terminal = b""
    cur: Optional[bytes] = None if root == EMPTY else root
    while True:
        if cur is None:
            kind = KIND_EMPTY
            break
        pre = store.get_node(cur, "prove")
        if len(pre) == 65:
            leaf_key, vhash = pre[1:33], pre[33:65]
            if leaf_key == key:
                value = store.get_value(vhash)
                if value is None:
                    raise BinTrieMissingNode(vhash, "leaf value")
                kind = KIND_LEAF
                terminal = vhash + len(value).to_bytes(4, "big") + value
            else:
                kind = KIND_OTHER_LEAF
                terminal = leaf_key + vhash
            break
        left, right = pre[:32], pre[32:]
        if bit(key, depth) == 0:
            nxt, sib = left, right
        else:
            nxt, sib = right, left
        siblings.append(sib)
        depth += 1
        cur = None if nxt == EMPTY else nxt

    bitmap = bytearray((depth + 7) >> 3)
    packed = []
    for i, sib in enumerate(siblings):
        if sib != EMPTY:
            bitmap[i >> 3] |= 1 << (7 - (i & 7))
            packed.append(sib)
    return (bytes([WITNESS_VERSION]) + key + depth.to_bytes(2, "big")
            + bytes([kind]) + terminal + bytes(bitmap) + b"".join(packed))


def _decode(witness: bytes):
    """-> (key, depth, kind, terminal_fields, siblings[list of 32B])."""
    try:
        if witness[0] != WITNESS_VERSION:
            raise WitnessError(f"unknown witness version {witness[0]}")
        key = witness[1:33]
        depth = int.from_bytes(witness[33:35], "big")
        kind = witness[35]
        off = 36
        if kind == KIND_LEAF:
            vhash = witness[off:off + 32]
            vlen = int.from_bytes(witness[off + 32:off + 36], "big")
            value = witness[off + 36:off + 36 + vlen]
            if len(value) != vlen:
                raise WitnessError("truncated witness value")
            terminal = (vhash, value)
            off += 36 + vlen
        elif kind == KIND_OTHER_LEAF:
            terminal = (witness[off:off + 32], witness[off + 32:off + 64])
            off += 64
        elif kind == KIND_EMPTY:
            terminal = ()
        else:
            raise WitnessError(f"unknown witness kind {kind}")
        nbytes = (depth + 7) >> 3
        bitmap = witness[off:off + nbytes]
        if len(bitmap) != nbytes:
            raise WitnessError("truncated witness bitmap")
        off += nbytes
        siblings = []
        for i in range(depth):
            if bitmap[i >> 3] & (1 << (7 - (i & 7))):
                sib = witness[off:off + 32]
                if len(sib) != 32:
                    raise WitnessError("truncated witness siblings")
                siblings.append(sib)
                off += 32
            else:
                siblings.append(EMPTY)
        if off != len(witness):
            raise WitnessError("trailing bytes after witness")
        return key, depth, kind, terminal, siblings
    except IndexError:
        raise WitnessError("truncated witness") from None


def _terminal_hash(key, depth, kind, terminal) -> bytes:
    if kind == KIND_LEAF:
        vhash, value = terminal
        from ..native import keccak256

        if keccak256(value) != vhash:
            raise WitnessError("witness value does not match value hash")
        return leaf_hash(key, vhash)
    if kind == KIND_OTHER_LEAF:
        other_key, other_vhash = terminal
        if other_key == key:
            raise WitnessError("exclusion witness carries the proven key")
        for i in range(depth):
            if bit(other_key, i) != bit(key, i):
                raise WitnessError(
                    "exclusion leaf is not on the proven key's path")
        return leaf_hash(other_key, other_vhash)
    return EMPTY


def verify_witness(root: bytes, key: bytes,
                   witness: bytes) -> Tuple[bool, Optional[bytes]]:
    """Verify [witness] for [key] against [root].

    Returns (present, value): (True, value_bytes) for a proven read,
    (False, None) for proven absence. Raises WitnessError when the
    witness is malformed, internally inconsistent, or folds to a
    different root (tampering)."""
    wkey, depth, kind, terminal, siblings = _decode(witness)
    if wkey != key:
        raise WitnessError("witness is for a different key")
    h = _terminal_hash(key, depth, kind, terminal)
    for i in range(depth - 1, -1, -1):
        sib = siblings[i]
        h = (internal_hash(h, sib) if bit(key, i) == 0
             else internal_hash(sib, h))
    if h != root:
        raise WitnessError("witness does not verify against the root")
    if kind == KIND_LEAF:
        return True, terminal[1]
    return False, None


def absorb_witness(store: NodeStore, root: bytes, witness: bytes) -> None:
    """Verify [witness] against [root] and write every node preimage on
    its path into [store]. After absorbing the witnesses for all keys a
    block touches, `BinaryTrie(store, root)` is a partial tree that can
    serve those reads AND apply the block's writes statelessly — paths
    the witnesses don't cover raise BinTrieMissingNode."""
    key, depth, kind, terminal, siblings = _decode(witness)
    # verify first: a non-folding witness must not pollute the store
    verify_witness(root, key, witness)
    h = _terminal_hash(key, depth, kind, terminal)
    if kind == KIND_LEAF:
        vhash, value = terminal
        store.put_node(h, LEAF_TAG + key + vhash)
        store.put_value(value)
    elif kind == KIND_OTHER_LEAF:
        other_key, other_vhash = terminal
        store.put_node(h, LEAF_TAG + other_key + other_vhash)
    for i in range(depth - 1, -1, -1):
        sib = siblings[i]
        pre = (h + sib) if bit(key, i) == 0 else (sib + h)
        h = internal_hash(pre[:32], pre[32:])
        store.put_node(h, pre)
