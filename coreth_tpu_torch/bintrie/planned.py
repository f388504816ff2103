"""Planned (lane-batched) bintrie commit on kernel K1; counterpart of
coreth_tpu/bintrie/planned.py.

The binary tree is the planned executor's best-case input: every dirty
node is exactly one keccak rate block (internal preimage 64 B, leaf 65 B,
both pad to one 136-byte block), every digest hole is word-aligned (child
offsets 0 and 32 are words 0 and 8, barrel shift always 0), and a depth
level is one uniform segment: no RLP sizing pass, no block-count
bucketing, no embed rule. Levels hash deepest first, so parent <- child
digest dependencies resolve on the device through the same patch tables
the MPT planner uses (ops/keccak_planned.PlannedCommit.run).

Trees deeper than MAX_SEGMENTS levels (long shared prefixes) chunk into
several executor runs; digests read back between chunks resolve
cross-chunk children on the host. Random keccak keys keep the depth near
2*log2(N), so one run is the norm.

Every run is a dispatch of the process DeviceLadder (ops/device), as the
MPT's planned commit is. Unlike the reference's commit_with_fallback,
nothing falls back quietly: an error of the device call (a device fault,
a BuildError, DeviceWedgedError at the watchdog's deadline) reaches the
caller with the tree's digests untouched. Only a dispatch refused by a
ladder a caller has demoted (BlockChain.take_over_host) hashes the same
overlay on the host with BinaryTrie.commit(), as every laddered seam does.

Bit-exactness: commit_planned(trie) returns the same root AND per-node
digests as BinaryTrie.commit()'s host keccak.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..metrics import default_registry, phase_timer
from .tree import EMPTY, LEAF_TAG, BinaryTrie, _Leaf

_RATE = 136
_WPB = _RATE >> 2  # 34 u32 words per rate block


def _pad_lanes(n: int) -> int:
    """The native planners' lane bucketing (a scratch lane, then a power
    of two from 16, then multiples of 8192), so bintrie levels share the
    executor's shapes with the MPT paths."""
    n = n + 1
    if n <= 8192:
        p = 16
        while p < n:
            p <<= 1
        return p
    return ((n + 8191) // 8192) * 8192


def _pad_patches(n: int) -> int:
    if n == 0:
        return 0
    p = 16
    while p < n:
        p <<= 1
    return p


def _pad_block(msg: bytes) -> bytes:
    """keccak-256 pad10*1 into exactly one rate block (len(msg) < 136)."""
    b = bytearray(_RATE)
    b[: len(msg)] = msg
    b[len(msg)] ^= 0x01
    b[_RATE - 1] ^= 0x80
    return bytes(b)


def _child_ref(child) -> Tuple[Optional[bytes], Optional[object]]:
    """(known_hash, dirty_node): exactly one is set. EMPTY for absent
    children, store refs and already-hashed nodes resolve on the host; a
    hash-less node becomes a device patch."""
    if child is None:
        return EMPTY, None
    if isinstance(child, bytes):
        return child, None
    if child.hash is not None:
        return child.hash, None
    return None, child


def commit_planned(trie: BinaryTrie, executor=None, device=None) -> bytes:
    """Hash the trie's dirty overlay on the planned executor (`executor`,
    else the default PlannedCommit of `device`: K1 on CUDA, the plain
    version for "cpu") under the process DeviceLadder, and persist the
    new preimages. Returns the new root hash (module docstring for errors
    and the demoted ladder)."""
    from ..ops.device import DeviceDegradedError, default_ladder
    from ..ops.keccak_fused import SegmentSpec
    from ..ops.keccak_planned import MAX_SEGMENTS, default_planned_commit

    if trie._root is None:
        return EMPTY
    if isinstance(trie._root, bytes):
        return trie._root
    levels = trie.dirty_levels()
    order = [lvl for lvl in reversed(levels) if lvl]  # deepest first
    if not order:
        return trie._root.hash
    lad = default_ladder()
    if not lad.healthy:
        return trie.commit()
    if executor is None:
        executor = default_planned_commit(device)

    gid_of = {}
    hashed: List[Tuple[object, int, int]] = []  # (node, chunk_i, gid)
    total_lanes = 0
    try:
        with phase_timer("bintrie/planned/plan"):
            chunks = [order[i:i + MAX_SEGMENTS]
                      for i in range(0, len(order), MAX_SEGMENTS)]
            for ci, chunk in enumerate(chunks):
                args = _plan_chunk(ci, chunk, gid_of, hashed, SegmentSpec)
                _root32, digests = lad.dispatch(
                    lambda: executor.run(*args, want_digests=True),
                    "bintrie planned commit")
                for node, c, gid in hashed:
                    if c == ci:
                        node.hash = digests[gid].astype("<u4").tobytes()
                total_lanes += len(digests)
    except BaseException as e:
        # the overlay stays hash-less: no digest of a failed run survives
        for node, _c, _g in hashed:
            node.hash = None
        if isinstance(e, DeviceDegradedError):
            return trie.commit()
        raise

    root = trie._root.hash
    with phase_timer("bintrie/planned/store"):
        for node, _c, _g in hashed:
            if isinstance(node, _Leaf):
                pre = LEAF_TAG + node.key + node.vhash
            else:
                lh, _ = _child_ref(node.left)
                rh, _ = _child_ref(node.right)
                pre = lh + rh
            trie.store.put_node(node.hash, pre)
    default_registry.counter("bintrie/planned/commits").inc()
    default_registry.counter("bintrie/planned/lanes").inc(total_lanes)
    return root


def _plan_chunk(ci, chunk, gid_of, hashed, SegmentSpec):
    """PlannedCommit.run's positional inputs for one run over <=
    MAX_SEGMENTS depth levels (deepest first). Children hashed in earlier
    chunks resolve on the host; same-chunk children travel as device
    patches."""
    specs = []
    flat = bytearray()
    dst_l: List[int] = []
    child_l: List[int] = []
    shift_l: List[int] = []
    gstart = 0
    word_off = 0
    last_gid = 0
    for lvl in chunk:
        lanes_padded = _pad_lanes(len(lvl))
        n_pat = 0
        seg_base = word_off
        body = bytearray(lanes_padded * _RATE)
        for i, node in enumerate(lvl):
            gid = gstart + i
            gid_of[id(node)] = gid
            hashed.append((node, ci, gid))
            last_gid = gid
            lane_byte = i * _RATE
            if isinstance(node, _Leaf):
                msg = LEAF_TAG + node.key + node.vhash
            else:
                parts = bytearray(64)
                for side, child in ((0, node.left), (32, node.right)):
                    known, dirty = _child_ref(child)
                    if known is not None:
                        parts[side:side + 32] = known
                    else:
                        # zeroed hole + word-aligned patch (shift 0):
                        # offsets 0/32 are words 0/8 of the lane
                        dst_l.append(seg_base + (lane_byte >> 2)
                                     + (side >> 2))
                        child_l.append(gid_of[id(dirty)])
                        shift_l.append(0)
                        n_pat += 1
                msg = bytes(parts)
            body[lane_byte:lane_byte + _RATE] = _pad_block(msg)
        flat += body
        npad = _pad_patches(n_pat)
        dst_l.extend([0] * (npad - n_pat))
        child_l.extend([-1] * (npad - n_pat))  # -1 -> zero sentinel row
        shift_l.extend([0] * (npad - n_pat))
        specs.append(SegmentSpec(blocks=1, lanes=lanes_padded,
                                 gstart=gstart, n_patches=npad))
        gstart += lanes_padded
        word_off += lanes_padded * _WPB
    flat_words = np.frombuffer(flat, dtype=np.uint8).view(np.uint32)
    return (tuple(specs), flat_words, np.asarray(dst_l, np.int32),
            np.asarray(child_l, np.int32), np.asarray(shift_l, np.int32),
            last_gid)
