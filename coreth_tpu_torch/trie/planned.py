"""Planned-graph commit: dirty node graphs drained through the planned
executor (ops/keccak_planned.PlannedCommit). Counterpart of
coreth_tpu/trie/planned.py; the lane and patch bucketing (_pad_lanes,
_pad_patches) and the layout are identical, so both packages build the
same export from the same graph.

`PlannedGraphBuilder` converts in-memory dirty node graphs into the
executor's export format:

  * dirty nodes are collected per trie, grouped by height (leaves first),
    bucketed by keccak block count into uniform segments
  * each node's RLP is written once into the flat little-endian u32 word
    stream with zeroed 32-byte holes where a dirty child's digest goes;
    a patch (dst_word, child_lane, shift) resolves each hole on device
  * several tries compose into one program: every dirty storage trie's
    levels are merged height-wise, the account trie's levels follow, and
    each account leaf's storage-root field is itself a patch hole pointing
    at the storage trie's root lane (coreth core/state/statedb.go:1040-1160
    ordering: storage tries -> account RLP -> account trie).

Bit-exact with the CPU Hasher: node RLP < 32 bytes embeds in the parent,
and each trie's root is always hashed.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .encoding import hex_to_compact
from .hasher import (
    _bytes_enc_len,
    _keccak_pad,
    _list_hdr_len,
    _write_bytes,
    _write_list_hdr,
    collect_levels_with_paths,
)
from .node import FullNode, HashNode, ShortNode, ValueNode

_RATE = 136
_WPB = _RATE // 4  # u32 words per rate block


def _pad_lanes(n: int) -> int:
    """Lane-count bucket — IDENTICAL to the native planners' round_lanes
    (count+1 scratch lane, pow2 floor 16 up to 8192, then 8192 multiples),
    kept so both packages lay out the same plan from the same graph."""
    n = n + 1  # scratch lane, as the native layout reserves
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


class _TrieEntry:
    __slots__ = ("root", "levels", "holes", "root_lane")

    def __init__(self, root, holes):
        self.root = root
        self.levels: List[List[Tuple[object, bytes]]] = []
        self.holes = holes  # hex path -> (value_offset, src _TrieEntry)
        self.root_lane: Optional[int] = None


class PlannedGraphBuilder:
    """Collects dirty node graphs; builds one planned-executor program.

    Usage:
        b = PlannedGraphBuilder()
        h1 = b.add_trie(storage_root_node)          # any number of these
        b.add_account_trie(acct_root_node, holes={hexpath: (off, h1)})
        root_hash = b.run(device="cuda")             # device round-trip
    after run(): every hashed node's flags.hash is set, value holes are
    healed with the real child-root bytes, `b.digest(handle)` returns a
    trie's root digest, `b.plan` holds the export that ran, `b.digests`
    the per-lane digests uint32[G, 8], and `b.plan_ms` the host time the
    layout took.
    """

    def __init__(self):
        self._tries: List[_TrieEntry] = []
        self._account: Optional[_TrieEntry] = None
        self.plan = None
        self.digests: Optional[np.ndarray] = None
        self.plan_ms = 0.0

    # ------------------------------------------------------------ collection

    def add_trie(self, root) -> _TrieEntry:
        if not isinstance(root, (ShortNode, FullNode)):
            raise TypeError("planned builder needs a Short/Full dirty root")
        e = _TrieEntry(root, {})
        e.levels = collect_levels_with_paths(root)
        self._tries.append(e)
        return e

    def add_account_trie(self, root, holes: Dict[bytes, Tuple[int, _TrieEntry]]):
        if not isinstance(root, (ShortNode, FullNode)):
            raise TypeError("planned builder needs a Short/Full dirty root")
        e = _TrieEntry(root, holes or {})
        e.levels = collect_levels_with_paths(root)
        self._account = e
        return e

    # ----------------------------------------------------------------- build

    def build(self):
        """Lay out segments; returns (specs, flat_words, dst, child, shift,
        root_pos) in CommitPlan.export_words() format, or None when the
        graph needs more segments than the executor's segment table holds."""
        from ..ops.keccak_fused import SegmentSpec
        from ..ops.keccak_planned import MAX_SEGMENTS

        # merged height levels: storage tries first (their level h merged
        # across tries), account trie's levels strictly after
        merged: List[List[Tuple[_TrieEntry, object, bytes]]] = []
        for e in self._tries:
            for h, lvl in enumerate(e.levels):
                while len(merged) <= h:
                    merged.append([])
                merged[h].extend((e, n, p) for n, p in lvl)
        if self._account is not None:
            for lvl in self._account.levels:
                merged.append([(self._account, n, p) for n, p in lvl])

        # pass 1: per node, build (padded_msg, rel_patches) and assign
        # lanes segment by segment. info maps id(node) -> ("gid", lane) |
        # ("embed", bytes); children are always processed before parents.
        info: Dict[int, Tuple[str, object]] = {}
        segs: List[dict] = []   # {blocks, msgs:[bytes], patches:[(lane_rel=None..)]}
        self._hashed: List[Tuple[object, int]] = []  # (node, gid)
        self._healed: List[Tuple[object, int, _TrieEntry]] = []

        for level in merged:
            by_blocks: Dict[int, dict] = {}
            for e, n, path in level:
                msg, rel_patches, is_embed = self._encode_node(e, n, path, info)
                if is_embed:
                    info[id(n)] = ("embed", msg)
                    continue
                padded, blocks = _keccak_pad(msg)
                seg = by_blocks.get(blocks)
                if seg is None:
                    seg = by_blocks[blocks] = {"blocks": blocks, "msgs": [],
                                               "patches": [], "nodes": []}
                seg["msgs"].append(padded)
                seg["patches"].append(rel_patches)
                seg["nodes"].append(n)
                # parents encoded later this pass only need to know this
                # node hashes (child ref = 33 bytes); the real lane number
                # lands in pass 2
                info[id(n)] = ("gid", None)
            for blocks in sorted(by_blocks):
                segs.append(by_blocks[blocks])

        if len(segs) > MAX_SEGMENTS:
            return None

        # pass 2: assign gids (padded lane numbering), absolute word offsets
        word_off = 0
        gstart = 0
        for seg in segs:
            padded_lanes = _pad_lanes(len(seg["msgs"]))
            seg["gstart"] = gstart
            seg["word_off"] = word_off
            seg["lanes_padded"] = padded_lanes
            for i, n in enumerate(seg["nodes"]):
                info[id(n)] = ("gid", gstart + i)
                self._hashed.append((n, gstart + i))
            gstart += padded_lanes
            word_off += padded_lanes * seg["blocks"] * _WPB
        total_words = word_off
        total_lanes = gstart
        for e in self._tries + ([self._account] if self._account else []):
            kind, lane = info[id(e.root)]
            assert kind == "gid", "trie root must be hashed (forced)"
            e.root_lane = lane

        # pass 3: materialize flat words + patch tables
        flat = np.zeros(total_words * 4, dtype=np.uint8)
        specs = []
        dst_l: List[np.ndarray] = []
        child_l: List[np.ndarray] = []
        shift_l: List[np.ndarray] = []
        for seg in segs:
            blocks = seg["blocks"]
            msg_bytes = blocks * _RATE
            base = seg["word_off"] * 4
            joined = b"".join(seg["msgs"])
            flat[base:base + len(joined)] = np.frombuffer(joined, np.uint8)
            # resolve this segment's patches to absolute coordinates
            dsts: List[int] = []
            childs: List[int] = []
            shifts: List[int] = []
            for lane, rel in enumerate(seg["patches"]):
                lane_byte = base + lane * msg_bytes
                for byte_off, child_node, src_entry in rel:
                    if child_node is not None:
                        kind, payload = info[id(child_node)]
                        assert kind == "gid", "patched child must be hashed"
                        child_gid = payload
                    else:
                        child_gid = src_entry.root_lane
                    abs_byte = lane_byte + byte_off
                    dsts.append(abs_byte // 4)
                    childs.append(child_gid)
                    shifts.append(abs_byte % 4)
            npat = len(dsts)
            npad = _pad_patches(npat)
            dsts.extend([0] * (npad - npat))      # zero strip: harmless add
            childs.extend([-1] * (npad - npat))   # -1 -> zero sentinel row
            shifts.extend([0] * (npad - npat))
            dst_l.append(np.asarray(dsts, np.int32))
            child_l.append(np.asarray(childs, np.int32))
            shift_l.append(np.asarray(shifts, np.int32))
            specs.append(SegmentSpec(blocks=blocks, lanes=seg["lanes_padded"],
                                     gstart=seg["gstart"], n_patches=npad))

        cat = (lambda xs: np.concatenate(xs) if xs else np.zeros(0, np.int32))
        root_entry = self._account if self._account is not None else self._tries[-1]
        root_pos = root_entry.root_lane
        flat_words = flat.view(np.uint32)
        return (tuple(specs), flat_words, cat(dst_l), cat(child_l),
                cat(shift_l), root_pos, total_lanes)

    def _encode_node(self, entry: _TrieEntry, n, path: bytes, info):
        """Single-pass RLP writer with zeroed digest holes.

        Returns (msg_bytes, patches [(byte_off, child_node|None, src_entry)],
        is_embed). Child lengths come from `info` (children processed
        first), so no separate sizing traversal."""
        patches: List[Tuple[int, Optional[object], Optional[_TrieEntry]]] = []

        def child_len(c) -> int:
            if c is None:
                return 1
            if isinstance(c, (HashNode, ValueNode)):
                return _bytes_enc_len(bytes(c))
            if c.flags.hash is not None:
                return 33
            kind, payload = info[id(c)]
            return 33 if kind == "gid" else len(payload)

        def write_child(c, out: bytearray) -> None:
            if c is None:
                out.append(0x80)
                return
            if isinstance(c, (HashNode, ValueNode)):
                _write_bytes(bytes(c), out)
                return
            if c.flags.hash is not None:
                _write_bytes(c.flags.hash, out)
                return
            kind, payload = info[id(c)]
            if kind == "gid":
                out.append(0xA0)
                patches.append((len(out), c, None))
                out.extend(b"\x00" * 32)
            else:
                out.extend(payload)

        # holes are keyed by the leaf's FULL hex key (prefix + short key)
        hole = None
        if entry.holes and isinstance(n, ShortNode) and isinstance(n.val, ValueNode):
            hole = entry.holes.get(path + n.key)

        if isinstance(n, ShortNode):
            key_enc = hex_to_compact(n.key)
            payload_len = _bytes_enc_len(key_enc) + child_len(n.val)
            total_len = _list_hdr_len(payload_len) + payload_len
            buf = bytearray()
            _write_list_hdr(payload_len, buf)
            _write_bytes(key_enc, buf)
            if hole is not None and isinstance(n.val, ValueNode):
                off_in_value, src = hole
                vb = bytes(n.val)
                content_start = len(buf) + (_bytes_enc_len(vb) - len(vb))
                _write_bytes(vb, buf)
                patches.append((content_start + off_in_value, None, src))
                self._healed.append((n, off_in_value, src))
            else:
                write_child(n.val, buf)
        elif isinstance(n, FullNode):
            payload_len = 0
            for i in range(16):
                payload_len += child_len(n.children[i])
            v = n.children[16]
            payload_len += _bytes_enc_len(bytes(v)) if isinstance(v, ValueNode) else 1
            total_len = _list_hdr_len(payload_len) + payload_len
            buf = bytearray()
            _write_list_hdr(payload_len, buf)
            for i in range(16):
                write_child(n.children[i], buf)
            if isinstance(v, ValueNode):
                _write_bytes(bytes(v), buf)
            else:
                buf.append(0x80)
        else:
            raise TypeError(f"cannot encode {type(n)}")

        is_embed = total_len < 32 and n is not entry.root
        if is_embed and patches:
            # an embedded node cannot carry patches: its bytes inline into
            # the parent, so hole offsets would shift. Dirty children of an
            # embedded node are themselves embedded (their RLP is < its
            # 32-byte bound), so patches here are impossible by
            # construction; assert the invariant.
            raise AssertionError("embedded node with digest holes")
        return (bytes(buf), patches, is_embed)

    # ------------------------------------------------------------------ run

    def run(self, planned=None, device=None) -> bytes:
        """Execute on device (`planned`, else the default PlannedCommit of
        `device`); assigns flags.hash on every hashed node, heals value
        holes, returns the final (account) root digest.

        Raises TooManySegments when the graph exceeds the executor's
        segment table; nothing is modified then."""
        t0 = time.perf_counter()
        built = self.build()
        self.plan_ms = (time.perf_counter() - t0) * 1e3
        if built is None:
            raise TooManySegments()
        specs, flat_words, dst, child, shift, root_pos, _total = built
        if planned is None:
            from ..ops.keccak_planned import default_planned_commit

            planned = default_planned_commit(device)
        self.plan = (specs, flat_words, dst, child, shift, root_pos)
        _root, dig = planned.run(specs, flat_words, dst, child, shift,
                                 root_pos, want_digests=True)
        self.digests = dig
        digs = np.ascontiguousarray(dig).view(np.uint8).reshape(-1, 32)
        for n, gid in self._hashed:
            n.flags.hash = digs[gid].tobytes()
            n.flags.dirty = True
        for n, off, src in self._healed:
            root_digest = digs[src.root_lane].tobytes()
            vb = bytearray(bytes(n.val))
            vb[off:off + 32] = root_digest
            n.val = ValueNode(bytes(vb))
        return digs[root_pos].tobytes()

    @property
    def n_hashed(self) -> int:
        """Nodes hashed by the last build (embedded nodes excluded)."""
        return len(self._hashed)

    def digest(self, entry: _TrieEntry) -> bytes:
        return entry.root.flags.hash


class TooManySegments(Exception):
    """Graph shape exceeds the planned executor's segment table."""


# Commits that took the level-batched BatchedHasher because their graph
# raised TooManySegments (Trie.hash, state.statedb.planned_intermediate_root).
planned_fallbacks = 0


class PlannedHasher:
    """Single-trie wrapper: Trie.hash()'s planned-mode backend; raises
    TooManySegments for graph shapes the executor's table cannot hold."""

    def __init__(self, planned=None):
        self._planned = planned

    def hash_root(self, root) -> HashNode:
        b = PlannedGraphBuilder()
        b.add_trie(root)
        return HashNode(b.run(self._planned))
