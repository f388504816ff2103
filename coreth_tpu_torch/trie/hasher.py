"""Trie node hashing: the recursive CPU Hasher, the level-batched
BatchedHasher, the one-dispatch FusedHasher and the planned builder's RLP
helpers. Counterpart of coreth_tpu/trie/hasher.py (count_keccak_batch at
:49, Hasher at :106, BatchedHasher at :152, collect_levels_with_paths at
:210, new_hasher at :238, _keccak_pad at :321, FusedHasher at :332, the
RLP writers at :447-482).

  Hasher         recursive CPU hasher over the native keccak (small dirty
                 sets, where a device round trip costs more than it saves)
  BatchedHasher  groups the dirty subtree by height, leaves first, and
                 hashes each level's node RLP as one batch through a
                 batch keccak (on CUDA: BatchedKeccak, kernel K2); the
                 digests feed the next level's RLP
  FusedHasher    the whole dirty set in one fused commit
                 (ops/keccak_fused.py: one upload, child digests patched
                 into their parents on the device, kernel K2 per segment)

All are bit-exact: node RLP < 32 bytes is embedded in the parent instead
of hashed (coreth trie/hasher.go:160-175), and the root is always hashed.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

from .. import rlp
from ..native import keccak256 as _cpu_keccak
from .encoding import hex_to_compact
from .node import FullNode, HashNode, ShortNode, ValueNode

# Below this many dirty nodes Trie.hash stays on the CPU hasher (a device
# round trip costs more); mirrors the reference's >=100-unhashed threshold.
BATCH_THRESHOLD = 100

# Batches that reached a batch-keccak seam, and their messages (the JAX
# package's trie/keccak/batches and trie/keccak/batch_msgs counters).
keccak_batches = 0
keccak_batch_msgs = 0


def count_keccak_batch(n_msgs: int) -> None:
    """One batch of n_msgs messages hit a batch-keccak seam."""
    global keccak_batches, keccak_batch_msgs
    keccak_batches += 1
    keccak_batch_msgs += n_msgs


def node_items(n, child_repr: Callable = None):
    """Collapsed node -> python RLP structure (lists/bytes)."""
    if isinstance(n, ShortNode):
        return [hex_to_compact(n.key), _ref_item(n.val, child_repr)]
    if isinstance(n, FullNode):
        items = [_ref_item(c, child_repr) for c in n.children[:16]]
        v = n.children[16]
        items.append(bytes(v) if isinstance(v, ValueNode) else b"")
        return items
    raise TypeError(f"cannot encode {type(n)}")


def _ref_item(child, child_repr):
    if child is None:
        return b""
    if isinstance(child, (HashNode, ValueNode)):
        return bytes(child)
    if child_repr is not None:
        rep = child_repr(child)
        if rep is not None:
            return rep
    return node_items(child, child_repr)  # embedded small node


def node_to_bytes(n) -> bytes:
    return rlp.encode(node_items(n))


class Hasher:
    """Recursive CPU hasher: hash(n, force) -> (hashed_ref, n).

    hashed_ref is a HashNode when the encoding is >= 32 bytes (or force),
    else the collapsed node itself for embedding in the parent. Hashes are
    cached in node flags; clean nodes short-circuit."""

    def __init__(self, keccak: Callable[[bytes], bytes] = _cpu_keccak):
        self._keccak = keccak

    def hash(self, n, force: bool):
        if isinstance(n, (ShortNode, FullNode)):
            cached = n.flags.hash
            if cached is not None:
                return HashNode(cached), n
            collapsed = self._collapse(n)
            return self._store(collapsed, n, force), n
        return n, n  # HashNode / ValueNode pass through

    def _collapse(self, n):
        if isinstance(n, ShortNode):
            val = n.val
            if isinstance(val, (ShortNode, FullNode)):
                val, _ = self.hash(val, False)
            return ShortNode(n.key, val)
        children = [None] * 17
        for i in range(16):
            c = n.children[i]
            if c is not None:
                children[i] = self.hash(c, False)[0] if isinstance(
                    c, (ShortNode, FullNode)) else c
        children[16] = n.children[16]
        return FullNode(children)

    def _store(self, collapsed, orig, force: bool):
        enc = node_to_bytes(collapsed)
        if len(enc) < 32 and not force:
            return collapsed
        h = HashNode(self._keccak(enc))
        orig.flags.hash = bytes(h)
        orig.flags.dirty = True
        return h


class BatchedHasher:
    """Level-synchronised batched hasher for large dirty sets.

    Walk once to group dirty nodes by height (leaves first); per level,
    build every node's RLP with children resolved to digests (or embedded
    items), then hash the whole level in one batch_keccak call. The
    <32-byte embed rule is resolved on the host between levels. Sets
    flags.hash on every hashed node and leaves flags.dirty as it was."""

    def __init__(self, batch_keccak: Callable[[Sequence[bytes]], List[bytes]]):
        self._batch = batch_keccak

    def hash_root(self, root) -> HashNode:
        if not isinstance(root, (ShortNode, FullNode)):
            raise TypeError("batched hasher needs a Short/Full root")
        embedded: dict = {}  # id(node) -> its RLP items, inlined in the parent

        def child_repr(c):
            if not isinstance(c, (ShortNode, FullNode)):
                return None  # HashNode / ValueNode / None: the default
            if c.flags.hash is not None:
                return c.flags.hash
            items = embedded.get(id(c))
            if items is None:
                raise RuntimeError("child hashed out of order")
            return items

        for level in collect_levels_with_paths(root):
            pending_nodes = []
            pending_rlp = []
            for n, _path in level:
                items = node_items(n, child_repr)
                enc = rlp.encode(items)
                if len(enc) < 32 and n is not root:
                    embedded[id(n)] = items
                else:
                    pending_nodes.append(n)
                    pending_rlp.append(enc)
            if pending_rlp:
                for n, d in zip(pending_nodes, self._batch(pending_rlp)):
                    n.flags.hash = d
        return HashNode(root.flags.hash)


def new_hasher(dirty_estimate: int = 0, batch_keccak=None):
    """Factory seam (coreth trie/hasher.go:57 newHasher): a BatchedHasher
    when the dirty set is large and a batch keccak is given, else the
    recursive CPU hasher."""
    if batch_keccak is not None and dirty_estimate >= BATCH_THRESHOLD:
        return BatchedHasher(batch_keccak)
    return Hasher()


def collect_levels_with_paths(root):
    """Group dirty (unhashed) Short/Full nodes by height with their full hex
    paths, leaves first."""
    levels: List[list] = []

    def visit(n, path: bytes) -> int:
        # height of n within the dirty subtree; -1 for non-nodes
        if not isinstance(n, (ShortNode, FullNode)) or n.flags.hash is not None:
            return -1
        if isinstance(n, ShortNode):
            h = visit(n.val, path + n.key)
        else:
            h = -1
            for i in range(16):
                c = n.children[i]
                if c is not None:
                    h = max(h, visit(c, path + bytes([i])))
        h += 1
        while len(levels) <= h:
            levels.append([])
        levels[h].append((n, path))
        return h

    visit(root, b"")
    return levels


_KECCAK_RATE = 136


def _keccak_pad(msg: bytes) -> Tuple[bytes, int]:
    """Keccak-256 pad10*1; returns (padded bytes, block count)."""
    n = len(msg)
    blocks = n // _KECCAK_RATE + 1
    padded = bytearray(blocks * _KECCAK_RATE)
    padded[:n] = msg
    padded[n] ^= 0x01
    padded[-1] ^= 0x80
    return bytes(padded), blocks


class FusedHasher:
    """One-dispatch commit hashing (ops/keccak_fused.py consumer).

    The entire dirty set — every level, every size bucket — ships to the
    device as one transfer; child digests are patched into parent messages
    on the device between levels. Bit-exact with Hasher/BatchedHasher.

    fused_impl: a callable of ops/keccak_fused.fused_commit's first six
    arguments (default: fused_commit on CUDA; the device-hasher "fused"
    marker passes its laddered dispatch).

    The builder is a single-pass writer: each node's encoded length is
    cached when it is processed, so parents compute their RLP headers
    arithmetically and write their body exactly once."""

    def __init__(self, fused_impl=None):
        self._impl = fused_impl

    def hash_root(self, root) -> HashNode:
        from ..ops.keccak_fused import FusedBatch

        if not isinstance(root, (ShortNode, FullNode)):
            raise TypeError("fused hasher needs a Short/Full root")
        batch = FusedBatch()
        # per-node info: (kind, payload) where kind is one of
        #   "gid"   — hashed; payload = global digest index (33 enc bytes)
        #   "embed" — embedded; payload = raw encoded bytes (no slots)
        info: dict = {}
        hashed_nodes: list = []

        def child_len(c) -> int:
            """Encoded length of a child reference."""
            if c is None:
                return 1
            if isinstance(c, (HashNode, ValueNode)):
                return _bytes_enc_len(bytes(c))
            if c.flags.hash is not None:
                return 33
            kind, payload = info[id(c)]
            return 33 if kind == "gid" else len(payload)

        def write_child(c, out: bytearray, patches: list) -> None:
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
                patches.append((len(out), payload))
                out.extend(b"\x00" * 32)
            else:
                out.extend(payload)

        for level in collect_levels_with_paths(root):
            msgs, nblocks, patches, nodes_here = [], [], [], []
            for n, _path in level:
                # payload length from cached child lengths
                if isinstance(n, ShortNode):
                    key_enc = hex_to_compact(n.key)
                    payload_len = _bytes_enc_len(key_enc) + child_len(n.val)
                else:
                    payload_len = sum(child_len(n.children[i])
                                      for i in range(16))
                    v = n.children[16]
                    payload_len += (_bytes_enc_len(bytes(v))
                                    if isinstance(v, ValueNode) else 1)
                total_len = _list_hdr_len(payload_len) + payload_len

                buf = bytearray()
                node_patches: list = []
                _write_list_hdr(payload_len, buf)
                if isinstance(n, ShortNode):
                    _write_bytes(key_enc, buf)
                    write_child(n.val, buf, node_patches)
                else:
                    for i in range(16):
                        write_child(n.children[i], buf, node_patches)
                    v = n.children[16]
                    if isinstance(v, ValueNode):
                        _write_bytes(bytes(v), buf)
                    else:
                        buf.append(0x80)

                if total_len < 32 and n is not root:
                    info[id(n)] = ("embed", bytes(buf))
                    continue
                padded, blocks = _keccak_pad(bytes(buf))
                mi = len(msgs)
                msgs.append(padded)
                nblocks.append(blocks)
                # patch offsets recorded during this node's write
                for off, gid in node_patches:
                    patches.append((mi, off, gid))
                nodes_here.append(n)
            level_gids = batch.add_level(msgs, nblocks, patches)
            for n, g in zip(nodes_here, level_gids):
                info[id(n)] = ("gid", g)
                hashed_nodes.append((n, g))

        digests = batch.run(self._impl)
        for n, g in hashed_nodes:
            n.flags.hash = digests[g]
            n.flags.dirty = True
        return HashNode(root.flags.hash)


def _bytes_enc_len(b: bytes) -> int:
    n = len(b)
    if n == 1 and b[0] < 0x80:
        return 1
    if n < 56:
        return 1 + n
    return 1 + (n.bit_length() + 7) // 8 + n


def _write_bytes(b: bytes, out: bytearray) -> None:
    n = len(b)
    if n == 1 and b[0] < 0x80:
        out.append(b[0])
    elif n < 56:
        out.append(0x80 + n)
        out.extend(b)
    else:
        lb = n.to_bytes((n.bit_length() + 7) // 8, "big")
        out.append(0xB7 + len(lb))
        out.extend(lb)
        out.extend(b)


def _list_hdr_len(payload: int) -> int:
    if payload < 56:
        return 1
    return 1 + (payload.bit_length() + 7) // 8


def _write_list_hdr(payload: int, out: bytearray) -> None:
    if payload < 56:
        out.append(0xC0 + payload)
    else:
        lb = payload.to_bytes((payload.bit_length() + 7) // 8, "big")
        out.append(0xF7 + len(lb))
        out.extend(lb)
