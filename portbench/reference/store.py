"""Reading an archive node's state back from its store, with nothing of
the port: plain `sqlite3` on the store's one table (kv: key BLOB primary
key, value BLOB), the hash-keyed trie layout (a trie node is stored
under its own Keccak-256), and this package's RLP and Keccak-256.

A walk starts at a state root and follows a 32-byte key's nibbles
through branches, extensions and the leaf; nodes shorter than 32 bytes
sit inline in their parent. Every node fetched is kept by its hash, and
after the walks every one is hashed in one batch and held against the
key it was stored under.
"""

from __future__ import annotations

import sqlite3
from typing import Dict, List, Optional, Sequence, Tuple

from . import rlp
from .chain import _hash_rows, _pack
from .keccak import keccak256


class Store:
    """One store file, opened read-only."""

    def __init__(self, path: str):
        self.conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
        self.conn.text_factory = bytes  # a value stored as text reads raw
        self.nodes: Dict[bytes, Optional[bytes]] = {}  # hash -> stored bytes
        self._decoded: Dict[bytes, list] = {}

    def close(self) -> None:
        self.conn.close()

    def _node(self, ref) -> Optional[list]:
        """The decoded node a parent refers to: by hash (fetched), or
        inline (already decoded)."""
        if isinstance(ref, list):
            return ref
        got = self._decoded.get(ref)
        if got is not None:
            return got
        if ref not in self.nodes:
            row = self.conn.execute("SELECT v FROM kv WHERE k = ?",
                                    (ref,)).fetchone()
            self.nodes[ref] = row[0] if row is not None else None
        blob = self.nodes[ref]
        if blob is None:
            return None
        node = rlp.decode(blob)
        self._decoded[ref] = node
        return node

    def get(self, root: bytes, key: bytes) -> Optional[bytes]:
        """The value under `key` (32 bytes, already hashed) in the trie at
        `root`; None when the path ends or a node is missing or
        malformed."""
        nibs = []
        for b in key:
            nibs += (b >> 4, b & 15)
        ref, pos = root, 0
        try:
            while True:
                node = self._node(ref)
                if node is None:
                    return None
                if len(node) == 17:
                    if pos == len(nibs):
                        return node[16] or None
                    ref = node[nibs[pos]]
                    pos += 1
                    if ref == b"":
                        return None
                    continue
                path, leaf = _hex_prefix(node[0])
                if nibs[pos:pos + len(path)] != path:
                    return None
                pos += len(path)
                if leaf:
                    return node[1] if pos == len(nibs) else None
                ref = node[1]
        except (IndexError, TypeError, ValueError):
            return None

    def bad_nodes(self, device="cpu") -> int:
        """Nodes fetched whose bytes do not hash to the key they were
        stored under."""
        keys = [k for k, v in self.nodes.items() if v is not None]
        if not keys:
            return 0
        rows, lens = _pack([self.nodes[k] for k in keys])
        got = keccak256(rows.to(device), lens.to(device)).cpu().numpy()
        return sum(1 for i, k in enumerate(keys) if got[i].tobytes() != k)


def _hex_prefix(b: bytes):
    nibs = []
    for x in b:
        nibs += (x >> 4, x & 15)
    flag = nibs[0]
    return nibs[2 - (flag & 1):], flag >= 2


def read_back(path: str, blocks: Sequence[Tuple[bytes, list, list]],
              device="cpu") -> Tuple[int, int]:
    """Walk the store at `path` for each block: (state root, [(address,
    account leaf value)], [(storage root, [(slot key, slot leaf value)])]).
    Returns (reads done, mismatches): every read that finds another value
    or none, plus every node fetched whose bytes do not hash to its key."""
    store = Store(path)
    try:
        addrs = sorted({a for _, acc, _ in blocks for a, _ in acc})
        slots = sorted({k for _, _, st in blocks for _, kv in st
                        for k, _ in kv})
        hashed = _hashes(addrs + slots, device)
        reads = bad = 0
        for root, accounts, storage in blocks:
            for addr, want in accounts:
                reads += 1
                bad += store.get(root, hashed[addr]) != want
            for sroot, kv in storage:
                for key, want in kv:
                    reads += 1
                    bad += store.get(sroot, hashed[key]) != want
        bad += store.bad_nodes(device)
    finally:
        store.close()
    return reads, bad


def _hashes(msgs: List[bytes], device) -> Dict[bytes, bytes]:
    if not msgs:
        return {}
    out = _hash_rows(msgs, device).cpu().numpy()
    return {m: out[i].tobytes() for i, m in enumerate(msgs)}
