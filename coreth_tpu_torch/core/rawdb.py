"""Database key schema & typed accessors (semantics of coreth core/rawdb/);
counterpart of coreth_tpu/core/rawdb.py:1-286.

Key layout follows core/rawdb/schema.go:80-159: single-byte prefixes with
typed accessor functions over the raw KV store. Trie nodes are keyed by bare
hash (legacy hashdb scheme), matching the TrieDatabase; the resident
mirror's storage-lean node rows are keyed by digest-store slot. The
snapshot tree (state/snapshot.py) keeps its own accessors; the state-sync
markers are sync/statesync.py's and vm/syncervm.py's, and their keys are
here so inspect_database sorts them.
"""

from __future__ import annotations

from typing import Optional

from ..ethdb import CorruptDataError, KeyValueStore
from ..metrics import default_registry
from ..native import keccak256

# --- verify-on-read (db-verify-on-read) -------------------------------------
# When on, hash-addressed payloads are re-hashed as they leave the disk:
# header RLP against the block hash embedded in its key, contract code
# against its code hash. A mismatch is counted (db/verify_failures) and
# raised as CorruptDataError instead of feeding bad bytes into consensus.
verify_on_read = False


def set_verify_on_read(on: bool) -> None:
    """Flip the process-wide verify mode."""
    global verify_on_read
    verify_on_read = bool(on)


def _verify(blob: bytes, want_hash: bytes, what: str) -> bytes:
    if keccak256(blob) != want_hash:
        default_registry.counter("db/verify_failures").inc()
        raise CorruptDataError(
            f"{what} payload failed verify-on-read: keccak mismatch for "
            f"hash {want_hash.hex()}")
    default_registry.counter("db/verified_reads").inc()
    return blob


# --- prefixes (core/rawdb/schema.go) ---------------------------------------
HEADER_PREFIX = b"h"          # h + num(8) + hash -> header RLP
HEADER_HASH_SUFFIX = b"n"     # h + num(8) + n -> canonical hash
HEADER_NUMBER_PREFIX = b"H"   # H + hash -> num(8)
BODY_PREFIX = b"b"            # b + num(8) + hash -> body RLP
RECEIPTS_PREFIX = b"r"        # r + num(8) + hash -> receipts RLP
CODE_PREFIX = b"c"            # c + code_hash -> contract code
TX_LOOKUP_PREFIX = b"l"       # l + tx_hash -> block num(8)
SNAPSHOT_ACCOUNT_PREFIX = b"a"  # a + acct_hash -> slim account RLP
SNAPSHOT_STORAGE_PREFIX = b"o"  # o + acct_hash + slot_hash -> value
SNAPSHOT_ROOT_KEY = b"SnapshotRoot"
SNAPSHOT_BLOCK_HASH_KEY = b"SnapshotBlockHash"
SNAPSHOT_GENERATOR_KEY = b"SnapshotGenerator"
HEAD_HEADER_KEY = b"LastHeader"
HEAD_BLOCK_KEY = b"LastBlock"
ACCEPTOR_TIP_KEY = b"AcceptorTipKey"
SYNC_ROOT_KEY = b"sync_root"  # state-sync progress (schema.go:108-114)

# storage-lean trie-node rows: nodes addressed by their resident
# digest-store SLOT instead of the 32-byte content hash, N + slot(4) ->
# digest(32) + node RLP. The digest rides in the value, so the
# verify-on-read contract still holds (it re-checks against keccak(rlp)).
# The consensus path stays hash-addressed.
LEAN_NODE_PREFIX = b"N"


def _num(n: int) -> bytes:
    return n.to_bytes(8, "big")


# --- contract code (accessors_state.go:68) ---------------------------------

def code_key(code_hash: bytes) -> bytes:
    return CODE_PREFIX + code_hash


def read_code(db: KeyValueStore, code_hash: bytes) -> Optional[bytes]:
    code = db.get(code_key(code_hash))
    if code is None:
        code = db.get(code_hash)  # legacy un-prefixed fallback, like the reference
    if code is not None and verify_on_read:
        _verify(code, code_hash, "code")
    return code


def write_code(db, code_hash: bytes, code: bytes) -> None:
    db.put(code_key(code_hash), code)


def has_code(db: KeyValueStore, code_hash: bytes) -> bool:
    return read_code(db, code_hash) is not None


# --- canonical number/hash mappings ----------------------------------------

def canonical_hash_key(number: int) -> bytes:
    return HEADER_PREFIX + _num(number) + HEADER_HASH_SUFFIX


def read_canonical_hash(db: KeyValueStore, number: int) -> Optional[bytes]:
    return db.get(canonical_hash_key(number))


def write_canonical_hash(db, block_hash: bytes, number: int) -> None:
    db.put(canonical_hash_key(number), block_hash)


def delete_canonical_hash(db, number: int) -> None:
    db.delete(canonical_hash_key(number))


def read_header_number(db: KeyValueStore, block_hash: bytes) -> Optional[int]:
    v = db.get(HEADER_NUMBER_PREFIX + block_hash)
    return int.from_bytes(v, "big") if v is not None else None


def write_header_number(db, block_hash: bytes, number: int) -> None:
    db.put(HEADER_NUMBER_PREFIX + block_hash, _num(number))


# --- raw header/body/receipt blobs (typed wrappers live in core.types) -----

def header_key(number: int, block_hash: bytes) -> bytes:
    return HEADER_PREFIX + _num(number) + block_hash


def body_key(number: int, block_hash: bytes) -> bytes:
    return BODY_PREFIX + _num(number) + block_hash


def receipts_key(number: int, block_hash: bytes) -> bytes:
    return RECEIPTS_PREFIX + _num(number) + block_hash


def read_header_rlp(db, number: int, block_hash: bytes) -> Optional[bytes]:
    blob = db.get(header_key(number, block_hash))
    if blob is not None and verify_on_read:
        _verify(blob, block_hash, "header")
    return blob


def write_header_rlp(db, number: int, block_hash: bytes, blob: bytes) -> None:
    db.put(header_key(number, block_hash), blob)
    write_header_number(db, block_hash, number)


def read_body_rlp(db, number: int, block_hash: bytes) -> Optional[bytes]:
    return db.get(body_key(number, block_hash))


def write_body_rlp(db, number: int, block_hash: bytes, blob: bytes) -> None:
    db.put(body_key(number, block_hash), blob)


def read_receipts_rlp(db, number: int, block_hash: bytes) -> Optional[bytes]:
    return db.get(receipts_key(number, block_hash))


def write_receipts_rlp(db, number: int, block_hash: bytes, blob: bytes) -> None:
    db.put(receipts_key(number, block_hash), blob)


def read_head_block_hash(db) -> Optional[bytes]:
    return db.get(HEAD_BLOCK_KEY)


def write_head_block_hash(db, block_hash: bytes) -> None:
    db.put(HEAD_BLOCK_KEY, block_hash)


def read_head_header_hash(db) -> Optional[bytes]:
    return db.get(HEAD_HEADER_KEY)


def write_head_header_hash(db, block_hash: bytes) -> None:
    db.put(HEAD_HEADER_KEY, block_hash)


# --- storage-lean node rows (digest-slot-addressed) ------------------------

def lean_node_key(slot: int) -> bytes:
    return LEAN_NODE_PREFIX + slot.to_bytes(4, "big")


def write_lean_node(db, slot: int, digest: bytes, rlp: bytes) -> None:
    if len(digest) != 32:
        raise ValueError("lean node digest must be 32 bytes")
    db.put(lean_node_key(slot), digest + rlp)


def read_lean_node(db: KeyValueStore, slot: int):
    """(digest, rlp) at [slot], or None. verify_on_read re-hashes the
    RLP against the stored digest: slot keys carry no hash, so the
    digest in the value anchors the integrity check."""
    v = db.get(lean_node_key(slot))
    if v is None:
        return None
    digest, rlp = v[:32], v[32:]
    if verify_on_read:
        _verify(rlp, digest, "lean trie node")
    return digest, rlp


def lean_nodes_footprint(db: KeyValueStore) -> dict:
    """{count, bytes} of the lean node-row keyspace (key + value bytes)."""
    count = 0
    size = 0
    for k, v in db.iterate():
        if k.startswith(LEAN_NODE_PREFIX) and len(k) == 5:
            count += 1
            size += len(k) + len(v)
    return {"count": count, "bytes": size}


# --- tx lookup --------------------------------------------------------------

def read_tx_lookup(db, tx_hash: bytes) -> Optional[int]:
    v = db.get(TX_LOOKUP_PREFIX + tx_hash)
    return int.from_bytes(v, "big") if v is not None else None


def write_tx_lookup(db, tx_hash: bytes, number: int) -> None:
    db.put(TX_LOOKUP_PREFIX + tx_hash, _num(number))


def inspect_database(db) -> dict:
    """InspectDatabase (core/rawdb/database.go): one full-keyspace walk
    sorting entry counts and sizes by schema prefix."""
    categories = [
        ("headers", HEADER_PREFIX, 41),          # h + num(8) + hash(32)
        ("canonicalHashes", HEADER_PREFIX, 10),  # h + num(8) + 'n'
        ("headerNumbers", HEADER_NUMBER_PREFIX, 33),
        ("bodies", BODY_PREFIX, 41),
        ("receipts", RECEIPTS_PREFIX, 41),
        ("code", CODE_PREFIX, 33),
        ("txLookups", TX_LOOKUP_PREFIX, 33),
        ("accountSnapshot", SNAPSHOT_ACCOUNT_PREFIX, 33),
        ("storageSnapshot", SNAPSHOT_STORAGE_PREFIX, 65),
        ("bloomBits", b"B", 7),
        ("leanTrieNodes", LEAN_NODE_PREFIX, 5),  # N + slot(4)
        ("syncProgress", b"sync_", 0),
    ]
    stats = {name: {"count": 0, "bytes": 0} for name, _, _ in categories}
    stats["trieNodes"] = {"count": 0, "bytes": 0}
    stats["metadata"] = {"count": 0, "bytes": 0}
    stats["other"] = {"count": 0, "bytes": 0}
    meta_keys = {
        SNAPSHOT_ROOT_KEY, SNAPSHOT_BLOCK_HASH_KEY, SNAPSHOT_GENERATOR_KEY,
        HEAD_HEADER_KEY, HEAD_BLOCK_KEY, ACCEPTOR_TIP_KEY, SYNC_ROOT_KEY,
    }
    total = {"count": 0, "bytes": 0}
    for k, v in db.iterate():
        size = len(k) + len(v)
        total["count"] += 1
        total["bytes"] += size
        if k in meta_keys:
            bucket = "metadata"
        else:
            for name, prefix, klen in categories:
                if k.startswith(prefix) and (klen == 0 or len(k) == klen):
                    bucket = name
                    break
            else:
                # 32-byte keys are hash-addressed trie nodes (hashdb scheme)
                bucket = "trieNodes" if len(k) == 32 else "other"
        stats[bucket]["count"] += 1
        stats[bucket]["bytes"] += size
    stats["total"] = total
    return stats
