"""Database key schema & typed accessors (semantics of coreth core/rawdb/);
counterpart of coreth_tpu/core/rawdb.py:29-190, 233-241.

Key layout follows core/rawdb/schema.go:80-159: single-byte prefixes with
typed accessor functions over the raw KV store. Trie nodes are keyed by bare
hash (legacy hashdb scheme), matching the TrieDatabase. The reference's
verify-read counters wait for the port's metrics (ROADMAP "Still to port",
item 10), its snapshot and sync keys for the snapshot tree and state sync,
its lean-node rows for the resident mirror (item 4).
"""

from __future__ import annotations

from typing import Optional

from ..ethdb import CorruptDataError, KeyValueStore
from ..native import keccak256

# --- verify-on-read (db-verify-on-read) -------------------------------------
# When on, hash-addressed payloads are re-hashed as they leave the disk:
# header RLP against the block hash embedded in its key, contract code
# against its code hash. A mismatch is raised as CorruptDataError instead
# of feeding bad bytes into consensus.
verify_on_read = False


def set_verify_on_read(on: bool) -> None:
    """Flip the process-wide verify mode."""
    global verify_on_read
    verify_on_read = bool(on)


def _verify(blob: bytes, want_hash: bytes, what: str) -> bytes:
    if keccak256(blob) != want_hash:
        raise CorruptDataError(
            f"{what} payload failed verify-on-read: keccak mismatch for "
            f"hash {want_hash.hex()}")
    return blob


# --- prefixes (core/rawdb/schema.go) ---------------------------------------
HEADER_PREFIX = b"h"          # h + num(8) + hash -> header RLP
HEADER_HASH_SUFFIX = b"n"     # h + num(8) + n -> canonical hash
HEADER_NUMBER_PREFIX = b"H"   # H + hash -> num(8)
BODY_PREFIX = b"b"            # b + num(8) + hash -> body RLP
RECEIPTS_PREFIX = b"r"        # r + num(8) + hash -> receipts RLP
CODE_PREFIX = b"c"            # c + code_hash -> contract code
TX_LOOKUP_PREFIX = b"l"       # l + tx_hash -> block num(8)
HEAD_HEADER_KEY = b"LastHeader"
HEAD_BLOCK_KEY = b"LastBlock"


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


# --- tx lookup --------------------------------------------------------------

def read_tx_lookup(db, tx_hash: bytes) -> Optional[int]:
    v = db.get(TX_LOOKUP_PREFIX + tx_hash)
    return int.from_bytes(v, "big") if v is not None else None


def write_tx_lookup(db, tx_hash: bytes, number: int) -> None:
    db.put(TX_LOOKUP_PREFIX + tx_hash, _num(number))
