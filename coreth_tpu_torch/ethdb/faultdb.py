"""Fault-injecting ethdb wrapper (role of coreth's ethdb/dbtest hooks
plus the failpoint discipline layered on top); counterpart of
coreth_tpu/ethdb/faultdb.py.

`FaultInjectingDB` wraps any KeyValueStore and compiles five failpoint
sites into the storage boundary, so disk failure becomes a first-class,
deterministic scenario instead of a mock:

    ethdb/before_get          raise -> DBError before the read
    ethdb/before_put          raise -> DBError before the write
    ethdb/before_batch_write  raise -> DBError before any batch byte
    ethdb/torn_batch          fires BETWEEN the two halves of a batch:
                              `raise` leaves a torn prefix applied
                              (non-atomic backend simulation), `hang`
                              parks mid-batch for SIGKILL drills
    ethdb/corrupt_read        flips one deterministic seeded bit in the
                              value returned by get()

`raise` verbs surface as typed DBError (chained to the FailpointError)
— exactly what a real backend raises — so the armor above (rawdb
verify-on-read, Backoff retries, the chain's degraded rung) is
exercised by the same type it must survive in production. The batch is
only split in two while ethdb/torn_batch is armed; unarmed, write_batch
passes through in one call and keeps the backend's atomicity.
"""

from __future__ import annotations

import zlib
from typing import Iterator, List, Optional, Tuple

from .. import fault
from ..fault import FailpointError, failpoint, register as _register_failpoint
from ..metrics import default_registry
from . import DBError, KeyValueStore

FP_GET = _register_failpoint(
    "ethdb/before_get", "storage read about to hit the backend")
FP_PUT = _register_failpoint(
    "ethdb/before_put", "storage write about to hit the backend")
FP_BATCH = _register_failpoint(
    "ethdb/before_batch_write", "atomic batch about to hit the backend")
FP_TORN = _register_failpoint(
    "ethdb/torn_batch", "between the two halves of a split batch: raise "
    "tears the batch, hang parks it for kill drills")
FP_CORRUPT = _register_failpoint(
    "ethdb/corrupt_read", "flip a deterministic seeded bit in a read value")


def _flip_bit(key: bytes, value: bytes) -> bytes:
    """One bit flipped at a position derived from (seed, key): the same
    chaos seed corrupts the same bit of the same record every run."""
    bit = zlib.crc32(bytes(key), fault.seed() & 0xFFFFFFFF) % (len(value) * 8)
    out = bytearray(value)
    out[bit // 8] ^= 1 << (bit % 8)
    return bytes(out)


class FaultInjectingDB(KeyValueStore):
    """Transparent KeyValueStore wrapper; identical behavior until an
    ethdb/* failpoint is armed."""

    def __init__(self, db: KeyValueStore):
        self._db = db

    # -- KeyValueStore -----------------------------------------------------

    def get(self, key: bytes) -> Optional[bytes]:
        try:
            failpoint("ethdb/before_get")
        except FailpointError as e:
            raise DBError(f"injected storage fault: {e}") from e
        value = self._db.get(key)
        if value and fault.enabled:
            try:
                failpoint("ethdb/corrupt_read")
            except FailpointError:
                default_registry.counter("ethdb/corrupt_injected").inc()
                value = _flip_bit(key, value)
        return value

    def put(self, key: bytes, value: bytes) -> None:
        try:
            failpoint("ethdb/before_put")
        except FailpointError as e:
            raise DBError(f"injected storage fault: {e}") from e
        self._db.put(key, value)

    def delete(self, key: bytes) -> None:
        try:
            failpoint("ethdb/before_put")
        except FailpointError as e:
            raise DBError(f"injected storage fault: {e}") from e
        self._db.delete(key)

    def has(self, key: bytes) -> bool:
        try:
            failpoint("ethdb/before_get")
        except FailpointError as e:
            raise DBError(f"injected storage fault: {e}") from e
        return self._db.has(key)

    def write_batch(self, writes: List[Tuple[bytes, Optional[bytes]]]) -> None:
        try:
            failpoint("ethdb/before_batch_write")
        except FailpointError as e:
            raise DBError(f"injected storage fault: {e}") from e
        if writes and fault.is_armed(FP_TORN):
            # Split so the torn_batch site sits between two backend
            # writes: a `raise` (or a SIGKILL while parked on `hang`)
            # leaves exactly the first half durable — the torn-batch
            # shape boot repair must survive.
            mid = (len(writes) + 1) // 2
            self._db.write_batch(writes[:mid])
            try:
                failpoint("ethdb/torn_batch")
            except FailpointError as e:
                raise DBError(f"injected torn batch: {e}") from e
            self._db.write_batch(writes[mid:])
        else:
            self._db.write_batch(writes)

    def iterate(
        self, prefix: bytes = b"", start: bytes = b""
    ) -> Iterator[Tuple[bytes, bytes]]:
        try:
            failpoint("ethdb/before_get")
        except FailpointError as e:
            raise DBError(f"injected storage fault: {e}") from e
        return self._db.iterate(prefix, start)

    def close(self) -> None:
        self._db.close()

    def __len__(self):
        return len(self._db)

    def __getattr__(self, name: str):
        # Backend extras (SQLiteDB.path/compact/stat) pass through.
        return getattr(self._db, name)
