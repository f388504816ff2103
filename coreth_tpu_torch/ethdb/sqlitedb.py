"""Persistent key-value backend over SQLite (role of coreth's
ethdb/pebble/pebble.go and ethdb/leveldb/leveldb.go); counterpart of
coreth_tpu/ethdb/sqlitedb.py.

Why SQLite and not a hand-rolled LSM: the reference's requirement at L0
is a crash-safe ordered KV store with atomic write batches
(ethdb/database.go + ethdb/batch.go contract, exercised by
ethdb/dbtest/testsuite.go). SQLite's B-tree with WAL journaling gives
all three (memcmp-ordered BLOB primary keys, transactional batches,
fsync discipline) from the Python stdlib — no native build step on the
chain-startup path, while the heavy state work stays on the device path.

Contract details matched to the reference backends:
  - keys are raw bytes, ordered bytewise (BLOB PRIMARY KEY is memcmp
    order, same as pebble/leveldb iterators)
  - write_batch applies atomically: all-or-nothing across crash
    (pebble.Batch.Commit / leveldb.Batch.Write)
  - iterate(prefix, start) = NewIterator(prefix, start): ascending from
    prefix+start, bounded to the prefix
  - close() is idempotent; operations after close raise (database.go
    ErrClosed semantics)
  - sqlite3.Error never escapes raw: every operation surfaces typed
    ethdb.DBError (counted under drop/ethdb/sqlite/<op>) so the armor
    above — Backoff retries, the chain's degraded rung — catches one
    exception type for every backend
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Iterator, List, Optional, Tuple

from ..metrics import count_drop
from . import DBError, KeyValueStore

_ITER_CHUNK = 1024


class SQLiteDB(KeyValueStore):
    def __init__(self, path: str, cache_mb: int = 16, sync: bool = True):
        """path: database file (created with parents if absent);
        sync=False trades fsync-per-commit for speed (tests/benches)."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self.path = path
        self._lock = threading.RLock()
        self._closed = False
        try:
            self._conn = sqlite3.connect(path, check_same_thread=False)
            cur = self._conn.cursor()
            cur.execute("PRAGMA journal_mode=WAL")
            cur.execute(f"PRAGMA synchronous={'NORMAL' if sync else 'OFF'}")
            cur.execute(f"PRAGMA cache_size={-1024 * cache_mb}")
            cur.execute(
                "CREATE TABLE IF NOT EXISTS kv ("
                "k BLOB PRIMARY KEY, v BLOB NOT NULL) WITHOUT ROWID"
            )
            self._conn.commit()
        except sqlite3.Error as e:
            count_drop("ethdb/sqlite/open")
            raise DBError(f"sqlitedb: open {path!r} failed: {e}") from e

    # -- helpers -----------------------------------------------------------

    def _check_open(self):
        if self._closed:
            raise DBError("sqlitedb: database closed")

    # -- KeyValueStore -----------------------------------------------------

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            self._check_open()
            try:
                row = self._conn.execute(
                    "SELECT v FROM kv WHERE k = ?", (bytes(key),)
                ).fetchone()
            except sqlite3.Error as e:
                count_drop("ethdb/sqlite/get")
                raise DBError(f"sqlitedb: get failed: {e}") from e
        return bytes(row[0]) if row is not None else None

    def put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._check_open()
            try:
                self._conn.execute(
                    "INSERT INTO kv(k, v) VALUES(?, ?) "
                    "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                    (bytes(key), bytes(value)),
                )
                self._conn.commit()
            except sqlite3.Error as e:
                count_drop("ethdb/sqlite/put")
                raise DBError(f"sqlitedb: put failed: {e}") from e

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._check_open()
            try:
                self._conn.execute(
                    "DELETE FROM kv WHERE k = ?", (bytes(key),))
                self._conn.commit()
            except sqlite3.Error as e:
                count_drop("ethdb/sqlite/delete")
                raise DBError(f"sqlitedb: delete failed: {e}") from e

    def has(self, key: bytes) -> bool:
        with self._lock:
            self._check_open()
            try:
                row = self._conn.execute(
                    "SELECT 1 FROM kv WHERE k = ?", (bytes(key),)
                ).fetchone()
            except sqlite3.Error as e:
                count_drop("ethdb/sqlite/get")
                raise DBError(f"sqlitedb: has failed: {e}") from e
        return row is not None

    def write_batch(self, writes: List[Tuple[bytes, Optional[bytes]]]) -> None:
        """One transaction: crash-atomic across the whole batch
        (a torn batch is all-or-nothing at this layer)."""
        with self._lock:
            self._check_open()
            cur = self._conn.cursor()
            try:
                cur.execute("BEGIN")
                for k, v in writes:
                    if v is None:
                        cur.execute("DELETE FROM kv WHERE k = ?", (bytes(k),))
                    else:
                        cur.execute(
                            "INSERT INTO kv(k, v) VALUES(?, ?) "
                            "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                            (bytes(k), bytes(v)),
                        )
                self._conn.commit()
            except BaseException as e:
                # Roll back so the failed batch leaves NO partial bytes;
                # sqlite errors leave as typed DBError, everything else
                # (failpoints, KeyboardInterrupt) re-raises as-is.
                self._conn.rollback()
                if isinstance(e, sqlite3.Error):
                    count_drop("ethdb/sqlite/batch")
                    raise DBError(f"sqlitedb: batch failed: {e}") from e
                raise

    def iterate(
        self, prefix: bytes = b"", start: bytes = b""
    ) -> Iterator[Tuple[bytes, bytes]]:
        """Chunked scans re-anchored by last key: the iterator stays valid
        across concurrent writes (same guarantee the reference relies on
        for pruning + leaf serving)."""
        lo = bytes(prefix) + bytes(start)
        first = True
        while True:
            with self._lock:
                self._check_open()  # close() mid-scan must fail loudly
                try:
                    if first:
                        rows = self._conn.execute(
                            "SELECT k, v FROM kv WHERE k >= ? "
                            "ORDER BY k LIMIT ?",
                            (lo, _ITER_CHUNK),
                        ).fetchall()
                    else:
                        rows = self._conn.execute(
                            "SELECT k, v FROM kv WHERE k > ? "
                            "ORDER BY k LIMIT ?",
                            (lo, _ITER_CHUNK),
                        ).fetchall()
                except sqlite3.Error as e:
                    count_drop("ethdb/sqlite/iterate")
                    raise DBError(f"sqlitedb: iterate failed: {e}") from e
            for k, v in rows:
                k = bytes(k)
                if prefix and not k.startswith(prefix):
                    return
                yield k, bytes(v)
            if len(rows) < _ITER_CHUNK:
                return
            lo = bytes(rows[-1][0])
            first = False

    def compact(self) -> None:
        with self._lock:
            self._check_open()
            try:
                self._conn.execute("VACUUM")
            except sqlite3.Error as e:
                count_drop("ethdb/sqlite/compact")
                raise DBError(f"sqlitedb: compact failed: {e}") from e

    def stat(self) -> dict:
        with self._lock:
            self._check_open()
            try:
                n = self._conn.execute(
                    "SELECT COUNT(*) FROM kv").fetchone()[0]
                pages = self._conn.execute(
                    "PRAGMA page_count").fetchone()[0]
                page_size = self._conn.execute(
                    "PRAGMA page_size").fetchone()[0]
            except sqlite3.Error as e:
                count_drop("ethdb/sqlite/stat")
                raise DBError(f"sqlitedb: stat failed: {e}") from e
        return {"entries": n, "bytes": pages * page_size}

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._conn.commit()
                self._conn.close()
            except sqlite3.Error as e:
                # The handle is gone either way; closed-state is set, so
                # count it and surface the typed failure.
                count_drop("ethdb/sqlite/close")
                raise DBError(f"sqlitedb: close failed: {e}") from e

    def __len__(self):
        return self.stat()["entries"]
