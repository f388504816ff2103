"""Key-value storage abstraction (semantics of coreth ethdb/); counterpart
of coreth_tpu/ethdb/__init__.py.

KeyValueStore is the L0 interface (ethdb/database.go semantics): get/put/
delete/has, write batches, and ordered iteration. Backends: MemoryDB
here, SQLiteDB (a crash-safe persistent store) in sqlitedb.py, and the
FaultInjectingDB wrapper in faultdb.py.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Tuple


class DBError(RuntimeError):
    """Typed storage-layer failure (role of the reference backends'
    wrapped pebble/leveldb errors)."""


class CorruptDataError(DBError):
    """A value came back from disk but failed its integrity check (a
    hash-key mismatch under verify-on-read). Never retried: corruption is
    not transient."""


class KeyValueStore:
    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def put(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None

    def write_batch(self, writes: List[Tuple[bytes, Optional[bytes]]]) -> None:
        """Apply [(key, value-or-None-for-delete)] atomically."""
        raise NotImplementedError

    def new_batch(self) -> "Batch":
        return Batch(self)

    def iterate(
        self, prefix: bytes = b"", start: bytes = b""
    ) -> Iterator[Tuple[bytes, bytes]]:
        """Yield (key, value) with key >= prefix+start, key.startswith(prefix),
        ascending."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class Batch:
    """Buffered writes, applied atomically-ish on write()."""

    def __init__(self, db: KeyValueStore):
        self._db = db
        self.writes: List[Tuple[bytes, Optional[bytes]]] = []
        self.size = 0

    def put(self, key: bytes, value: bytes) -> None:
        self.writes.append((bytes(key), bytes(value)))
        self.size += len(key) + len(value)

    def delete(self, key: bytes) -> None:
        self.writes.append((bytes(key), None))
        self.size += len(key)

    def write(self) -> None:
        """Flush to the backing store. The buffer is kept until an
        explicit reset() (geth contract)."""
        self._db.write_batch(self.writes)

    def reset(self) -> None:
        self.writes = []
        self.size = 0


class MemoryDB(KeyValueStore):
    def __init__(self):
        self._data: Dict[bytes, bytes] = {}
        self._lock = threading.RLock()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._data.get(bytes(key))

    def put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._data[bytes(key)] = bytes(value)

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._data.pop(bytes(key), None)

    def has(self, key: bytes) -> bool:
        with self._lock:
            return bytes(key) in self._data

    def write_batch(self, writes) -> None:
        with self._lock:
            for k, v in writes:
                if v is None:
                    self._data.pop(k, None)
                else:
                    self._data[k] = v

    def iterate(self, prefix: bytes = b"", start: bytes = b""):
        # snapshot (key, value) pairs in one locked pass so iteration sees a
        # consistent view even under concurrent writes
        with self._lock:
            pairs = sorted(
                (k, v) for k, v in self._data.items() if k.startswith(prefix)
            )
        lo = bisect.bisect_left(pairs, (prefix + start, b""))
        yield from pairs[lo:]

    def __len__(self):
        with self._lock:
            return len(self._data)


def memorydb_from_items(items: Iterable[Tuple[bytes, bytes]]) -> MemoryDB:
    """A MemoryDB holding (key, value) items, such as another store's
    iterate(): the port opens state that another implementation persisted."""
    db = MemoryDB()
    db.write_batch([(bytes(k), bytes(v)) for k, v in items])
    return db


# Registers the ethdb/* failpoints at package import, so the catalogue of
# registered failpoints always carries them (faultdb imports
# KeyValueStore from here, hence the tail position).
from .faultdb import FaultInjectingDB  # noqa: E402
