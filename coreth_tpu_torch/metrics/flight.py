"""Per-block flight recorder (counterpart of coreth_tpu/metrics/flight.py):
a bounded ring of the last N block-insert records, always on (the cost is
a handful of clock reads and counter snapshots per block — noise next to
execution/commit).

Each record is a plain dict built by core/blockchain during insert:

    {"number": int, "hash": bytes, "txs": int, "gas_used": int,
     "phases": {"recover"|"verify"|"execute"|"validate"|"commit"|"write":
                seconds, ...},
     "resident": {phase: seconds, ...},      # resident/phase/* deltas
     "counters": {name: delta, ...},         # snap + plan-cache + keccak
     "parallel": {"mode": ..., ...},         # optimistic-executor verdict
     "host_mode": bool | None,               # device vs host hashing
     "trace_id": str | None,                 # insert-… id (tracectx)
     "accepted": bool, "seq": int}

`parallel` starts present-but-empty and `host_mode`/`counters` are
stamped in the insert's finally block, so host-fallback and
failed-before-execute records carry the same key set as the happy path
(`counters["resident/h2d_bytes"]` is an explicit 0 on host-mode
commits — bench attribution must never average over a ragged set).

The `write` phase is stamped asynchronously by the overlapped insert
tail; records are shared dicts, so readers see it once the tail worker
lands. On verify/execute failure the in-flight record is attached to the
chain's `bad_blocks` ring instead. The reference's RPC surface
(`debug_blockFlightRecord`) is not ported (ROADMAP "Still to port",
item 10); `marshal_record` gives the JSON-safe copy it serves.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

DEFAULT_CAPACITY = 64


class FlightRecorder:
    """Lock-guarded bounded ring of per-block records. One instance per
    BlockChain (NOT process-global) so tests and multi-VM processes
    don't bleed into each other."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        self._events: deque = deque(maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        self._seq = 0

    def record(self, rec: Dict[str, object]) -> Dict[str, object]:
        """Append one block record (mutated in place later for the async
        `write` phase and the accept mark). Returns the same dict."""
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            rec.setdefault("accepted", False)
            self._ring.append(rec)
        return rec

    def mark_accepted(self, block_hash: bytes) -> None:
        """Flip `accepted` on the record for this hash (newest match)."""
        with self._lock:
            for rec in reversed(self._ring):
                if rec.get("hash") == block_hash:
                    rec["accepted"] = True
                    return

    def last(self, n: Optional[int] = None,
             accepted_only: bool = False) -> List[Dict[str, object]]:
        """Newest-last list of the most recent records. The dicts are the
        live ones (so late `write` stamps show up); callers that marshal
        should copy."""
        with self._lock:
            recs = list(self._ring)
        if accepted_only:
            recs = [r for r in recs if r.get("accepted")]
        if n is not None:
            recs = recs[-max(0, int(n)):]
        return recs

    def note_event(self, kind: str, **fields) -> Dict[str, object]:
        """Append one out-of-band lifecycle event (device demotion/
        re-promotion, mirror quarantine, torn-tail repair, ...) to a ring
        parallel to the block records, sharing the same seq counter so
        events interleave with blocks in wall order."""
        ev = {"event": kind, "ts": time.time()}
        ev.update(fields)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._events.append(ev)
        return ev

    def events(self, n: Optional[int] = None,
               kind: Optional[str] = None) -> List[Dict[str, object]]:
        """Newest-last list of recent lifecycle events."""
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e.get("event") == kind]
        if n is not None:
            evs = evs[-max(0, int(n)):]
        return evs

    def find(self, block_hash: bytes) -> Optional[Dict[str, object]]:
        with self._lock:
            for rec in reversed(self._ring):
                if rec.get("hash") == block_hash:
                    return rec
        return None

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def capacity(self) -> int:
        with self._lock:
            return self._ring.maxlen or 0

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


def marshal_record(rec: Dict[str, object]) -> Dict[str, object]:
    """JSON-safe copy of one record (bytes hash → 0x-hex) — shared by
    debug_blockFlightRecord and debug_getBadBlocks."""
    out = dict(rec)
    h = out.get("hash")
    if isinstance(h, (bytes, bytearray)):
        out["hash"] = "0x" + bytes(h).hex()
    for k in ("phases", "counters", "resident", "parallel"):
        if isinstance(out.get(k), dict):
            out[k] = dict(out[k])
    return out
