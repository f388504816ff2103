"""Request-scoped trace context: cheap thread-local trace ids + a bounded
capture ring; counterpart of coreth_tpu/metrics/tracectx.py.

A trace id is minted at an admission point (RPC dispatch, block insert) and
travels with the request across thread boundaries: the admission lanes hand
the context to their worker threads, deadline expiries stamp it into the
raised error, spans inherit their parent across the handoff, and the flight
record carries it per block.  Interesting traces (sheds, deadline expiries,
abandoned requests, over-SLO completions) are captured into a process-global
bounded ring.

Everything here is gated on the module-level ``enabled`` flag — one bool
check per call site when tracing is off — and id formatting goes through the
single gated :func:`mint` helper so hot paths never build trace strings
inline.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

enabled = os.environ.get("CORETH_TPU_TRACING", "1").lower() not in (
    "0", "false", "off")

DEFAULT_RING_SIZE = 256

# spans appended per trace are bounded so a pathological handler cannot
# balloon a ring entry
MAX_SPANS_PER_TRACE = 128

_ids = itertools.count(1)
# short per-process prefix keeps ids from colliding across restarts in logs
_prefix = "%04x" % (os.getpid() & 0xFFFF)
_tls = threading.local()


def mint(kind: str) -> str:
    """Format a fresh trace id.  The one sanctioned trace-id formatting
    site — hot paths must call this instead of building f-strings."""
    return "%s-%s-%06x" % (kind, _prefix, next(_ids))


class TraceCtx:
    """Ambient per-request context.  Created once at admission and installed
    on every thread that works on the request via :class:`scope`."""

    __slots__ = ("trace_id", "kind", "t0", "parent_span_id", "meta", "spans")

    def __init__(self, trace_id: str, kind: str,
                 parent_span_id: Optional[int] = None):
        self.trace_id = trace_id
        self.kind = kind
        self.t0 = time.monotonic()
        self.parent_span_id = parent_span_id
        self.meta: Dict[str, Any] = {}
        self.spans: List[Dict[str, Any]] = []

    def add_span(self, rec: Dict[str, Any]) -> None:
        if len(self.spans) < MAX_SPANS_PER_TRACE:
            self.spans.append(rec)

    def elapsed(self) -> float:
        return time.monotonic() - self.t0


def begin(kind: str, parent_span_id: Optional[int] = None) -> Optional[TraceCtx]:
    """Mint a context for a new request, or None when tracing is off."""
    if not enabled:
        return None
    return TraceCtx(mint(kind), kind, parent_span_id)


def current() -> Optional[TraceCtx]:
    return getattr(_tls, "ctx", None)


def current_id() -> Optional[str]:
    ctx = getattr(_tls, "ctx", None)
    return ctx.trace_id if ctx is not None else None


class scope:
    """Install a TraceCtx on this thread for the duration of a block.
    ``scope(None)`` is a no-op so call sites need no branching."""

    __slots__ = ("ctx", "_prev")

    def __init__(self, ctx: Optional[TraceCtx]):
        self.ctx = ctx

    def __enter__(self) -> Optional[TraceCtx]:
        if self.ctx is not None:
            self._prev = getattr(_tls, "ctx", None)
            _tls.ctx = self.ctx
        return self.ctx

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.ctx is not None:
            _tls.ctx = self._prev


class TraceRing:
    """Bounded, thread-safe ring of captured trace records keyed by id."""

    def __init__(self, capacity: int = DEFAULT_RING_SIZE):
        self._capacity = max(1, int(capacity))
        self._recs: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._lock = threading.Lock()

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._capacity = max(1, int(capacity))
            while len(self._recs) > self._capacity:
                self._recs.popitem(last=False)

    def put(self, rec: Dict[str, Any]) -> None:
        tid = rec.get("trace_id")
        if not tid:
            return
        with self._lock:
            self._recs[tid] = rec
            self._recs.move_to_end(tid)
            while len(self._recs) > self._capacity:
                self._recs.popitem(last=False)

    def get(self, trace_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._recs.get(trace_id)

    def last(self, n: int = 16) -> List[Dict[str, Any]]:
        with self._lock:
            recs = list(self._recs.values())
        return recs[-max(0, int(n)):]

    def __len__(self) -> int:
        with self._lock:
            return len(self._recs)


ring = TraceRing()


def capture(ctx: Optional[TraceCtx], outcome: str, **fields: Any) -> None:
    """Snapshot a finished (or shed) request into the ring.  Cheap no-op
    when tracing is off or the request was admitted without a context."""
    if ctx is None:
        return
    rec: Dict[str, Any] = {
        "trace_id": ctx.trace_id,
        "kind": ctx.kind,
        "outcome": outcome,
        "elapsed_s": ctx.elapsed(),
        "meta": dict(ctx.meta),
        "spans": list(ctx.spans),
    }
    rec.update(fields)
    ring.put(rec)


def set_enabled(flag: bool) -> None:
    global enabled
    enabled = bool(flag)
