"""Structured spans for the block pipeline (the tracing half of the
observability layer); counterpart of coreth_tpu/metrics/spans.py.

Design constraints, in order:

1. Near-zero cost when disabled. `span(...)` is a module function that
   checks ONE module-level bool and returns a shared null context
   manager — no allocation, no lock, no clock read.
2. Thread-safe with context propagation. Each thread carries its own
   stack of open spans (threading.local); entering a span parents it
   under the thread's current top. Finished spans land in one bounded
   ring shared across threads, guarded by a lock.
3. Exportable. `chrome_trace()` renders the ring as Chrome trace-event
   JSON ("X" complete events, microsecond ts/dur) — loadable directly
   in Perfetto / chrome://tracing.

Enable per-process with set_enabled(True) or the CORETH_TPU_SPANS=1
environment override.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from . import tracectx as _tracectx

# process-global fast gate: checked (unlocked) on every span() call.
# Torn reads are harmless — the worst case is one span recorded or
# skipped around the toggle instant.
enabled = os.environ.get("CORETH_TPU_SPANS", "").lower() in ("1", "true", "on")

DEFAULT_RING_SIZE = 4096


class Span:
    """One timed region. Context manager: enter starts the clock and
    pushes onto the owning thread's stack; exit pops, stamps `end`, and
    commits to the tracer ring. Only ever constructed when spans are
    enabled, so its cost is off the disabled path entirely."""

    __slots__ = ("name", "span_id", "parent_id", "start", "end",
                 "attrs", "tid", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, object]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = next(tracer._ids)
        self.parent_id: Optional[int] = None
        self.start = 0.0
        self.end = 0.0
        self.tid = 0

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        self.tid = threading.get_ident()
        stack = self._tracer._stack()
        if stack:
            self.parent_id = stack[-1].span_id
        else:
            # lane handoff: a root span on a worker thread inherits its
            # parent from the ambient trace context captured at admission,
            # so parenting survives the thread boundary
            ctx = _tracectx.current()
            if ctx is not None:
                self.parent_id = ctx.parent_span_id
                self.attrs.setdefault("trace_id", ctx.trace_id)
        stack.append(self)
        self.start = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end = time.monotonic()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        stack = self._tracer._stack()
        # pop by identity: an unbalanced exit (generator abandoned
        # mid-span, etc.) must not corrupt siblings
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        self._tracer._commit(self)
        ctx = _tracectx.current()
        if ctx is not None:
            ctx.add_span({
                "name": self.name,
                "span_id": self.span_id,
                "parent_id": self.parent_id,
                "start_s": self.start,
                "duration_s": self.duration(),
                "tid": self.tid,
                "attrs": {k: v for k, v in self.attrs.items()
                          if k != "trace_id"},
            })
        return False

    def duration(self) -> float:
        return max(0.0, self.end - self.start)


class Tracer:
    """Owns the finished-span ring and the per-thread open-span stacks."""

    def __init__(self, capacity: int = DEFAULT_RING_SIZE):
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._ids = itertools.count(1)
        self._t0 = time.monotonic()  # export epoch

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def _commit(self, span: Span) -> None:
        with self._lock:
            self._ring.append(span)

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def current(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._ring = deque(self._ring, maxlen=max(1, int(capacity)))

    def capacity(self) -> int:
        with self._lock:
            return self._ring.maxlen or 0

    def snapshot(self, clear: bool = False) -> List[Span]:
        with self._lock:
            spans = list(self._ring)
            if clear:
                self._ring.clear()
        return spans

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def chrome_trace(self, clear: bool = False) -> dict:
        """Chrome trace-event JSON: {"traceEvents": [...]} with "X"
        (complete) events, ts/dur in microseconds relative to tracer
        construction. Loadable in Perfetto / chrome://tracing."""
        events = []
        for s in self.snapshot(clear=clear):
            args = dict(s.attrs)
            args["span_id"] = s.span_id
            if s.parent_id is not None:
                args["parent_id"] = s.parent_id
            events.append({
                "name": s.name,
                "cat": s.name.split("/", 1)[0],
                "ph": "X",
                "ts": (s.start - self._t0) * 1e6,
                "dur": s.duration() * 1e6,
                "pid": 0,
                "tid": s.tid,
                "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}


# default tracer (mirrors metrics.default_registry)
tracer = Tracer()


class _NullSpan:
    """Shared no-op context manager returned when spans are disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def set_attr(self, key: str, value) -> None:
        pass


_NULL_SPAN = _NullSpan()


def span(name: str, **attrs):
    """THE instrumentation entry point: `with span("chain/verify"): ...`.
    One bool check when disabled; a real parented Span when enabled."""
    if not enabled:
        return _NULL_SPAN
    return tracer.span(name, **attrs)


def set_enabled(flag: bool) -> None:
    global enabled
    enabled = bool(flag)
