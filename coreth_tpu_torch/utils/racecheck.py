"""Race-detection harness, the test-time analog of `go test -race`, and
the lock telemetry that debug_lockStatus and the sampling profiler read;
counterpart of coreth_tpu/utils/racecheck.py.

Go's race detector instruments memory accesses; Python's GIL hides most
word-level races but NOT compound-operation races (check-then-act,
iterate-while-mutate), exactly the class the chain's locking discipline
must prevent. Three modes:

* `RaceDetector.guard(obj, methods)`: overlap detection. Any wall-clock
  overlap of two guarded calls from different threads is a violation.
* `RaceDetector.require_lock(obj, methods, lock_attr)`: lock-ownership
  detection. The named lock attribute is replaced with an owner-tracking
  proxy and every guarded method asserts on entry that the CURRENT
  thread holds that lock (strictly stronger than overlap detection: it
  catches a caller that never takes the lock even when no other thread
  happens to be inside).
* `LockOrderWitness`: acquisition-order detection. Named locks are
  swapped for proxies that keep a per-thread held stack; acquiring a
  lock ranked EARLIER in `CANONICAL_LOCK_ORDER` than one already held is
  a violation.

Every proxied lock records its acquire-wait and hold time into
lock/<name>/{wait,hold}_seconds histograms, and a hold longer than the
slow-hold budget (the lock-slow-hold-budget knob; 0 is off) captures a
traceback and trace id into a bounded ring and the configured sink. The
chaos conductor (fault/chaos.py) installs the witness over a chain; a
node that installs none answers debug_lockStatus with empty tables.

Usage:

    det = RaceDetector()
    det.guard(triedb, ["update", "commit", "dereference", "cap"])
    det.require_lock(chain, ["_write_block"], "chainmu")
    ... run concurrent chain load ...
    assert det.violations == []
"""

from __future__ import annotations

import functools
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from ..metrics import (
    DEFAULT_SLO_BUCKETS,
    count_drop,
    default_registry,
    sanitize_metric_name,
)

# The canonical single-process lock order, outermost first: the
# linearisation of the may-acquire graph restricted to the locks the
# chain's write/serve paths actually nest (the reference's static
# analyzer derives that graph; the witness checks real executions
# against the same order).
#
# Notes on placement:
#  * BlockChain._degraded_mu has no static edge ordering it against
#    chainmu (the tail worker takes it bare); it sits after the chainmu
#    cluster because VM._build_block_inner's closure may take it while
#    VM.lock is held.
#  * InsertPipeline._mu never nests with chainmu by design (the commit
#    worker drains its queue BEFORE entering chainmu); listing both
#    still lets the witness catch a regression that nests them the
#    wrong way around.
CANONICAL_LOCK_ORDER: Tuple[str, ...] = (
    "VMServer._lock",
    "BlockBuilder.lock",
    "VM.lock",
    "BlockChain.chainmu",
    "BlockChain._acceptor_tip_lock",
    "BlockChain._insert_recs_mu",
    "BlockChain._view_mu",
    "BlockChain._degraded_mu",
    "InsertPipeline._mu",
    "TxPool.mu",
    "Registry._lock",
    "Tree.lock",
)


# --------------------------------------------------------------------------
# lock-contention telemetry: every wrapped canonical lock records
# acquire-wait and hold time into lock/<name>/{wait,hold}_seconds SLO
# histograms, and holds longer than the slow-hold budget capture a
# traceback + trace id into the configured sink (the chain's flight
# recorder, wired by the chaos conductor).  Instruments are pre-bound
# per canonical name at wrap time, never constructed on the acquire
# path.

# seconds a single hold may last before it is captured; 0 disables
_slow_hold_budget: float = 0.0
# callable(dict) fed one event per budget breach (flight.note_event shape)
_slow_hold_sink = None
# bounded ring of recent breaches for debug_lockStatus (sink-less runs)
_recent_slow_holds: deque = deque(maxlen=32)

# pre-bound at import, like the per-lock histograms: the breach path must
# never construct instruments — default_registry.counter() acquires
# Registry._lock, which the chaos conductor witness-wraps, so a lazy bind
# during a slow hold OF Registry._lock would re-acquire the still-held
# non-reentrant inner lock on the same thread and deadlock
_c_slow_holds = default_registry.counter("lock/slow_holds")


def set_slow_hold_budget(seconds: float) -> None:
    global _slow_hold_budget
    _slow_hold_budget = max(0.0, float(seconds))


def slow_hold_budget() -> float:
    return _slow_hold_budget


def set_slow_hold_sink(sink) -> None:
    """Install the slow-hold event consumer (None disconnects). The sink
    must be cheap and non-raising; a raising sink only counts a drop."""
    global _slow_hold_sink
    _slow_hold_sink = sink


class _LockTelemetry:
    """Per-canonical-lock wait/hold histograms, created once per name."""

    __slots__ = ("name", "wait", "hold")

    def __init__(self, name: str):
        self.name = name
        self.wait = default_registry.histogram(
            f"lock/{name}/wait_seconds", buckets=DEFAULT_SLO_BUCKETS)
        self.hold = default_registry.histogram(
            f"lock/{name}/hold_seconds", buckets=DEFAULT_SLO_BUCKETS)


_telemetry_mu = threading.Lock()
_telemetry: Dict[str, _LockTelemetry] = {}
# sanitized exposition family -> canonical lock name: the exposition
# flattens `/`, `.` and `:` to `_`, and this mapping is what keeps the
# flattening invertible (the round-trip test asserts injectivity over
# CANONICAL_LOCK_ORDER plus the module-lock `module:NAME` form)
_family_to_canonical: Dict[str, str] = {}


def lock_telemetry(name: str) -> _LockTelemetry:
    with _telemetry_mu:
        tele = _telemetry.get(name)
        if tele is None:
            tele = _LockTelemetry(name)
            _telemetry[name] = tele
            for kind in ("wait", "hold"):
                fam = sanitize_metric_name(f"lock/{name}/{kind}_seconds")
                _family_to_canonical[fam] = name
        return tele


def canonical_for_family(family: str) -> Optional[str]:
    """Invert the exposition flattening: sanitized `lock_*_{wait,hold}_
    seconds` family name -> canonical lock name."""
    with _telemetry_mu:
        return _family_to_canonical.get(family)


def contention_table() -> List[Dict[str, object]]:
    """The debug_lockStatus payload: one row per instrumented lock,
    ranked by total measured acquire-wait (descending)."""
    with _telemetry_mu:
        items = list(_telemetry.items())
    rows = []
    for name, tele in items:
        rows.append({
            "lock": name,
            "wait_count": tele.wait.count(),
            "wait_total_seconds": tele.wait.sum(),
            "wait_p99_seconds": tele.wait.percentile(0.99),
            "hold_count": tele.hold.count(),
            "hold_total_seconds": tele.hold.sum(),
            "hold_p99_seconds": tele.hold.percentile(0.99),
        })
    rows.sort(key=lambda r: r["wait_total_seconds"], reverse=True)
    return rows


def recent_slow_holds() -> List[Dict[str, object]]:
    return list(_recent_slow_holds)


def _note_slow_hold(name: str, held_s: float) -> None:
    """Record one budget breach.  Callers MUST invoke this only AFTER the
    slow lock has been released: the sink may take arbitrary locks (the
    flight recorder does), and running it while the slow lock is still
    held would at best record spurious lock-order edges in the witness
    and at worst deadlock (a slow hold of Registry._lock meeting any
    registry access here)."""
    import traceback

    from ..metrics import tracectx

    _c_slow_holds.inc()
    ev = {
        "lock": name,
        "held_seconds": held_s,
        "budget_seconds": _slow_hold_budget,
        "thread": threading.current_thread().name,
        "trace_id": tracectx.current_id(),
        "stack": "".join(traceback.format_stack(limit=12)),
    }
    _recent_slow_holds.append(ev)
    sink = _slow_hold_sink
    if sink is not None:
        try:
            sink(ev)
        except Exception:  # noqa: BLE001 - telemetry must not raise into holders
            count_drop("drop/lock/slow_hold_sink")


class _OwnedLock:
    """Proxy around a Lock/RLock that records which thread holds it.

    Only the acquire/release surface is intercepted; everything else
    delegates to the wrapped lock, so Conditions built on it and direct
    `acquire(timeout=...)` callers keep working.  Reentrant acquisition
    is counted so RLock owners stay owners until the outermost release.
    """

    def __init__(self, inner, name: Optional[str] = None):
        self._inner = inner
        self._owner: int | None = None
        self._count = 0
        self._tele = lock_telemetry(name) if name else None
        self._hold_t0 = 0.0

    def acquire(self, *a, **kw):
        if self._tele is None:
            got = self._inner.acquire(*a, **kw)
        else:
            t0 = time.monotonic()
            got = self._inner.acquire(*a, **kw)
            if got:
                self._tele.wait.update(time.monotonic() - t0)
        if got:
            self._owner = threading.get_ident()
            self._count += 1
            if self._count == 1:
                self._hold_t0 = time.monotonic()
        return got

    def release(self):
        slow = 0.0
        if self._count > 0:
            self._count -= 1
            if self._count == 0:
                self._owner = None
                if self._tele is not None:
                    held = time.monotonic() - self._hold_t0
                    self._tele.hold.update(held)
                    if 0.0 < _slow_hold_budget <= held:
                        slow = held
        self._inner.release()
        if slow > 0.0:  # deferred past release — see _note_slow_hold
            _note_slow_hold(self._tele.name, slow)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def held_by_me(self) -> bool:
        return self._owner == threading.get_ident()

    def locked(self):
        return self._inner.locked()

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _WitnessLock:
    """Proxy that reports acquire/release to a LockOrderWitness.

    Same delegation contract as `_OwnedLock`: only acquire/release (and
    the context-manager surface) are intercepted; `locked()`, timeouts
    and everything else pass through.  A failed `acquire(blocking=False)`
    is NOT reported — only actual possession enters the held stack.
    """

    def __init__(self, inner, name: str, witness: "LockOrderWitness"):
        self._inner = inner
        self._name = name
        self._witness = witness
        self._tele = lock_telemetry(name)
        # ownership-tracked depth on the PROXY (like _OwnedLock), not
        # threading.local: a plain Lock acquired on one thread and
        # released on another (legal, signal-style module locks) must
        # still close its hold span.  Re-entrant RLock holds time the
        # OUTERMOST span, matching what a contending thread experiences.
        self._owner: int | None = None
        self._count = 0
        self._hold_t0 = 0.0

    def acquire(self, *a, **kw):
        t0 = time.monotonic()
        got = self._inner.acquire(*a, **kw)
        if got:
            now = time.monotonic()
            self._tele.wait.update(now - t0)
            self._owner = threading.get_ident()
            self._count += 1
            if self._count == 1:
                self._hold_t0 = now
            self._witness._note_acquire(self._name)
        return got

    def release(self):
        slow = 0.0
        if self._count > 0:
            self._count -= 1
            if self._count == 0:
                self._owner = None
                held = time.monotonic() - self._hold_t0
                self._tele.hold.update(held)
                if 0.0 < _slow_hold_budget <= held:
                    slow = held
        self._inner.release()
        self._witness._note_release(self._name)
        if slow > 0.0:  # deferred past release — see _note_slow_hold
            _note_slow_hold(self._name, slow)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    def __getattr__(self, name):
        return getattr(self._inner, name)


class LockOrderWitness:
    """Runtime lock-order recorder + checker.

    `wrap(obj, attr, name)` swaps [obj].[attr] for a `_WitnessLock`
    whose canonical [name] matches the static analyzer's `Owner.attr`
    naming.  Each thread keeps a stack of held lock names; on every
    acquisition the witness

      * records an observed edge (held -> acquired) for each lock the
        thread already holds (re-entrant re-acquisition of the same
        name is skipped — chainmu is an RLock), and
      * flags a violation if the acquired lock is ranked EARLIER in the
        canonical order than any held lock.  Locks absent from the
        order are recorded (the edge set is still useful triage) but
        never flagged, so partially instrumented runs stay quiet.

    Known blind spots: a `threading.Condition` constructed on a lock
    BEFORE the wrap keeps a reference to the raw inner lock, so waits/
    notifies through the condition bypass the proxy.  None of the locks
    in `CANONICAL_LOCK_ORDER` back a Condition today; the chaos
    conductor wraps at boot, right after construction, to keep it that
    way.  And while hold TIMING survives a cross-thread release (the
    proxy tracks depth by ownership, not thread), the per-thread held
    STACKS here do not: a lock released by a thread that never acquired
    it stays on the acquirer's stack, so signal-style locks should not
    be witness-wrapped where order checking matters.
    """

    def __init__(self, order: Sequence[str] = CANONICAL_LOCK_ORDER):
        self._rank = {name: i for i, name in enumerate(order)}
        self.violations: List[str] = []
        # observed (outer, inner) pairs, for edge-set assertions in tests
        self.edges: set = set()
        self._meta = threading.Lock()
        self._held = threading.local()
        # cross-thread-readable mirror of the per-thread held stacks:
        # ident -> tuple(names).  `threading.local` is invisible from the
        # sampling profiler's thread, so every acquire/release also
        # publishes an immutable snapshot with a single GIL-atomic dict
        # write — no lock on the acquire path.
        self._held_by_ident: Dict[int, Tuple[str, ...]] = {}
        self._wrapped: List[tuple] = []

    def wrap(self, obj, attr: str, name: Optional[str] = None):
        """Swap [obj].[attr] for a witness proxy named `Owner.attr` (or
        [name]).  Idempotent: an already-wrapped lock is left alone."""
        inner = getattr(obj, attr)
        if isinstance(inner, _WitnessLock):
            return inner
        proxy = _WitnessLock(
            inner, name or f"{type(obj).__name__}.{attr}", self)
        setattr(obj, attr, proxy)
        self._wrapped.append((obj, attr, inner))
        if self not in _ACTIVE_WITNESSES:
            _ACTIVE_WITNESSES.append(self)
        return proxy

    def unwrap_all(self) -> None:
        """Restore every wrapped attribute (process-global singletons —
        the metrics registry — must not keep witness proxies after the
        harness that installed them is torn down)."""
        for obj, attr, inner in reversed(self._wrapped):
            try:
                setattr(obj, attr, inner)
            except AttributeError:
                pass
        self._wrapped.clear()
        try:
            _ACTIVE_WITNESSES.remove(self)
        except ValueError:
            pass
        self._held_by_ident.clear()

    def _stack(self) -> List[str]:
        st = getattr(self._held, "stack", None)
        if st is None:
            st = self._held.stack = []
        return st

    def _note_acquire(self, name: str) -> None:
        stack = self._stack()
        if name in stack:  # RLock re-entry: no new edge, no new rank
            stack.append(name)
            self._publish(stack)
            return
        rank = self._rank.get(name)
        with self._meta:
            for held in stack:
                if held != name:
                    self.edges.add((held, name))
            if rank is not None:
                worst = [h for h in stack
                         if self._rank.get(h, -1) > rank]
                if worst:
                    self.violations.append(
                        f"thread {threading.get_ident()} acquired {name} "
                        f"(rank {rank}) while holding "
                        f"{' -> '.join(dict.fromkeys(stack))} "
                        f"(violates canonical order via {worst[-1]})")
        stack.append(name)
        self._publish(stack)

    def _note_release(self, name: str) -> None:
        stack = self._stack()
        # release order need not mirror acquire order; drop the deepest
        # occurrence so re-entrant holds unwind correctly
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                self._publish(stack)
                return

    def _publish(self, stack: List[str]) -> None:
        ident = threading.get_ident()
        if stack:
            self._held_by_ident[ident] = tuple(stack)
        else:
            self._held_by_ident.pop(ident, None)

    def held_by_ident(self) -> Dict[int, Tuple[str, ...]]:
        """Point-in-time copy of which thread holds which witnessed
        locks; safe to call from any thread (the profiler's sampler)."""
        return dict(self._held_by_ident)


# Witnesses with live wraps, so the profiler can tag samples with the
# locks the sampled thread holds without a reference to the harness that
# installed them.  Appended on first wrap, removed in unwrap_all().
_ACTIVE_WITNESSES: List["LockOrderWitness"] = []


def held_locks_snapshot() -> Dict[int, Tuple[str, ...]]:
    """Merged ident -> held-lock-names view across all live witnesses."""
    out: Dict[int, Tuple[str, ...]] = {}
    for w in list(_ACTIVE_WITNESSES):
        for ident, names in w.held_by_ident().items():
            out[ident] = out.get(ident, ()) + names
    return out


class RaceDetector:
    def __init__(self):
        self.violations: List[str] = []
        self._meta = threading.Lock()
        # (group, thread id) -> nesting depth; "any OTHER thread with
        # depth > 0 in my group" IS the overlap condition — one source of
        # truth, so a violation can never be masked by which thread
        # happened to enter first
        self._depth: dict = {}

    def guard(self, obj, methods) -> None:
        """Wrap [methods] of [obj]; overlapping entry from two threads into
        ANY pair of them is a violation (they form one exclusion group)."""
        group = id(obj)
        for name in methods:
            orig = getattr(obj, name)
            setattr(obj, name, self._wrap(group, name, orig))

    def require_lock(self, obj, methods, lock_attr: str) -> None:
        """Assert [obj].[lock_attr] is held by the calling thread on entry
        to each of [methods].  The lock attribute is swapped for an
        owner-tracking proxy (idempotent: re-wrapping reuses the proxy),
        so the object's own `with self.<lock>` blocks keep working and
        feed the ownership record."""
        lock = getattr(obj, lock_attr)
        if not isinstance(lock, _OwnedLock):
            lock = _OwnedLock(lock, name=f"{type(obj).__name__}.{lock_attr}")
            setattr(obj, lock_attr, lock)
        for name in methods:
            orig = getattr(obj, name)
            setattr(obj, name, self._wrap_owned(name, lock_attr, lock, orig))

    def _wrap_owned(self, name, lock_attr, lock: _OwnedLock, fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            if not lock.held_by_me():
                with self._meta:
                    self.violations.append(
                        f"{name} entered by thread {threading.get_ident()} "
                        f"without holding {lock_attr}"
                    )
            return fn(*a, **kw)

        return wrapped

    def _wrap(self, group, name, fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            me = threading.get_ident()
            with self._meta:
                others = [
                    t for (g, t), d in self._depth.items()
                    if g == group and t != me and d > 0
                ]
                if others:
                    self.violations.append(
                        f"{name} entered by thread {me} while threads "
                        f"{others} hold guarded methods"
                    )
                key = (group, me)
                self._depth[key] = self._depth.get(key, 0) + 1
            try:
                return fn(*a, **kw)
            finally:
                with self._meta:
                    key = (group, me)
                    self._depth[key] -= 1
                    if self._depth[key] == 0:
                        del self._depth[key]

        return wrapped
