"""Continuous sampling profiler — stdlib-only wall-clock attribution;
counterpart of coreth_tpu/metrics/profiler.py.

A daemon thread walks `sys._current_frames()` at `profiler-hz` and folds
each thread's stack into a bounded collapsed-stack table keyed by
thread-ROLE (rpc lane, pipeline commit worker, insert tail, acceptor,
shard driver, ...).  Samples taken while the sampled thread holds a
canonical lock (per the `LockOrderWitness` held-stack mirror) get
the lock appended as a synthetic leaf frame, so a flamegraph renders
"time under chainmu" as its own tower.  `debug_profileDump` serves the
table as flamegraph-ready collapsed text plus JSON; per-role sample
counts land on /metrics as the `profile/samples/<role>` family.

Design constraints, in order:

* The sampler must NEVER throw into the workload: every tick is fenced,
  failures count `profile/sampler_errors` and the loop keeps going.
* Overhead stays small: the per-tick work is one
  `sys._current_frames()` call, a dict mirror read, and string folds —
  no locks shared with the workload, no allocation on the workload side.
* Deterministic unit-testing: the frame walk, the thread-name map and
  the held-lock mirror are injectable (`frames_fn` / `threads_fn` /
  `locks_fn`), so tests drive `sample_once()` with synthetic frames and
  never depend on scheduler timing.
"""

from __future__ import annotations

import os.path
import sys
import threading
from typing import Callable, Dict, List, Optional, Tuple

from . import count_drop, default_registry

# thread-name prefix -> role; first match wins, order = specificity.
# These mirror the names the runtime actually assigns (rpc/admission.py
# lanes, core/insert_pipeline.py commit worker, core/blockchain.py tail
# worker + acceptor, core/exec_shards.py shard drivers, ...).
_ROLE_PREFIXES: Tuple[Tuple[str, str], ...] = (
    ("rpc-", "rpc"),
    ("insert-pipeline", "commit"),
    ("insert-tail", "tail"),
    ("acceptor", "acceptor"),
    ("shard-drive-", "shard"),
    ("parallel-exec-", "exec"),
    ("wd-", "watchdog"),
    ("MainThread", "main"),
)

SAMPLER_THREAD_NAME = "profile-sampler"


def role_for_thread_name(name: str) -> str:
    for prefix, role in _ROLE_PREFIXES:
        if name.startswith(prefix):
            return role
    return "other"


def _default_threads_fn() -> Dict[int, str]:
    return {t.ident: t.name for t in threading.enumerate()
            if t.ident is not None}


def _default_locks_fn() -> Dict[int, Tuple[str, ...]]:
    from ..utils.racecheck import held_locks_snapshot
    return held_locks_snapshot()


def fold_stack(frame, limit: int = 64) -> str:
    """Collapse a frame chain into `root;...;leaf` (flamegraph input
    grammar: semicolon-joined frames, spaces reserved for the count)."""
    parts: List[str] = []
    depth = 0
    while frame is not None and depth < limit:
        code = frame.f_code
        parts.append("%s:%s" % (
            os.path.basename(code.co_filename).replace(" ", "_"),
            code.co_name.replace(" ", "_")))
        frame = frame.f_back
        depth += 1
    parts.reverse()
    return ";".join(parts)


class Profiler:
    """Bounded collapsed-stack sampler; one instance per process."""

    def __init__(self, hz: float = 25.0, ring_size: int = 2048,
                 frames_fn: Optional[Callable[[], Dict]] = None,
                 threads_fn: Optional[Callable[[], Dict[int, str]]] = None,
                 locks_fn: Optional[
                     Callable[[], Dict[int, Tuple[str, ...]]]] = None):
        self.hz = float(hz)
        self.ring_size = int(ring_size)
        self._frames_fn = frames_fn or sys._current_frames
        self._threads_fn = threads_fn or _default_threads_fn
        self._locks_fn = locks_fn or _default_locks_fn
        # (role, collapsed-stack) -> sample count; bounded at ring_size
        # distinct keys, overflow folds into a per-role "(overflow)" row
        self._table: Dict[Tuple[str, str], int] = {}
        self._mu = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples_total = 0
        self.overflowed = 0
        # pre-bound instruments (never constructed on the tick path)
        self._c_errors = default_registry.counter("profile/sampler_errors")
        self._c_roles: Dict[str, object] = {}

    # -- sampling --------------------------------------------------------

    def _role_counter(self, role: str):
        c = self._c_roles.get(role)
        if c is None:
            c = default_registry.counter("profile/samples/%s" % role)
            self._c_roles[role] = c
        return c

    def sample_once(self) -> int:
        """Take one sample of every thread except the sampler itself;
        returns the number of stacks folded.  Deterministic under
        injected frames_fn/threads_fn/locks_fn."""
        frames = self._frames_fn()
        names = self._threads_fn()
        held = self._locks_fn()
        me = threading.get_ident()
        folded = 0
        for ident, frame in frames.items():
            if ident == me:
                continue
            role = role_for_thread_name(names.get(ident, "?"))
            stack = fold_stack(frame)
            locks = held.get(ident)
            if locks:
                # synthetic leaf frame: time-under-lock becomes its own
                # flamegraph tower without a second table dimension
                stack = "%s;<lock:%s>" % (stack, ",".join(
                    dict.fromkeys(locks)))
            key = (role, stack)
            with self._mu:
                if key in self._table:
                    self._table[key] += 1
                elif len(self._table) < self.ring_size:
                    self._table[key] = 1
                else:
                    okey = (role, "(overflow)")
                    self._table[okey] = self._table.get(okey, 0) + 1
                    self.overflowed += 1
                    count_drop("drop/profile/table_overflow")
                self.samples_total += 1
            self._role_counter(role).inc()
            folded += 1
        return folded

    def _run(self) -> None:
        interval = 1.0 / self.hz if self.hz > 0 else 1.0
        while not self._stop_evt.wait(interval):
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 - sampler must never throw
                self._c_errors.inc()

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, name=SAMPLER_THREAD_NAME, daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 2.0) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        self._thread = None

    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- export ----------------------------------------------------------

    def collapsed(self) -> str:
        """Flamegraph-ready text: `role;frame;...;frame count` lines,
        heaviest first (stable tie-break on the key for determinism)."""
        with self._mu:
            items = sorted(self._table.items(),
                           key=lambda kv: (-kv[1], kv[0]))
        return "\n".join("%s;%s %d" % (role, stack, n)
                         for (role, stack), n in items)

    def dump(self) -> Dict[str, object]:
        with self._mu:
            items = sorted(self._table.items(),
                           key=lambda kv: (-kv[1], kv[0]))
            total = self.samples_total
            overflowed = self.overflowed
        roles: Dict[str, int] = {}
        for (role, _stack), n in items:
            roles[role] = roles.get(role, 0) + n
        return {
            "hz": self.hz,
            "ring_size": self.ring_size,
            "running": self.alive(),
            "samples_total": total,
            "distinct_stacks": len(items),
            "overflowed": overflowed,
            "roles": roles,
            "table": [
                {"role": role, "stack": stack, "count": n}
                for (role, stack), n in items
            ],
            "collapsed": self.collapsed(),
        }


# -- module singleton (vm.py wiring + debug_profileDump) -----------------
#
# The singleton is REFCOUNTED: every start_profiler() must be paired with
# one stop_profiler(), and the sampler only dies with the last holder.
# Without this, one VM's shutdown would silently kill sampling for every
# other user of the process profiler (a second VM, a test).

_profiler: Optional[Profiler] = None
_singleton_mu = threading.Lock()
_refs = 0


def start_profiler(hz: float, ring_size: int = 2048) -> Optional[Profiler]:
    """Start (or take a reference on the already-running) process
    profiler; hz <= 0 is the documented off switch and returns None.
    A differing hz never restarts a live sampler — first starter wins
    and the mismatch is logged instead of silently ignored."""
    global _profiler, _refs
    if hz <= 0:
        return None
    with _singleton_mu:
        if _profiler is None or not _profiler.alive():
            _profiler = Profiler(hz=hz, ring_size=ring_size)
            _profiler.start()
            _refs = 1
        else:
            _refs += 1
            if float(hz) != _profiler.hz:
                from ..log import get_logger, warn
                warn(get_logger("metrics"),
                     "sampling profiler already running; keeping its rate",
                     running_hz=_profiler.hz, requested_hz=float(hz))
        return _profiler


def stop_profiler() -> None:
    """Drop one start_profiler() reference; the sampler stops only when
    the last holder lets go.  A stray stop with no profiler is a no-op."""
    global _profiler, _refs
    with _singleton_mu:
        if _profiler is None:
            return
        _refs -= 1
        if _refs <= 0:
            _profiler.stop()
            _profiler = None
            _refs = 0


def get_profiler() -> Optional[Profiler]:
    return _profiler


def profile_dump() -> Dict[str, object]:
    p = _profiler
    if p is None:
        return {"running": False, "samples_total": 0, "table": [],
                "collapsed": "", "roles": {}}
    return p.dump()
