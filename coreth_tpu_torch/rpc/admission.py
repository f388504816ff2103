"""Admission control for the RPC tier; counterpart of
coreth_tpu/rpc/admission.py.

The serving model is the standard load-shedding ladder:

    admission (bounded queue, shed -32005)
      -> deadline (cooperative Deadline token, timeout -32000)
        -> breaker (consecutive expensive timeouts open it; probes close)
          -> drain (stop() bounded by rpc-drain-timeout, abandons loudly)

Two independent lanes — *cheap* and *expensive* (`eth_call`,
`eth_getLogs`, `debug_trace*`, ...) — each a fixed worker pool fed by a
bounded queue, so a storm of tracing can never starve `eth_blockNumber`.
A full queue sheds immediately with JSON-RPC `-32005 limit exceeded`
(HTTP 429 + Retry-After at the transport): under saturation the server
answers fast with "no" instead of queuing unboundedly and answering
slowly with "maybe".

The circuit breaker is *count-based*, not clock-based, mirroring the
device ladder's demote/probe/re-promote shape (ops/device.py): K
consecutive expensive-lane timeouts open it; while open every Nth
arrival is admitted as a probe; M consecutive probe successes close it.
Arrival-clocked state means overload drills replay deterministically.

Everything lives behind a `ServingPolicy` built from vm/config knobs;
an `RPCServer` without a policy dispatches inline exactly as before.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..metrics import default_registry
from ..metrics import tracectx
from ..utils.deadline import Deadline, DeadlineExceeded, scope as deadline_scope

__all__ = [
    "ABANDONED", "LIMIT_EXCEEDED", "TIMEOUT_ERROR", "CircuitBreaker",
    "Shed", "ServingPolicy", "WorkerPool", "is_expensive",
    "Deadline", "DeadlineExceeded", "deadline_scope",
]

# Sentinel future value for requests a drain gave up on: waiters check
# identity and answer their client with a shutdown error. First-set-wins
# futures make this safe even if the worker finishes later.
ABANDONED = object()

# JSON-RPC error codes the overload ladder speaks: -32005 is the
# conventional "limit exceeded" code (infura/geth rate-cap replies);
# -32000 is the generic server-error band used for deadline expiry and
# draining rejections.
LIMIT_EXCEEDED = -32005
TIMEOUT_ERROR = -32000

# Methods whose cost is unbounded in the request (state re-execution,
# multi-block scans). They dispatch on the expensive lane so their
# concurrency budget is independent of the cheap read path.
EXPENSIVE_METHODS = frozenset({
    "eth_call", "eth_callDetailed", "eth_estimateGas",
    "eth_createAccessList", "eth_getLogs", "eth_getProof",
    "eth_feeHistory",
})
EXPENSIVE_PREFIXES = (
    "debug_trace", "debug_dump", "debug_accountRange",
    "debug_storageRangeAt", "debug_getModifiedAccounts",
)

# Namespaces whose handlers honor deadline checkpoints. Operator/consensus
# surfaces (admin_importChain inserts blocks; avax_issueTx crosses into
# shared memory) must never be aborted mid-mutation by a read budget.
DEADLINE_NAMESPACES = ("eth_", "debug_", "personal_", "txpool_", "web3_",
                       "net_", "health_")


def is_expensive(method: str) -> bool:
    return (method in EXPENSIVE_METHODS
            or method.startswith(EXPENSIVE_PREFIXES))


class Shed(Exception):
    """Raised at submit time when a request cannot be admitted.
    `reason` is the metrics suffix: queue_full | breaker | draining."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


class _Future:
    """Single-slot result holder; first set wins (a drain can answer a
    future whose worker later completes — the late result is dropped)."""

    __slots__ = ("_ev", "_value", "_lock")

    def __init__(self):
        self._ev = threading.Event()
        self._value = None
        self._lock = threading.Lock()

    def set(self, value) -> bool:
        with self._lock:
            if self._ev.is_set():
                return False
            self._value = value
            self._ev.set()
            return True

    def wait(self, timeout: Optional[float]):
        """-> (completed, value)."""
        if self._ev.wait(timeout):
            return True, self._value
        return False, None


class WorkerPool:
    """Fixed worker threads fed by a bounded admission queue.

    Workers spawn lazily on first submit (a server that only ever
    dispatches inline never owns threads). `drain()` stops admission,
    waits for in-flight + queued work on a Condition (no sleep-polling —
    SA006), then answers whatever is left with an error and reports it.
    """

    def __init__(self, name: str, workers: int, queue_size: int):
        self.name = name
        self.workers = workers
        # maxsize=0 means *unbounded* for queue.Queue — never allow it
        # here; the bounded queue IS the admission control (SA007).
        self._q: "queue.Queue[Optional[tuple]]" = queue.Queue(
            maxsize=max(1, queue_size))
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._spawned = 0
        self._threads: List[threading.Thread] = []
        self._inflight = 0
        # worker thread id -> (method, future): drain answers these
        self._active: Dict[int, Tuple[str, _Future]] = {}
        self._draining = False
        self._g_queue = default_registry.gauge(f"rpc/queue/{name}")
        self._g_inflight = default_registry.gauge(f"rpc/inflight/{name}")

    def submit(self, method: str, fn: Callable[[], object]) -> _Future:
        fut = _Future()
        # capture the admitting thread's trace context so the worker
        # thread that eventually runs fn inherits it (lane handoff)
        ctx = tracectx.current()
        with self._lock:
            if self._draining:
                raise Shed("draining", "server is draining")
            if self._spawned < self.workers:
                self._spawned += 1
                t = threading.Thread(target=self._loop, daemon=True,
                                     name=f"rpc-{self.name}-{self._spawned}")
                self._threads.append(t)
                t.start()
        try:
            self._q.put_nowait((method, fn, fut, ctx))
        except queue.Full:
            raise Shed(
                "queue_full",
                f"{self.name} lane at capacity "
                f"({self.workers} workers, {self._q.maxsize} queued)")
        if ctx is not None:
            ctx.meta["lane"] = self.name
            ctx.meta["queued_behind"] = self._q.qsize() - 1
        self._g_queue.update(self._q.qsize())
        return fut

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            method, fn, fut, ctx = item
            tid = threading.get_ident()
            with self._lock:
                self._inflight += 1
                self._active[tid] = (method, fut)
            self._g_queue.update(self._q.qsize())
            self._g_inflight.update(self._inflight)
            try:
                with tracectx.scope(ctx):
                    fut.set(fn())
            finally:
                with self._lock:
                    self._inflight -= 1
                    self._active.pop(tid, None)
                    if self._inflight == 0 and self._q.empty():
                        self._idle.notify_all()
                self._g_inflight.update(self._inflight)

    def busy(self) -> int:
        with self._lock:
            return self._inflight + self._q.qsize()

    def status(self) -> dict:
        with self._lock:
            return {
                "workers": self.workers,
                "queue_depth": self._q.qsize(),
                "queue_capacity": self._q.maxsize,
                "inflight": self._inflight,
                "active": sorted(m for m, _f in self._active.values()),
                "draining": self._draining,
            }

    def drain(self, timeout: float) -> Tuple[bool, List[str]]:
        """Stop admission, wait up to [timeout]s for quiescence, then
        answer leftovers with the ABANDONED sentinel so their waiters
        unblock deterministically. -> (clean, abandoned method names:
        still-running workers + never-started queue items)."""
        with self._lock:
            self._draining = True
            self._idle.wait_for(
                lambda: self._inflight == 0 and self._q.empty(),
                timeout=timeout)
            stuck = sorted(self._active.values(), key=lambda mf: mf[0])
        abandoned = []
        for method, fut in stuck:  # unblock waiters on wedged workers
            abandoned.append(method)
            fut.set(ABANDONED)
        while True:  # answer queued-but-never-started requests
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            method, _fn, fut, _ctx = item
            abandoned.append(method)
            fut.set(ABANDONED)
        for _ in range(self._spawned):  # release parked workers
            try:
                self._q.put_nowait(None)
            except queue.Full:
                break
        if not stuck:  # a released worker ends at once: leave none behind
            for t in self._threads:
                if t is not threading.current_thread():
                    t.join(timeout=1.0)
        self._g_queue.update(0)
        return (not abandoned), abandoned


class CircuitBreaker:
    """Expensive-lane breaker, arrival-clocked for determinism.

    CLOSED --threshold consecutive timeouts--> OPEN
    OPEN: sheds; every probe_every-th arrival admitted as a probe
    OPEN --close_after consecutive probe passes--> CLOSED
    (a probe timeout resets the pass streak: stays OPEN)
    """

    def __init__(self, threshold: int, probe_every: int, close_after: int):
        self.threshold = threshold
        self.probe_every = max(1, probe_every)
        self.close_after = max(1, close_after)
        self._lock = threading.Lock()
        self._open = False
        self._consecutive_timeouts = 0
        self._probe_passes = 0
        self._arrivals_while_open = 0
        self._g_state = default_registry.gauge("rpc/breaker/state")
        self._c_opens = default_registry.counter("rpc/breaker/opens")
        self._c_closes = default_registry.counter("rpc/breaker/closes")
        self._g_state.update(0)

    def admit(self) -> str:
        """-> 'admit' | 'probe' | 'shed' for one expensive arrival."""
        if self.threshold <= 0:
            return "admit"
        with self._lock:
            if not self._open:
                return "admit"
            self._arrivals_while_open += 1
            if self._arrivals_while_open % self.probe_every == 0:
                return "probe"
            return "shed"

    def record(self, timed_out: bool, probe: bool) -> None:
        """Outcome of an admitted (or probed) expensive request."""
        if self.threshold <= 0:
            return
        with self._lock:
            if timed_out:
                self._probe_passes = 0
                if not self._open:
                    self._consecutive_timeouts += 1
                    if self._consecutive_timeouts >= self.threshold:
                        self._open = True
                        self._arrivals_while_open = 0
                        self._c_opens.inc()
                        self._g_state.update(1)
                return
            if self._open:
                if probe:
                    self._probe_passes += 1
                    if self._probe_passes >= self.close_after:
                        self._open = False
                        self._consecutive_timeouts = 0
                        self._probe_passes = 0
                        self._c_closes.inc()
                        self._g_state.update(0)
            else:
                self._consecutive_timeouts = 0

    def is_open(self) -> bool:
        with self._lock:
            return self._open

    def status(self) -> dict:
        with self._lock:
            return {
                "state": "open" if self._open else "closed",
                "threshold": self.threshold,
                "consecutive_timeouts": self._consecutive_timeouts,
                "probe_passes": self._probe_passes,
                "probe_every": self.probe_every,
                "close_after": self.close_after,
            }


class ServingPolicy:
    """All overload knobs in one object, owned by an RPCServer.

    rpc-max-workers = 0 disables pooling entirely (inline dispatch, no
    shedding, no breaker) — the bare-RPCServer/unit-test shape. Deadline
    budgets and batch/body caps still apply when set.
    """

    def __init__(self, *,
                 max_workers: int = 8,
                 queue_size: int = 64,
                 expensive_workers: int = 4,
                 expensive_queue_size: int = 16,
                 cheap_budget: float = 0.0,
                 expensive_budget: float = 0.0,
                 batch_limit: int = 100,
                 body_limit: int = 5 * 1024 * 1024,
                 breaker_threshold: int = 5,
                 breaker_probe_every: int = 8,
                 breaker_close_after: int = 3,
                 drain_timeout: float = 5.0,
                 max_connections: int = 128,
                 ws_notify_queue_size: int = 256,
                 slo_budget: float = 1.0):
        self.max_workers = max_workers
        self.cheap_budget = cheap_budget
        self.expensive_budget = expensive_budget or cheap_budget
        # completions slower than this (seconds) are auto-captured into
        # the trace ring even though they succeeded; 0 disables
        self.slo_budget = slo_budget
        self.batch_limit = batch_limit
        self.body_limit = body_limit
        self.drain_timeout = drain_timeout
        self.max_connections = max_connections
        self.ws_notify_queue_size = ws_notify_queue_size
        self.breaker = CircuitBreaker(
            breaker_threshold, breaker_probe_every, breaker_close_after)
        if max_workers > 0:
            self.cheap_pool: Optional[WorkerPool] = WorkerPool(
                "cheap", max_workers, queue_size)
            self.expensive_pool: Optional[WorkerPool] = WorkerPool(
                "expensive", expensive_workers, expensive_queue_size)
        else:
            self.cheap_pool = None
            self.expensive_pool = None
        self._drained = False

    @classmethod
    def from_config(cls, cfg) -> "ServingPolicy":
        """Build from a vm.config.Config (kebab-case knobs, defaults in
        the dataclass)."""
        return cls(
            max_workers=cfg.rpc_max_workers,
            queue_size=cfg.rpc_queue_size,
            expensive_workers=cfg.rpc_expensive_workers,
            expensive_queue_size=cfg.rpc_expensive_queue_size,
            cheap_budget=cfg.api_max_duration,
            expensive_budget=cfg.rpc_expensive_duration,
            batch_limit=cfg.rpc_batch_limit,
            body_limit=cfg.rpc_body_limit,
            breaker_threshold=cfg.rpc_breaker_threshold,
            breaker_probe_every=cfg.rpc_breaker_probe_every,
            breaker_close_after=cfg.rpc_breaker_close_after,
            drain_timeout=cfg.rpc_drain_timeout,
            max_connections=cfg.rpc_max_connections,
            ws_notify_queue_size=cfg.ws_notify_queue_size,
            slo_budget=cfg.rpc_slo_budget,
        )

    # --- dispatch helpers -------------------------------------------------

    def lane(self, method: str) -> Optional[WorkerPool]:
        if self.cheap_pool is None:
            return None
        return (self.expensive_pool if is_expensive(method)
                else self.cheap_pool)

    def budget_for(self, method: str) -> float:
        """Per-method deadline budget in seconds; 0 = no deadline."""
        if not method.startswith(DEADLINE_NAMESPACES):
            return 0.0
        return (self.expensive_budget if is_expensive(method)
                else self.cheap_budget)

    def status(self) -> dict:
        out = {
            "pooled": self.cheap_pool is not None,
            "breaker": self.breaker.status(),
            "batch_limit": self.batch_limit,
            "body_limit": self.body_limit,
            "cheap_budget": self.cheap_budget,
            "expensive_budget": self.expensive_budget,
            "slo_budget": self.slo_budget,
            "drain_timeout": self.drain_timeout,
            "drained": self._drained,
        }
        if self.cheap_pool is not None:
            out["cheap"] = self.cheap_pool.status()
            out["expensive"] = self.expensive_pool.status()
        return out

    def drain(self, timeout: Optional[float] = None) -> dict:
        """Drain both lanes; idempotent. -> report dict."""
        if self._drained:
            return {"drained": True, "abandoned": 0, "abandoned_methods": []}
        self._drained = True
        budget = self.drain_timeout if timeout is None else timeout
        deadline = Deadline(budget)  # ONE budget across both lanes
        abandoned: List[str] = []
        clean = True
        for pool in (self.cheap_pool, self.expensive_pool):
            if pool is None:
                continue
            ok, left = pool.drain(max(0.0, deadline.remaining()))
            clean = clean and ok
            abandoned.extend(left)
        if abandoned:
            default_registry.counter("rpc/abandoned").inc(len(abandoned))
        return {"drained": clean, "abandoned": len(abandoned),
                "abandoned_methods": abandoned}
