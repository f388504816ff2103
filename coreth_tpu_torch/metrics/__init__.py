"""Metrics registry (coreth metrics/, the go-metrics fork: counters,
gauges, meters, histograms, timers, with the EnabledExpensive gate and
Prometheus-style export); counterpart of coreth_tpu/metrics/__init__.py.

The commit pipeline's always-on phase timers (phase_timer, PhaseSeq,
phase_add) are here too: each phase is also a span (metrics/spans.py)
when spans are on, and a torch profiler range while a profiler session
runs, carried from a thread the session does not record by PhaseRelay.
The flight recorder is metrics/flight.py, the shard workers' stdlib-only
accumulator metrics/shardstats.py, the HTTP exposition metrics/http.py,
the profiler metrics/profiler.py and the exposition's command-line check
`python -m coreth_tpu_torch.metrics` (metrics/__main__.py)."""

from __future__ import annotations

import bisect
import math
import random
import re
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import spans as _spans

enabled = True
enabled_expensive = False  # metrics.EnabledExpensive gate


class Counter:
    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    def dec(self, n: int = 1) -> None:
        with self._lock:
            self._v -= n

    def count(self) -> int:
        return self._v

    def clear(self) -> None:
        with self._lock:
            self._v = 0


class Gauge:
    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def update(self, v) -> None:
        with self._lock:
            self._v = v

    def value(self):
        with self._lock:
            return self._v


# fixed latency buckets for SLO histograms (seconds); chosen to straddle
# the cheap-lane (tens of ms) and expensive-lane (seconds) budgets
DEFAULT_SLO_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                       1.0, 2.5, 5.0, 10.0)


class Histogram:
    """Sampling histogram with percentile queries.  With `buckets` set it
    additionally keeps fixed-bucket counts plus one exemplar (trace id +
    observed value) per bucket, and exports as a real Prometheus
    histogram family instead of a summary."""

    def __init__(self, reservoir: int = 1028, buckets=None):
        self._samples: List[float] = []
        self._reservoir = reservoir
        # uniform reservoir sampling by skips (Li's algorithm L): once the
        # reservoir is full, the 1-based count of the next value that
        # takes a random slot, so the values between draw nothing
        self._w = 1.0
        self._next_pick = reservoir
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()
        if buckets:
            self._buckets: Optional[Tuple[float, ...]] = tuple(
                sorted(float(b) for b in buckets))
            self._bucket_counts = [0] * len(self._buckets)
            # per finite bucket: latest (value, trace_id) landing in it
            self._exemplars: List[Optional[Tuple[float, str]]] = (
                [None] * len(self._buckets))
        else:
            self._buckets = None
            self._bucket_counts = []
            self._exemplars = []

    def update(self, v: float, exemplar: Optional[str] = None) -> None:
        with self._lock:
            self._observe(v, exemplar)

    def _observe(self, v: float, exemplar: Optional[str] = None) -> None:
        """update's body; the caller holds the lock."""
        self._count += 1
        self._sum += v
        if self._buckets is not None:
            i = bisect.bisect_left(self._buckets, v)
            if i < len(self._buckets):
                self._bucket_counts[i] += 1
                if exemplar:
                    self._exemplars[i] = (v, exemplar)
        if self._count <= self._reservoir:
            self._samples.append(v)
            if self._count == self._reservoir:
                self._skip()
        elif self._count == self._next_pick:
            self._samples[int(random.random() * self._reservoir)] = v
            self._skip()

    def _skip(self) -> None:
        k = self._reservoir
        self._w *= math.exp(math.log(1.0 - random.random()) / k)
        self._next_pick += 1 + int(
            math.log(1.0 - random.random()) / math.log1p(-self._w))

    def bucket_bounds(self) -> Optional[Tuple[float, ...]]:
        return self._buckets

    def buckets(self) -> List[Tuple[float, int]]:
        """Cumulative (upper_bound, count<=bound) pairs; the implicit
        +Inf bucket is the total count (``count()``)."""
        if self._buckets is None:
            return []
        with self._lock:
            out: List[Tuple[float, int]] = []
            cum = 0
            for le, n in zip(self._buckets, self._bucket_counts):
                cum += n
                out.append((le, cum))
            return out

    def exemplars(self) -> Dict[str, Dict[str, object]]:
        """{le_label: {"trace_id": ..., "value": ...}} for buckets that
        have captured one."""
        if self._buckets is None:
            return {}
        with self._lock:
            out: Dict[str, Dict[str, object]] = {}
            for le, ex in zip(self._buckets, self._exemplars):
                if ex is not None:
                    out[_fmt_value(le)] = {"value": ex[0], "trace_id": ex[1]}
            return out

    def count(self) -> int:
        return self._count

    def sum(self) -> float:
        """Exact cumulative sum across every update (survives reservoir
        eviction, unlike mean()*count())."""
        with self._lock:
            return self._sum

    def mean(self) -> float:
        with self._lock:
            return sum(self._samples) / len(self._samples) if self._samples else 0.0

    def percentile(self, p: float) -> float:
        with self._lock:
            if not self._samples:
                return 0.0
            s = sorted(self._samples)
            return s[min(len(s) - 1, int(len(s) * p))]

    def percentiles(self, ps) -> List[float]:
        """Batch percentile query: one sort under one lock acquisition."""
        with self._lock:
            if not self._samples:
                return [0.0 for _ in ps]
            s = sorted(self._samples)
            return [s[min(len(s) - 1, int(len(s) * p))] for p in ps]


class Meter:
    """Rate meter (events/sec with total count)."""

    def __init__(self):
        self._count = 0
        self._start = time.monotonic()
        self._lock = threading.Lock()

    def mark(self, n: int = 1) -> None:
        with self._lock:
            self._count += n

    def count(self) -> int:
        return self._count

    def rate_mean(self) -> float:
        elapsed = time.monotonic() - self._start
        return self._count / elapsed if elapsed > 0 else 0.0


class Timer:
    """Histogram of durations, their count and their exact total.

    update() only appends to a deque (thread-safe without a lock: a few
    tenths of a microsecond, so a phase timer can fire a dozen times per
    block commit); every read folds what is pending into the histogram
    and the total under the histogram's lock, as does an update that
    finds FOLD_AT values pending."""

    FOLD_AT = 256

    def __init__(self):
        self.hist = Histogram()
        self._total = 0.0
        self._pending: deque = deque()

    def update(self, seconds: float) -> None:
        p = self._pending
        p.append(seconds)
        if len(p) >= self.FOLD_AT:
            self._fold()

    def _fold(self) -> Histogram:
        h = self.hist
        p = self._pending
        with h._lock:
            while p:
                v = p.popleft()
                self._total += v
                h._observe(v)
        return h

    def time(self):
        return _TimerCtx(self)

    def count(self) -> int:
        return self._fold()._count

    def mean(self) -> float:
        return self._fold().mean()

    def percentiles(self, ps) -> List[float]:
        return self._fold().percentiles(ps)

    def total(self) -> float:
        """Exact cumulative seconds across every update (unlike
        mean()*count(), which drifts once the reservoir saturates) —
        what the bench phase-attribution report divides."""
        h = self._fold()
        with h._lock:
            return self._total


class _TimerCtx:
    __slots__ = ("_timer", "_t0")

    def __init__(self, timer: Timer):
        self._timer = timer

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *a):
        self._timer.update(time.monotonic() - self._t0)
        return False


# --- Prometheus exposition helpers ------------------------------------------

# Exposition sample names may legally contain ':' ([a-zA-Z_:][a-zA-Z0-9_:]*)
# but Prometheus reserves colons for recording rules, and registry names
# DO contain colons (the module-lock canonical form `module:NAME` feeds
# the lock/<name>/... contention families) — so the sanitizer rewrites
# them to '_' like every other separator, keeping scraped families
# recording-rule-clean and label-legal.
_NAME_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_]")

# summary quantiles exported for every Timer/Histogram
_QUANTILES = (0.5, 0.9, 0.99)
_QUANTILE_LABELS = ("0.5", "0.9", "0.99")


def sanitize_metric_name(name: str) -> str:
    """Registry names use `/`, `.` and `:` separators (go-metrics style,
    plus the module-lock canonical form); the exposition gets
    `[a-zA-Z_][a-zA-Z0-9_]*`."""
    out = _NAME_SANITIZE_RE.sub("_", name)
    if not out or not (out[0].isalpha() or out[0] == "_"):
        out = "_" + out
    return out


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if f != f:
        return "NaN"
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    return repr(f)


class Registry:
    """metrics.Registry: name → metric, lazily created."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_register(self, name: str, factory):
        m = self._metrics.get(name)  # registered once, never removed
        if m is not None:
            return m
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_register(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_register(name, Gauge)

    def histogram(self, name: str, buckets=None) -> Histogram:
        return self._get_or_register(
            name, lambda: Histogram(buckets=buckets))

    def meter(self, name: str) -> Meter:
        return self._get_or_register(name, Meter)

    def timer(self, name: str) -> Timer:
        return self._get_or_register(name, Timer)

    def each(self):
        with self._lock:
            return list(self._metrics.items())

    def export_prometheus(self) -> str:
        """Full text exposition (the avalanchego gatherer analog): every
        family gets `# HELP`/`# TYPE` lines, Timer/Histogram export as
        Prometheus summaries (p50/p90/p99 quantiles + exact `_sum` and
        `_count`), and names are sanitized to the legal charset. The
        output parses under any Prometheus scraper."""
        lines: List[str] = []

        def family(fam: str, kind: str, help_text: str,
                   samples: List[Tuple[str, tuple, object]]) -> None:
            lines.append(f"# HELP {fam} {help_text}")
            lines.append(f"# TYPE {fam} {kind}")
            for sname, labels, value in samples:
                if labels:
                    lab = ",".join(f'{k}="{v}"' for k, v in labels)
                    lines.append(f"{sname}{{{lab}}} {_fmt_value(value)}")
                else:
                    lines.append(f"{sname} {_fmt_value(value)}")

        def summary(fam: str, help_text: str, quantiles: List[float],
                    total: float, count: int) -> None:
            samples: List[Tuple[str, tuple, object]] = [
                (fam, (("quantile", _QUANTILE_LABELS[i]),), q)
                for i, q in enumerate(quantiles)
            ]
            samples.append((fam + "_sum", (), total))
            samples.append((fam + "_count", (), count))
            family(fam, "summary", help_text, samples)

        for name, m in sorted(self.each()):
            fam = sanitize_metric_name(name)
            if isinstance(m, Counter):
                family(fam, "counter", f"coreth_tpu_torch counter {name}",
                       [(fam, (), m.count())])
            elif isinstance(m, Gauge):
                family(fam, "gauge", f"coreth_tpu_torch gauge {name}",
                       [(fam, (), m.value())])
            elif isinstance(m, Meter):
                family(fam + "_total", "counter",
                       f"coreth_tpu_torch meter {name} (event count)",
                       [(fam + "_total", (), m.count())])
                family(fam + "_rate", "gauge",
                       f"coreth_tpu_torch meter {name} (events/sec)",
                       [(fam + "_rate", (), m.rate_mean())])
            elif isinstance(m, Timer):
                summary(fam + "_seconds",
                        f"coreth_tpu_torch timer {name} (seconds)",
                        m.percentiles(_QUANTILES), m.total(), m.count())
            elif isinstance(m, Histogram):
                if m.bucket_bounds() is not None:
                    # real histogram family: cumulative le buckets, the
                    # +Inf bucket equal to _count, then _sum/_count.
                    # Exemplars ride as comment lines (text-format 0.0.4
                    # has no inline exemplar syntax; any scraper skips
                    # comments, and our --check validates them).
                    samples: List[Tuple[str, tuple, object]] = []
                    for le, cum in m.buckets():
                        samples.append((fam + "_bucket",
                                        (("le", _fmt_value(le)),), cum))
                    samples.append((fam + "_bucket", (("le", "+Inf"),),
                                    m.count()))
                    samples.append((fam + "_sum", (), m.sum()))
                    samples.append((fam + "_count", (), m.count()))
                    family(fam, "histogram",
                           f"coreth_tpu_torch slo histogram {name}", samples)
                    for le_label, ex in sorted(m.exemplars().items()):
                        lines.append(
                            f'# EXEMPLAR {fam}_bucket{{le="{le_label}"}} '
                            f"trace_id={ex['trace_id']} "
                            f"value={_fmt_value(ex['value'])}")
                else:
                    summary(fam, f"coreth_tpu_torch histogram {name}",
                            m.percentiles(_QUANTILES), m.sum(), m.count())
        return "\n".join(lines) + "\n"

    def marshal(self) -> Dict[str, dict]:
        """JSON-friendly dump of every metric — the `debug_metrics` RPC
        payload (go-ethereum's debug/metrics.go analog)."""
        out: Dict[str, dict] = {}
        for name, m in sorted(self.each()):
            if isinstance(m, Counter):
                out[name] = {"type": "counter", "count": m.count()}
            elif isinstance(m, Gauge):
                out[name] = {"type": "gauge", "value": m.value()}
            elif isinstance(m, Meter):
                out[name] = {"type": "meter", "count": m.count(),
                             "rate": m.rate_mean()}
            elif isinstance(m, Timer):
                p50, p90, p99 = m.percentiles(_QUANTILES)
                out[name] = {"type": "timer", "count": m.count(),
                             "total_seconds": m.total(),
                             "mean_seconds": m.mean(),
                             "p50": p50, "p90": p90, "p99": p99}
            elif isinstance(m, Histogram):
                p50, p90, p99 = m.percentiles(_QUANTILES)
                out[name] = {"type": "histogram", "count": m.count(),
                             "sum": m.sum(), "mean": m.mean(),
                             "p50": p50, "p90": p90, "p99": p99}
                if m.bucket_bounds() is not None:
                    out[name]["buckets"] = {
                        _fmt_value(le): cum for le, cum in m.buckets()}
                    out[name]["exemplars"] = m.exemplars()
        return out


# default registry (metrics.DefaultRegistry)
default_registry = Registry()


def get_or_register_counter(name: str, registry: Optional[Registry] = None) -> Counter:
    return (registry or default_registry).counter(name)


def get_or_register_timer(name: str, registry: Optional[Registry] = None) -> Timer:
    return (registry or default_registry).timer(name)


def count_drop(name: str, registry: Optional[Registry] = None) -> None:
    """Increment a drop/swallowed-exception counter (coreth's gossip and
    handler stats pattern): the ONE helper every silenced except-path
    uses, so the drop namespace stays in one place."""
    (registry or default_registry).counter(name).inc(1)


def get_or_register_meter(name: str, registry: Optional[Registry] = None) -> Meter:
    return (registry or default_registry).meter(name)


def get_or_register_gauge(name: str, registry: Optional[Registry] = None) -> Gauge:
    return (registry or default_registry).gauge(name)


class _NullCtx:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NULL_CTX = _NullCtx()


# --- phases: the commit pipeline's always-on timers -------------------------
#
# A phase is a registry timer that the flight recorder and the benchmark
# read in every run. When tracing asks for it, the same stretch is also a
# span of the phase's name (spans.span, gated as ever) and a torch
# profiler range of that name, which puts the phase on the device trace's
# clock. A profiler session records only the threads that ran when it
# began: a phase on a thread it does not record (the device watchdog's
# worker) reaches it through a PhaseRelay, whose follower opens and closes
# the range on the thread that handed the work over.

_tls = threading.local()  # .relay: the PhaseRelay of a watchdog's worker
_now = time.monotonic


def _profiling() -> bool:
    """A torch profiler session runs in this process: the module flag
    alone, read without importing torch (about 0.1 us)."""
    ap = sys.modules.get("torch.autograd.profiler")
    return ap is not None and ap._is_profiler_enabled


def _thread_profiled() -> bool:
    """The running profiler session records this thread."""
    import torch

    return torch._C._autograd._profiler_enabled()


def _trace_open(name: str):
    """Open `name`'s span (spans on) and its profiler range (a session
    runs): on this thread when the session records it, else through this
    thread's relay, if it has one. Returns what _trace_close closes, or
    None when nothing opened."""
    sp = rf = relay = None
    if _spans.enabled:
        sp = _spans.tracer.span(name)
        sp.__enter__()
    if _profiling():
        if _thread_profiled():
            from torch.autograd.profiler import record_function

            rf = record_function(name)
            rf.__enter__()
        else:
            relay = getattr(_tls, "relay", None)
            if relay is not None:
                relay.post(name)
    if sp is None and rf is None and relay is None:
        return None
    return sp, rf, relay


def _trace_close(opened, exc_type=None) -> None:
    sp, rf, relay = opened
    if rf is not None:
        rf.__exit__(None, None, None)
    elif relay is not None:
        relay.post(None)
    if sp is not None:
        sp.__exit__(exc_type, None, None)


def _trace_next(opened, name: Optional[str]):
    """Close `opened` (what _trace_open returned, or None) and open `name`
    (None: nothing). A relayed range followed by another is one post, so
    the follower never holds neither between them."""
    relay = opened[2] if opened is not None else None
    if (relay is not None and name is not None
            and getattr(_tls, "relay", None) is relay and _profiling()):
        sp = opened[0]
        if sp is not None:
            sp.__exit__(None, None, None)
        if _spans.enabled:
            sp = _spans.tracer.span(name)
            sp.__enter__()
        else:
            sp = None
        relay.post(name, close_first=True)
        return sp, None, relay
    if opened is not None:
        _trace_close(opened)
    return _trace_open(name) if name is not None else None


class _Phase:
    """One stretch of a phase (phase_timer). `seconds` holds its length
    once the `with` block has closed."""

    __slots__ = ("name", "seconds", "_timer", "_t0", "_opened")

    def __init__(self, name: str, timer: Optional[Timer]):
        self.name = name
        self.seconds = 0.0
        self._timer = timer

    def __enter__(self):
        self._opened = (_trace_open(self.name)
                        if _spans.enabled or _profiling() else None)
        self._t0 = _now()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.seconds = s = _now() - self._t0
        if self._opened is not None:
            _trace_close(self._opened, exc_type)
        if self._timer is not None:
            self._timer.update(s)
        return False


def phase_timer(name: str, registry: Optional[Registry] = None):
    """Always-on phase-attribution timer for the commit pipeline (the
    resident/phase/* split: the flight recorder's, the benchmark's phase
    readers). Unlike expensive_timer this is NOT gated: the `with`
    block's seconds go to the registry timer `name` in every run, and
    stay on the returned object as `.seconds`, so a caller that keeps its
    own reading of the same work (IncrementalTrie.last_plan_ms) takes it
    from the same clock reads. With spans on the block is also a span
    named `name`; while a torch profiler session runs, also a profiler
    range of that name."""
    if not enabled:
        return _Phase(name, None)
    reg = registry or default_registry
    return _Phase(name, reg._metrics.get(name) or reg.timer(name))


def phase_add(name: str, seconds: float,
              registry: Optional[Registry] = None) -> None:
    """Add `seconds` to the phase timer `name`: a phase measured in pieces
    that no one `with` block covers (the device watchdog's handoff)."""
    if enabled:
        (registry or default_registry).timer(name).update(seconds)


class PhaseSeq:
    """Phases that follow one another on one thread, one clock read at
    each boundary (a resident commit's executor run): to(name) closes the
    running phase and starts `name` (None: none). A phase started again
    adds to its sum, and the `with` block's end (close()) updates each
    phase's timer once with its sum. When tracing, sampled as the
    sequence starts, every stretch is also a span and a profiler range of
    its phase's name, as with phase_timer."""

    __slots__ = ("_registry", "_sums", "_cur", "_t", "_opened", "_traced")

    def __init__(self, registry: Optional[Registry] = None):
        self._registry = registry
        # phase -> seconds; the stretch before the first phase goes
        # under None and is dropped
        self._sums: Dict[Optional[str], float] = {}
        self._cur: Optional[str] = None
        self._t = _now()
        self._opened = None
        self._traced = _spans.enabled or _profiling()

    def __enter__(self) -> "PhaseSeq":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    def to(self, name: Optional[str]) -> None:
        t = _now()
        sums = self._sums
        cur = self._cur
        sums[cur] = sums.get(cur, 0.0) + t - self._t
        self._cur = name
        self._t = t
        if self._traced:
            self._opened = _trace_next(self._opened, name)

    def close(self) -> None:
        self.to(None)
        sums, self._sums = self._sums, {}
        if enabled:
            reg = self._registry or default_registry
            for name, s in sums.items():
                if name is not None:
                    reg.timer(name).update(s)


class PhaseRelay:
    """Carries the phases of a thread that the running profiler session
    does not record (native/mpt._run_with_watchdog's worker) to the thread
    that handed it the work, which the session records. The worker calls
    started() first and finish() last; in between its phases post each
    boundary here. The caller's follow() opens and closes a range of the
    same name on its own thread at each signal (a wake-up after the
    boundary), with the range `own` (the watchdog's handoff) open until
    the worker's first phase and again once the worker has finished."""

    def __init__(self, own: Optional[str] = None):
        self._cond = threading.Condition(threading.Lock())
        self._posted: List[Optional[str]] = []
        self._done = False
        self._own = own

    @classmethod
    def for_caller(cls, own: Optional[str] = None) -> Optional["PhaseRelay"]:
        """A relay when the running profiler session records this thread,
        else None: no relay, no range, and the caller's wait stays one
        Event.wait."""
        if _profiling() and _thread_profiled():
            return cls(own)
        return None

    def post(self, name: Optional[str], close_first: bool = False) -> None:
        """A phase `name` starts (None: the innermost open one ends);
        close_first: the innermost open one ends as it starts."""
        with self._cond:
            if close_first:
                self._posted.append(None)
            self._posted.append(name)
            self._cond.notify()

    def started(self) -> None:
        """The worker's first instruction: its phases post here."""
        _tls.relay = self

    def finish(self) -> None:
        """The worker's last instruction."""
        _tls.relay = None
        with self._cond:
            if self._own is not None:
                self._posted.append(self._own)
            self._done = True
            self._cond.notify()

    def follow(self, start, timeout: float) -> bool:
        """On the caller: open `own`, start the worker (`start()`), then
        mirror its phases as profiler ranges on this thread until it
        finishes (True) or `timeout` seconds after its start pass first
        (False). Every range opened here is closed when it returns."""
        from torch.autograd.profiler import record_function

        opened = []

        def open_range(name: str) -> None:
            rf = record_function(name)
            rf.__enter__()
            opened.append(rf)

        try:
            if self._own is not None:
                open_range(self._own)
            own_open = self._own is not None
            start()
            deadline = time.monotonic() + timeout
            while True:
                with self._cond:
                    while not self._posted and not self._done:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            return False
                        self._cond.wait(left)
                    posted, self._posted = self._posted, []
                    done = self._done
                if own_open:
                    opened.pop().__exit__(None, None, None)
                    own_open = False
                for name in posted:
                    if name is not None:
                        open_range(name)
                    elif opened:
                        opened.pop().__exit__(None, None, None)
                if done:
                    return True
        finally:
            while opened:
                opened.pop().__exit__(None, None, None)


def observe_slo(name: str, seconds: float, exemplar: Optional[str] = None,
                registry: Optional[Registry] = None) -> None:
    """Record one latency observation into a fixed-bucket SLO histogram
    (created on first use with DEFAULT_SLO_BUCKETS), optionally attaching
    a trace-id exemplar to the bucket the observation lands in."""
    if not enabled:
        return
    (registry or default_registry).histogram(
        name, buckets=DEFAULT_SLO_BUCKETS).update(seconds, exemplar=exemplar)


def expensive_timer(name: str, registry: Optional[Registry] = None):
    """Context-managed timer gated on EnabledExpensive (metrics.go gate):
    zero overhead beyond one flag check when the gate is off. Used for
    the per-phase statedb timers (statedb.go:1006-1119
    AccountHashes/AccountCommits/StorageCommits analogs)."""
    if not enabled_expensive:
        return _NULL_CTX
    return (registry or default_registry).timer(name).time()
