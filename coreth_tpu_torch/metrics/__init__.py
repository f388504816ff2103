"""Metrics registry (coreth metrics/, the go-metrics fork: counters,
gauges, meters, histograms, timers, with the EnabledExpensive gate and
Prometheus-style export); counterpart of coreth_tpu/metrics/__init__.py.

Not ported: the package's command-line check (`__main__`), its HTTP
exposition, the profiler, the flight recorder and the shard statistics
(ROADMAP "Still to port", items 3b.2 and 8)."""

from __future__ import annotations

import re
import threading
import time
from typing import Dict, List, Optional, Tuple

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
            self._count += 1
            self._sum += v
            if self._buckets is not None:
                import bisect

                i = bisect.bisect_left(self._buckets, v)
                if i < len(self._buckets):
                    self._bucket_counts[i] += 1
                    if exemplar:
                        self._exemplars[i] = (v, exemplar)
            if len(self._samples) < self._reservoir:
                self._samples.append(v)
            else:
                import random

                i = random.randrange(self._count)
                if i < self._reservoir:
                    self._samples[i] = v

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
    """Histogram of durations + a meter of calls."""

    def __init__(self):
        self.hist = Histogram()
        self.meter = Meter()
        self._total = 0.0
        self._lock = threading.Lock()

    def update(self, seconds: float) -> None:
        self.hist.update(seconds)
        self.meter.mark()
        with self._lock:
            self._total += seconds

    def time(self):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.monotonic()
                return self

            def __exit__(self, *a):
                timer.update(time.monotonic() - self.t0)

        return _Ctx()

    def count(self) -> int:
        return self.meter.count()

    def mean(self) -> float:
        return self.hist.mean()

    def total(self) -> float:
        """Exact cumulative seconds across every update (unlike
        mean()*count(), which drifts once the reservoir saturates) —
        what the bench phase-attribution report divides."""
        with self._lock:
            return self._total


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
                        m.hist.percentiles(_QUANTILES), m.total(), m.count())
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
                p50, p90, p99 = m.hist.percentiles(_QUANTILES)
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


def phase_timer(name: str, registry: Optional[Registry] = None):
    """Always-on phase-attribution timer for the commit pipeline
    (plan / export / scatter / patch / store decomposition). Unlike
    expensive_timer this is NOT gated: it fires a handful of times per
    block commit, and the regression it guards (the resident-path CPU
    overhead) must decompose mechanically in every bench run."""
    if not enabled:
        return _NULL_CTX
    return (registry or default_registry).timer(name).time()


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
