"""Exposition self-check CLI; counterpart of coreth_tpu/metrics/__main__.py.

    python -m coreth_tpu_torch.metrics            # print the live exposition
    python -m coreth_tpu_torch.metrics --json     # debug_metrics-shaped JSON
    python -m coreth_tpu_torch.metrics --check    # validate and exit 0/1

`--check` builds a synthetic registry that exercises every metric type
(plus hostile names) AND the process default registry, then validates
both expositions line by line, so a malformed metric registration fails
the check instead of breaking the scraper.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import sys
from typing import Dict, List, Optional, Tuple

from . import Registry, default_registry

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{([^}]*)\})?\s+(\S+)(?:\s+(-?\d+))?$")
_LABEL_RE = re.compile(r'^([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"$')
_HELP_RE = re.compile(r"^# HELP ([a-zA-Z_:][a-zA-Z0-9_:]*) (.*)$")
_TYPE_RE = re.compile(r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) "
                      r"(counter|gauge|summary|histogram|untyped)$")
_EXEMPLAR_RE = re.compile(
    r'^# EXEMPLAR ([a-zA-Z_:][a-zA-Z0-9_:]*)_bucket\{le="([^"]+)"\} '
    r"trace_id=(\S+) value=(\S+)$")

# suffixes a sample may add to its family name, by family type
_FAMILY_SUFFIXES = {
    "summary": ("", "_sum", "_count"),
    "histogram": ("", "_sum", "_count", "_bucket"),
    "counter": ("",),
    "gauge": ("",),
    "untyped": ("",),
}


def _parse_value(raw: str) -> Optional[float]:
    if raw in ("+Inf", "-Inf", "NaN", "Nan", "nan"):
        return {"+Inf": math.inf, "-Inf": -math.inf}.get(raw, math.nan)
    try:
        return float(raw)
    except ValueError:
        return None


def validate_exposition(text: str) -> List[str]:
    """Validate a Prometheus text exposition. Returns a list of error
    strings (empty = valid). Checks: every line parses, metric/label
    names are legal, HELP/TYPE declared once per family and before its
    samples, every sample belongs to a declared family, summary
    quantiles are float labels with monotone values, summaries carry
    _sum and _count, counters are finite and non-negative, histogram
    buckets carry a parseable `le` label with cumulative-monotone counts
    and a `+Inf` bucket equal to `_count`, and `# EXEMPLAR` comment lines
    reference a declared histogram bucket with a value inside it."""
    errors: List[str] = []
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    # family -> [(quantile, value)] for monotonicity; family -> suffixes seen
    quantiles: Dict[str, List[Tuple[float, float]]] = {}
    suffixes_seen: Dict[str, set] = {}
    # family -> {le_label: cumulative_count}; family -> {_sum/_count: value}
    buckets: Dict[str, Dict[str, float]] = {}
    hist_scalars: Dict[str, Dict[str, float]] = {}
    # (lineno, family, le_label, trace_id, raw_value) for post-pass checks
    exemplars: List[Tuple[int, str, str, str, str]] = []

    def owning_family(sample: str) -> Optional[Tuple[str, str]]:
        best = None
        for fam, kind in types.items():
            for sfx in _FAMILY_SUFFIXES[kind]:
                if sample == fam + sfx:
                    if best is None or len(fam) > len(best[0]):
                        best = (fam, sfx)
        return best

    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            mh = _HELP_RE.match(line)
            mt = _TYPE_RE.match(line)
            if mh:
                fam = mh.group(1)
                if fam in helps:
                    errors.append(f"line {lineno}: duplicate HELP for {fam}")
                helps[fam] = mh.group(2)
            elif mt:
                fam = mt.group(1)
                if fam in types:
                    errors.append(f"line {lineno}: duplicate TYPE for {fam}")
                types[fam] = mt.group(2)
            elif line.startswith("# HELP") or line.startswith("# TYPE"):
                errors.append(f"line {lineno}: malformed HELP/TYPE: {line!r}")
            elif line.startswith("# EXEMPLAR"):
                me = _EXEMPLAR_RE.match(line)
                if me:
                    exemplars.append((lineno, me.group(1), me.group(2),
                                      me.group(3), me.group(4)))
                else:
                    errors.append(
                        f"line {lineno}: malformed EXEMPLAR: {line!r}")
            continue  # other comments are legal

        m = _SAMPLE_RE.match(line)
        if not m:
            errors.append(f"line {lineno}: unparseable sample: {line!r}")
            continue
        name, rawlabels, rawvalue = m.group(1), m.group(2), m.group(3)
        value = _parse_value(rawvalue)
        if value is None:
            errors.append(f"line {lineno}: bad value {rawvalue!r} for {name}")
            continue
        labels: Dict[str, str] = {}
        if rawlabels:
            for part in rawlabels.split(","):
                lm = _LABEL_RE.match(part.strip())
                if not lm:
                    errors.append(
                        f"line {lineno}: bad label {part!r} on {name}")
                    continue
                labels[lm.group(1)] = lm.group(2)

        owner = owning_family(name)
        if owner is None:
            errors.append(
                f"line {lineno}: sample {name} has no preceding # TYPE")
            continue
        fam, sfx = owner
        kind = types[fam]
        suffixes_seen.setdefault(fam, set()).add(sfx)
        if kind == "counter" and not (value >= 0 and math.isfinite(value)):
            errors.append(
                f"line {lineno}: counter {name} value {rawvalue} invalid")
        if kind == "histogram":
            if sfx == "_bucket":
                le = labels.get("le")
                if le is None:
                    errors.append(
                        f"line {lineno}: histogram bucket {name} missing le")
                elif _parse_value(le) is None:
                    errors.append(
                        f"line {lineno}: unparseable le {le!r} on {name}")
                elif le in buckets.setdefault(fam, {}):
                    errors.append(
                        f"line {lineno}: duplicate bucket le={le} on {name}")
                else:
                    buckets[fam][le] = value
            elif sfx in ("_sum", "_count"):
                hist_scalars.setdefault(fam, {})[sfx] = value
        if kind == "summary" and sfx == "":
            q = labels.get("quantile")
            if q is None:
                errors.append(
                    f"line {lineno}: summary sample {name} missing quantile")
            else:
                try:
                    quantiles.setdefault(fam, []).append((float(q), value))
                except ValueError:
                    errors.append(
                        f"line {lineno}: bad quantile {q!r} on {name}")

    for fam, kind in types.items():
        if fam not in helps:
            errors.append(f"family {fam}: TYPE without HELP")
        if kind == "summary" and fam in suffixes_seen:
            for want in ("_sum", "_count"):
                if want not in suffixes_seen[fam]:
                    errors.append(f"summary {fam}: missing {fam}{want}")
    for fam, qs in quantiles.items():
        ordered = sorted(qs)
        values = [v for _, v in ordered]
        if any(b < a for a, b in zip(values, values[1:])):
            errors.append(f"summary {fam}: quantile values not monotone: "
                          f"{ordered}")
    for fam, kind in types.items():
        if kind != "histogram" or fam not in suffixes_seen:
            continue
        for want in ("_sum", "_count"):
            if want not in suffixes_seen[fam]:
                errors.append(f"histogram {fam}: missing {fam}{want}")
        bks = buckets.get(fam, {})
        if not bks:
            errors.append(f"histogram {fam}: no buckets")
            continue
        if "+Inf" not in bks:
            errors.append(f"histogram {fam}: missing +Inf bucket")
        ordered_b = sorted(bks.items(), key=lambda kv: _parse_value(kv[0]))
        counts = [v for _, v in ordered_b]
        if any(b < a for a, b in zip(counts, counts[1:])):
            errors.append(f"histogram {fam}: bucket counts not "
                          f"cumulative-monotone: {ordered_b}")
        count = hist_scalars.get(fam, {}).get("_count")
        if count is not None and "+Inf" in bks and bks["+Inf"] != count:
            errors.append(f"histogram {fam}: +Inf bucket {bks['+Inf']} != "
                          f"_count {count}")
    for lineno, fam, le, trace_id, rawv in exemplars:
        if types.get(fam) != "histogram":
            errors.append(f"line {lineno}: EXEMPLAR for non-histogram {fam}")
            continue
        if le not in buckets.get(fam, {}):
            errors.append(
                f"line {lineno}: EXEMPLAR references unknown bucket "
                f"le={le} on {fam}")
        v = _parse_value(rawv)
        bound = _parse_value(le)
        if v is None or not math.isfinite(v):
            errors.append(f"line {lineno}: EXEMPLAR bad value {rawv!r}")
        elif bound is not None and v > bound:
            errors.append(
                f"line {lineno}: EXEMPLAR value {rawv} outside le={le}")
        if not trace_id:
            errors.append(f"line {lineno}: EXEMPLAR missing trace_id")
    return errors


def _synthetic_registry() -> Registry:
    """Exercise every metric type, including names the sanitizer must
    rewrite, so --check proves the whole exposition path."""
    r = Registry()
    r.counter("chain/blocks/inserted").inc(7)
    r.counter("9starts/with-digit").inc(1)
    r.gauge("chain/head.height").update(42)
    r.gauge("resident/fill+ratio").update(0.75)
    r.meter("chain/txs").mark(1000)
    h = r.histogram("trie/keccak/batch_msgs")
    for i in range(500):
        h.update(float(i))
    t = r.timer("chain/phase/verify")
    for i in range(200):
        t.update(0.001 * (i + 1))
    r.timer("chain/phase/empty")  # registered but never updated
    from . import DEFAULT_SLO_BUCKETS

    slo = r.histogram("slo/rpc/eth_call", buckets=DEFAULT_SLO_BUCKETS)
    for i in range(100):
        slo.update(0.004 * (i % 30), exemplar="rpc-test-%06x" % i)
    slo.update(99.0, exemplar="rpc-test-above-top-bucket")
    r.histogram("slo/chain/insert", buckets=DEFAULT_SLO_BUCKETS)  # empty

    # lock-contention histograms (including the
    # module-lock canonical form `module:NAME`, whose ':' the sanitizer
    # must flatten to a legal exposition name) and profiler counters
    for lock in ("BlockChain.chainmu", "BlockChain._view_mu",
                 "blockchain:_ACCEPTOR_SIG"):
        for kind in ("wait", "hold"):
            lh = r.histogram(f"lock/{lock}/{kind}_seconds",
                             buckets=DEFAULT_SLO_BUCKETS)
            for i in range(50):
                lh.update(0.002 * (i % 20))
    r.counter("lock/slow_holds").inc(2)
    for role in ("rpc", "commit", "tail", "main"):
        r.counter(f"profile/samples/{role}").inc(100)
    r.counter("profile/sampler_errors")
    return r


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m coreth_tpu_torch.metrics",
        description="Prometheus exposition printer / self-check")
    ap.add_argument("--check", action="store_true",
                    help="validate the exposition (synthetic + live "
                         "registry) and exit non-zero on any error")
    ap.add_argument("--json", action="store_true",
                    help="print the debug_metrics JSON marshal instead")
    args = ap.parse_args(argv)

    if args.check:
        failed = False
        for label, reg in (("synthetic", _synthetic_registry()),
                           ("default", default_registry)):
            errs = validate_exposition(reg.export_prometheus())
            if errs:
                failed = True
                print(f"[metrics --check] {label} registry: "
                      f"{len(errs)} error(s)")
                for e in errs:
                    print(f"  {e}")
            else:
                print(f"[metrics --check] {label} registry: OK")
        return 1 if failed else 0

    if args.json:
        print(json.dumps(default_registry.marshal(), indent=2, sort_keys=True))
        return 0

    sys.stdout.write(default_registry.export_prometheus())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
