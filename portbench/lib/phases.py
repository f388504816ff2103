"""The resident commit's phase timers (the port's resident/phase/*
registry timers, coreth_tpu_torch/metrics phase_timer and PhaseSeq) read
per block of the replay's window: each reader's sample() takes the
difference of the timers' total() across the block just done, and its
read() the median over the window's blocks, the profiled ones left out
(the profiler slows them).

The first block of the window gives no sample (no reading before it).
A program that keeps none of the phases named (one that has no such
timer, or never updated it) gives none at all, and its reader nothing.

The first read() of a run also logs the whole split: each phase's median
per block, and how much of each block's verify (the harness's clock,
mirror_verify_ms) the phases under `commit` and beside it tile.
"""

from __future__ import annotations

import statistics

PREFIX = "resident/phase/"


def _totals() -> dict:
    # imported here, once the loop has imported the port
    from coreth_tpu_torch import metrics

    return {name: m.total() for name, m in metrics.default_registry.each()
            if name.startswith(PREFIX) and isinstance(m, metrics.Timer)
            and m.count()}


def sample(run, metric: str, phases) -> float | None:
    """Milliseconds of `phases` (names after resident/phase/) in the block
    just done, noted under `metric` with the block's index."""
    n = len(run.series["verify_ms"])  # blocks done in the window
    snap = run.notes.get("phase_totals")
    if snap is None or snap[0] != n:
        prev = snap[1] if snap is not None and snap[0] == n - 1 else None
        snap = (n, _totals(), prev)
        run.notes["phase_totals"] = snap
        if prev is not None:
            run.notes.setdefault("phase_deltas", []).append(
                (n - 1, {k[len(PREFIX):]: (v - prev[k]) * 1e3
                         for k, v in snap[1].items() if k in prev}))
    _, now, before = snap
    if before is None:
        return None
    names = [PREFIX + p for p in phases]
    if any(k not in now or k not in before for k in names):
        return None
    ms = sum(now[k] - before[k] for k in names) * 1e3
    run.notes.setdefault("phase_blocks." + metric, []).append(n - 1)
    return ms


def read(run, metric: str) -> float | None:
    """Median of `metric`'s samples over the window's blocks outside the
    profiled interval."""
    a, b = run.notes.get("profiled_blocks", (0, 0))
    if not run.notes.get("phase_split_logged"):
        run.notes["phase_split_logged"] = True
        _log_split(run, a, b)
    xs = run.samples.get(metric) or []
    blocks = run.notes.get("phase_blocks." + metric, [])
    xs = [x for k, x in zip(blocks, xs) if not a <= k < b]
    return statistics.median(xs) if xs else None


def _log_split(run, a: int, b: int) -> None:
    rows = [(k, d) for k, d in run.notes.get("phase_deltas", [])
            if not a <= k < b]
    verify = run.series.get("verify_ms", [])
    if not rows or not verify:
        return
    names = sorted({n for _, d in rows for n in d})
    med = {n: statistics.median(d.get(n, 0.0) for _, d in rows)
           for n in names}
    run.log("phases: median ms per block over %d blocks: %s" % (
        len(rows), ", ".join(f"{n} {med[n]:.4f}" for n in names)))
    share = [sum(v for n, v in d.items() if n != "commit") / verify[k]
             for k, d in rows if verify[k] > 0]
    q = statistics.quantiles(share, n=4) if len(share) > 1 else share * 3
    run.log("phases: the phases tile %.2f %% of a block's verify (median "
            "over the blocks; quartiles %.2f, %.2f %%; least %.2f %%)" % (
                100 * statistics.median(share), 100 * q[0], 100 * q[2],
                100 * min(share)))
