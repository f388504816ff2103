"""The VM block's phase timers (the port's vm/phase/* registry timers:
coreth_tpu_torch/vm/vm.py and vm/block.py, metrics.phase_timer) and the
chain's acceptor timer (chain/block/accepts: the accepted block's state
persisted), read per block of the blocks loop's window: each reader's
sample() takes the difference of the timers' total() across the block
just done, and its read() the median over the window's blocks, the
profiled ones left out (the profiler slows them).

The first block of the window gives no sample (no reading before it). A
program that keeps none of the phases named (one that has no such
timer) gives none at all, and its reader nothing.

The first read() of a run also logs the whole split: each timer's median
per block, and how much of each block's time (the harness's clock) the
phases tile.
"""

from __future__ import annotations

import statistics

PREFIX = "vm/phase/"
ACCEPTOR = "chain/block/accepts"


def _totals() -> dict:
    # imported here, once the loop has imported the port
    from coreth_tpu_torch import metrics

    return {name: m.total() for name, m in metrics.default_registry.each()
            if (name.startswith(PREFIX) or name == ACCEPTOR)
            and isinstance(m, metrics.Timer) and m.count()}


def sample(run, metric: str, timers) -> float | None:
    """Milliseconds of `timers` (full registry names) in the block just
    done, noted under `metric` with the block's index."""
    n = len(run.series["block_ms"])  # blocks done in the window
    snap = run.notes.get("vm_phase_totals")
    if snap is None or snap[0] != n:
        prev = snap[1] if snap is not None and snap[0] == n - 1 else None
        snap = (n, _totals(), prev)
        run.notes["vm_phase_totals"] = snap
        if prev is not None:
            run.notes.setdefault("vm_phase_deltas", []).append(
                (n - 1, {k: (v - prev[k]) * 1e3
                         for k, v in snap[1].items() if k in prev}))
    _, now, before = snap
    if before is None:
        return None
    if any(k not in now or k not in before for k in timers):
        return None
    run.notes.setdefault("vm_phase_blocks." + metric, []).append(n - 1)
    return sum(now[k] - before[k] for k in timers) * 1e3


def read(run, metric: str) -> float | None:
    """Median of `metric`'s samples over the window's blocks outside the
    profiled interval."""
    a, b = run.notes.get("profiled_blocks", (0, 0))
    if not run.notes.get("vm_phase_split_logged"):
        run.notes["vm_phase_split_logged"] = True
        _log_split(run, a, b)
    xs = run.samples.get(metric) or []
    blocks = run.notes.get("vm_phase_blocks." + metric, [])
    xs = [x for k, x in zip(blocks, xs) if not a <= k < b]
    return statistics.median(xs) if xs else None


def _log_split(run, a: int, b: int) -> None:
    rows = [(k, d) for k, d in run.notes.get("vm_phase_deltas", [])
            if not a <= k < b]
    block = run.series.get("block_ms", [])
    if not rows or not block:
        return
    names = sorted({n for _, d in rows for n in d})
    med = {n: statistics.median(d.get(n, 0.0) for _, d in rows)
           for n in names}
    run.log("vm phases: median ms per block over %d blocks: %s" % (
        len(rows), ", ".join(f"{n} {med[n]:.3f}" for n in names)))
    share = [sum(d.values()) / block[k] for k, d in rows if block[k] > 0]
    if share:
        run.log("vm phases: the phases and the acceptor tile %.2f %% of a "
                "block (median over the blocks; least %.2f %%)" % (
                    100 * statistics.median(share), 100 * min(share)))
