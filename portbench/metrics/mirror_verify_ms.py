"""Median host time inside ResidentAccountMirror.verify per block: the
harness's clock around the call (trie/resident_mirror.py), the profiled
interval's blocks left out (the profiler slows them)."""

import statistics


def read(run):
    xs = run.series.get("verify_ms")
    if not xs:
        return None
    a, b = run.notes.get("profiled_blocks", (0, 0))
    xs = xs[:a] + xs[b:]
    return statistics.median(xs) if xs else None
