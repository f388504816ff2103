"""Median bytes the resident executor uploads per commit
(ResidentExecutor.h2d_bytes, set by each commit)."""

import statistics


def sample(run):
    ex = run.objects.get("executor")
    return None if ex is None else ex.h2d_bytes


def read(run):
    xs = run.samples.get("h2d_bytes")
    return statistics.median(xs) if xs else None
