"""Median K3 launches per commit (ResidentExecutor.last_patch_launches,
set by each commit: one a segment with patches); nothing to read from a
program whose executor has no such counter."""

import statistics


def sample(run):
    ex = run.objects.get("executor")
    return None if ex is None else getattr(ex, "last_patch_launches", None)


def read(run):
    xs = run.samples.get("patch_launches")
    return statistics.median(xs) if xs else None
