"""Median per commit of the native planner's plan and export time
(native/mpt.py IncrementalTrie.last_plan_ms + last_export_ms)."""

import statistics


def sample(run):
    mirror = run.objects.get("mirror")
    if mirror is None:
        return None
    t = mirror.trie
    return t.last_plan_ms + t.last_export_ms


def read(run):
    xs = run.samples.get("plan_ms")
    return statistics.median(xs) if xs else None
