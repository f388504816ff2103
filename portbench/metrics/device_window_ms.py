"""Median per commit of the resident executor's device window: its CUDA
events from before the first upload to after the store scatter
(ops/keccak_resident.py ResidentExecutor.last_events). Nothing on the
CPU."""

import statistics


def sample(run):
    ex = run.objects.get("executor")
    ev = getattr(ex, "last_events", None)
    if ev is None:
        return None
    t0, _, done = ev
    done.synchronize()
    return t0.elapsed_time(done)


def read(run):
    xs = run.samples.get("device_window_ms")
    return statistics.median(xs) if xs else None
