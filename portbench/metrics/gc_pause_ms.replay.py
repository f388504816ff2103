"""Sum of the garbage collector's pauses in the replay window, by
gc.callbacks (portbench/lib/harness.py GcPauses)."""


def read(run):
    return run.gc.ms
