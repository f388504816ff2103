"""Sum of the garbage collector's pauses in the blocks cell's window, by
gc.callbacks (portbench/lib/harness.py GcPauses)."""


def read(run):
    return run.gc.ms
