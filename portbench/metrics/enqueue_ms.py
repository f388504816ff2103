"""Median per block of the resident executor's host enqueue, the host side
of device_window_ms: the phase spans resident/phase/scatter (the uploads,
fresh and lean rows), /patch (every segment's delta patch), /hash (every
segment's gather and K1 launch) and /store (the store scatter), summed
(ops/keccak_resident.py ResidentExecutor.run; portbench/lib/phases.py)."""

from portbench.lib import phases

PHASES = ("scatter", "patch", "hash", "store")


def sample(run):
    return phases.sample(run, "enqueue_ms", PHASES)


def read(run):
    return phases.read(run, "enqueue_ms")
