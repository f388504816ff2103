"""Median per block of the resident executor's host packing of its
staging buffers, before its first CUDA event, so outside
device_window_ms: the phase span resident/phase/stage
(ops/keccak_resident.py ResidentExecutor.run; portbench/lib/phases.py)."""

from portbench.lib import phases

PHASES = ("stage",)


def sample(run):
    return phases.sample(run, "stage_ms", PHASES)


def read(run):
    return phases.read(run, "stage_ms")
