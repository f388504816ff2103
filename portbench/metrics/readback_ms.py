"""Median per block of the root's synchronisation and 32-byte read: the
phase span resident/phase/readback (ops/keccak_resident.py
ResidentExecutor.root_bytes; portbench/lib/phases.py)."""

from portbench.lib import phases

PHASES = ("readback",)


def sample(run):
    return phases.sample(run, "readback_ms", PHASES)


def read(run):
    return phases.read(run, "readback_ms")
