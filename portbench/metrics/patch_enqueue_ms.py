"""Median per block of the host time enqueueing every segment's delta patch
(the chain of small torch ops that one device program a commit would
take over): the phase span resident/phase/patch, summed over the commit
(ops/keccak_resident.py ResidentExecutor.run; portbench/lib/phases.py)."""

from portbench.lib import phases

PHASES = ("patch",)


def sample(run):
    return phases.sample(run, "patch_enqueue_ms", PHASES)


def read(run):
    return phases.read(run, "patch_enqueue_ms")
