"""Median per block of the device watchdog's own cost: from the call to its
worker thread's first instruction, plus from the worker's last to the
caller's return, the phase span resident/phase/handoff
(native/mpt.py _run_with_watchdog; portbench/lib/phases.py)."""

from portbench.lib import phases

PHASES = ("handoff",)


def sample(run):
    return phases.sample(run, "handoff_ms", PHASES)


def read(run):
    return phases.read(run, "handoff_ms")
