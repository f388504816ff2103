"""Median per block of the EVM's run of the block in the chain's verify
insert: the flight record's `execute` phase (core/state_processor.py,
timed by core/blockchain.py) of the block's record whose `run` is
"verify" (metrics/flight.py), the profiled blocks left out. Nothing from
a program whose records do not say which run they are."""

from portbench.lib import flight

PHASE = "execute"


def sample(run):
    return flight.sample(run, PHASE)


def read(run):
    return flight.read(run, PHASE)
