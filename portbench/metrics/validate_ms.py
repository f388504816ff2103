"""Median per block of the planned state root in the chain's verify
insert: the flight record's `validate` phase (BlockValidator.
validate_state: StateDB.intermediate_root through trie/planned.py and
ops/keccak_planned.py, K1) of the block's record whose `run` is
"verify" (metrics/flight.py), the profiled blocks left out. Nothing from
a program whose records do not say which run they are."""

from portbench.lib import flight

PHASE = "validate"


def sample(run):
    return flight.sample(run, PHASE)


def read(run):
    return flight.read(run, PHASE)
