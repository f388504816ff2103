"""Median per block of the native update of the block's leaves: the
mirror's trie.checkpoint() and IncrementalTrie.update, the phase span
resident/phase/update (trie/resident_mirror.py ResidentAccountMirror
verify; portbench/lib/phases.py)."""

from portbench.lib import phases

PHASES = ("update",)


def sample(run):
    return phases.sample(run, "update_ms", PHASES)


def read(run):
    return phases.read(run, "update_ms")
