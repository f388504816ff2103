"""Median per block of the accept and the persistence of the block's
state: the phase span vm/phase/accept (coreth_tpu_torch/vm/block.py
VMBlock.accept: the chain's accept and the atomic state) plus the
chain's acceptor timer chain/block/accepts (core/blockchain.py: the
insert tail joined, then NoPruningTrieWriter.accept_trie committing the
block's trie nodes to the SQLite store), which the loop drains before
the next block (portbench/lib/vm_phases.py). Nothing from a program
without the phase span."""

from portbench.lib import vm_phases

TIMERS = (vm_phases.PREFIX + "accept", vm_phases.ACCEPTOR)


def sample(run):
    return vm_phases.sample(run, "accept_ms", TIMERS)


def read(run):
    return vm_phases.read(run, "accept_ms")
