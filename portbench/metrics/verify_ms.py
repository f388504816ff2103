"""Median per block of the VM's verify: the phase span vm/phase/verify
(coreth_tpu_torch/vm/block.py VMBlock.verify: the chain's insert, which
runs the block's transactions again and commits its state)
(portbench/lib/vm_phases.py)."""

from portbench.lib import vm_phases

TIMERS = (vm_phases.PREFIX + "verify",)


def sample(run):
    return vm_phases.sample(run, "verify_ms", TIMERS)


def read(run):
    return vm_phases.read(run, "verify_ms")
