"""Median per block of the VM's build: the phase span vm/phase/build
(coreth_tpu_torch/vm/vm.py VM.build_block: the miner's run of the
transactions, the state root, the built block's check insert)
(portbench/lib/vm_phases.py)."""

from portbench.lib import vm_phases

TIMERS = (vm_phases.PREFIX + "build",)


def sample(run):
    return vm_phases.sample(run, "build_ms", TIMERS)


def read(run):
    return vm_phases.read(run, "build_ms")
