"""Median per block of the VM's ingress: the phase span vm/phase/issue
(coreth_tpu_torch/vm/vm.py VM.issue_tx: the tx pool's checks and sender
recovery), summed over the block's transactions
(portbench/lib/vm_phases.py)."""

from portbench.lib import vm_phases

TIMERS = (vm_phases.PREFIX + "issue",)


def sample(run):
    return vm_phases.sample(run, "issue_ms", TIMERS)


def read(run):
    return vm_phases.read(run, "issue_ms")
