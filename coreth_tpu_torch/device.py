"""Device resolution for the port's entry points.

Counterpart of coreth_tpu/ops/keccak_planned.py:_tpu_backend. Entry points
run on CUDA unless the caller asks for the CPU; nothing drifts to the CPU
when CUDA is missing. The CUDA kernels are built for sm_90a, so a CUDA
device must be Hopper (compute capability >= 9.0).

DEVICE_FAULTS names the failures of the device itself: a device that
stopped answering (DeviceWedgedError), a kernel launch that returned a
CUDA error (KernelLaunchError, torch's CUDA errors) and a kernel or native
library that did not build (BuildError). They are never a block's fault
and never a failed speculation: every path that catches exceptions to
fall back (the speculative execution modes, the insert pipeline's commit
stage) lets them through to its caller, and so does the degradation
ladder's dispatch (ops/device.DeviceLadder), which finishes no device
call on the host.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .native._build import BuildError

DeviceLike = Optional[Union[str, torch.device]]


class DeviceWedgedError(RuntimeError):
    """The device did not answer within the watchdog budget. A caller may
    move the trie to the host (IncrementalTrie.rehash_host); nothing here
    does so by itself."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


DEVICE_FAULTS = (DeviceWedgedError, KernelLaunchError, BuildError,
                 torch.cuda.CudaError, torch.OutOfMemoryError) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ())


def hopper_available() -> bool:
    """True when CUDA is present and device 0 has compute capability >= 9.0."""
    if not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability(0) >= (9, 0)


def resolve(device: DeviceLike = None) -> torch.device:
    """None -> cuda; "cpu" only when asked; anything else raises."""
    d = torch.device("cuda" if device is None else device)
    if d.type == "cpu":
        return d
    if d.type != "cuda":
        raise ValueError(f"unsupported device {d}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    cap = torch.cuda.get_device_capability(d)
    if cap < (9, 0):
        raise RuntimeError(
            f"{torch.cuda.get_device_name(d)} has compute capability "
            f"{cap[0]}.{cap[1]}; the kernels are built for sm_90a")
    return d
