"""Kernels K1 (segment Keccak-256) and K2 (variable-length Keccak-256) on
Hopper: build, bind and call.

K1 replaces the TPU kernel coreth_tpu/ops/keccak_pallas.py:211
segment_keccak_pallas (body _make_segment_kernel at :172); K2 replaces
keccak_pallas.py:126 keccak256_blocks_pallas (body _make_kernel at :99).
Their CUDA C++ sources are csrc/segment_keccak.cu and csrc/keccak_blocks.cu,
sharing the permutation in csrc/keccak_f.cuh; each header states the design
and what bounds it on an H100 (integer-ALU throughput when a batch fills
the card: about 4.35k 32-bit ops per 136-byte block absorbed, 0.26 ns
against 0.041 ns of memory time per lane-block; one permutation's latency
when it does not).

Each source holds two kernels: one thread per lane (variant 1) for wide
batches, and five threads of a warp per lane (variant 2, "cooperative")
for small ones. With variant=None the launch picks by the lane count
alone: the cooperative kernel for B <= the source's kCoopMaxLanes (read
back as `K1.coop_max_lanes` / `K2.coop_max_lanes` once built); 1 or 2
forces one; any other value raises. Nothing retries another kernel.

Each is built at first use with
    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v
into coreth_tpu_torch/_build/lib<name>.so (a plain C entry point loaded
with ctypes; ptxas's register report in the .log beside it), and launched
on the tensor's device's current stream.

Both take the u32 words as an int32 tensor with the same bits (torch's
uint32 op coverage is thin). A CPU tensor goes to the kernel's plain torch
version, whatever the variant; a CUDA tensor launches a kernel or raises.
`launches` counts K1 launches and `launches_coop` those of them that ran
the cooperative kernel; `blocks_launches` and `blocks_launches_coop` count
K2's the same way. Nothing else changes them.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import List, Optional

import torch

from ..device import KernelLaunchError
from ..native._build import BUILD_DIR, build_and_load
from .keccak_staged import segment_keccak_plain
from .keccak_torch import WORDS_PER_BLOCK, keccak256_blocks_plain

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

THREAD, COOP = 1, 2  # the variants a caller may force

launches = 0              # K1
launches_coop = 0         # K1 launches of the cooperative kernel
blocks_launches = 0       # K2
blocks_launches_coop = 0  # K2 launches of the cooperative kernel


def reset_counts() -> None:
    """Set every launch count to 0."""
    global launches, launches_coop, blocks_launches, blocks_launches_coop
    launches = launches_coop = blocks_launches = blocks_launches_coop = 0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    return path


class _Kernel:
    """One CUDA source built into its own library at first use; `load()`
    returns its launch function with argtypes set, and sets
    `coop_max_lanes` from the source's kCoopMaxLanes."""

    def __init__(self, source: str, prefix: str, argtypes: List):
        self.src = os.path.join(_CSRC, source)
        self.lib_name = f"lib{os.path.splitext(source)[0]}.so"
        self._prefix = prefix
        self._argtypes = argtypes
        self._lock = threading.Lock()
        self.fn = None
        self.coop_max_lanes: Optional[int] = None

    def load(self):
        """Build (if stale) and load; returns the C launch function."""
        if self.fn is not None:
            return self.fn
        with self._lock:
            if self.fn is None:
                lib = build_and_load([_nvcc(), *NVCC_FLAGS], [self.src],
                                     self.lib_name, timeout=600)
                limit = getattr(lib, f"{self._prefix}_coop_max_lanes")
                limit.argtypes, limit.restype = [], ctypes.c_longlong
                self.coop_max_lanes = int(limit())
                fn = getattr(lib, f"{self._prefix}_launch")
                fn.argtypes = self._argtypes
                fn.restype = ctypes.c_int
                self.fn = fn
        return self.fn

    def build_log(self) -> str:
        """The compiler output of the last build (ptxas registers, spills)."""
        path = os.path.join(BUILD_DIR, self.lib_name + ".log")
        if not os.path.exists(path):
            return ""
        with open(path) as f:
            return f.read()


_P, _I = ctypes.c_void_p, ctypes.c_int
# (words, out, p, blocks, variant, stream)
K1 = _Kernel("segment_keccak.cu", "segment_keccak",
             [_P, _P, ctypes.c_longlong, _I, _I, _P])
# (words, nblocks, out, b, blocks, variant, stream)
K2 = _Kernel("keccak_blocks.cu", "keccak_blocks",
             [_P, _P, _P, ctypes.c_longlong, _I, _I, _P])


def _check(fn: str, words, variant) -> None:
    """Raise on what the kernels do not take; cheap, as it runs per call."""
    if not isinstance(words, torch.Tensor):
        raise TypeError(f"{fn} takes a torch.Tensor")
    if variant is not None and variant not in (THREAD, COOP):
        raise ValueError(f"{fn}: variant must be None, 1 or 2, got "
                         f"{variant!r}")
    if words.dtype != torch.int32:
        raise TypeError(f"{fn} takes int32 words, got {words.dtype}")
    shape = words.shape
    if len(shape) != 3 or shape[2] != WORDS_PER_BLOCK:
        raise ValueError(f"{fn} takes [B, L, 34] words, got {tuple(shape)}")
    if shape[1] < 1:
        raise ValueError(f"{fn} needs at least one block per lane")
    if not words.is_contiguous():
        raise ValueError(f"{fn} takes contiguous words")
    if not (words.is_cuda or words.is_cpu):
        raise ValueError(f"{fn} cannot run on {words.device}")


def _launch(kernel: _Kernel, name: str, words: torch.Tensor, *args) -> int:
    """Launch on the current stream of the words' device; returns the
    variant the library ran. The device context is entered only when the
    words are not on the current device."""
    fn = kernel.fn or kernel.load()
    dev = words.get_device()
    if dev == torch._C._cuda_getDevice():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    if rc <= 0:
        raise KernelLaunchError(f"{name} launch failed: CUDA error {-rc}")
    return rc


def segment_keccak(words: torch.Tensor,
                   variant: Optional[int] = None) -> torch.Tensor:
    """int32[P, L, 34] (u32 bits) -> int32[P, 8]: K1 on CUDA (the kernel
    `variant` names, or the one P picks when None), the plain torch version
    for a CPU tensor."""
    global launches, launches_coop
    _check("segment_keccak", words, variant)
    if words.is_cpu:
        return segment_keccak_plain(words)
    p, blocks = words.shape[0], words.shape[1]
    out = words.new_empty((p, 8))
    if p == 0:
        return out
    ran = _launch(K1, "segment_keccak", words, words.data_ptr(),
                  out.data_ptr(), p, blocks, variant or 0)
    launches += 1
    launches_coop += ran == COOP
    return out


def keccak256_blocks(words: torch.Tensor, nblocks: torch.Tensor,
                     variant: Optional[int] = None) -> torch.Tensor:
    """int32[B, L, 34] (u32 bits) + int32[B] block counts -> int32[B, 8]:
    K2 on CUDA (the kernel `variant` names, or the one B picks when None),
    keccak256_blocks_plain for CPU tensors. A lane whose count is outside
    [1, L] gets an all-zero digest, as on the TPU."""
    global blocks_launches, blocks_launches_coop
    _check("keccak256_blocks", words, variant)
    if not isinstance(nblocks, torch.Tensor):
        raise TypeError("keccak256_blocks takes nblocks as a torch.Tensor")
    if nblocks.dtype != torch.int32:
        raise TypeError(
            f"keccak256_blocks takes int32 nblocks, got {nblocks.dtype}")
    b, blocks = words.shape[0], words.shape[1]
    if nblocks.shape != (b,):
        raise ValueError(
            f"keccak256_blocks takes nblocks [B] for words "
            f"{tuple(words.shape)}, got {tuple(nblocks.shape)}")
    if not nblocks.is_contiguous():
        raise ValueError("keccak256_blocks takes contiguous nblocks")
    # device indices (-1 on the CPU) compare without building devices
    if (nblocks.get_device() != words.get_device()
            or nblocks.is_cpu != words.is_cpu):
        raise ValueError(
            f"keccak256_blocks: words on {words.device}, nblocks on "
            f"{nblocks.device}")
    if words.is_cpu:
        return keccak256_blocks_plain(words, nblocks)
    out = words.new_empty((b, 8))
    if b == 0:
        return out
    ran = _launch(K2, "keccak256_blocks", words, words.data_ptr(),
                  nblocks.data_ptr(), out.data_ptr(), b, blocks, variant or 0)
    blocks_launches += 1
    blocks_launches_coop += ran == COOP
    return out
