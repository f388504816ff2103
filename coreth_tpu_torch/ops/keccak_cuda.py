"""Kernels K1 (segment Keccak-256) and K2 (variable-length Keccak-256) on
Hopper: build, bind and call.

K1 replaces the TPU kernel coreth_tpu/ops/keccak_pallas.py:211
segment_keccak_pallas (body _make_segment_kernel at :172); K2 replaces
keccak_pallas.py:126 keccak256_blocks_pallas (body _make_kernel at :99).
Their CUDA C++ sources are csrc/segment_keccak.cu and csrc/keccak_blocks.cu,
sharing the permutation in csrc/keccak_f.cuh; each header states the design
and what bounds it on an H100 (integer-ALU throughput: about 4.35k 32-bit
ops per 136-byte block absorbed, 0.26 ns against 0.041 ns of memory time
per lane-block).

Each is built at first use with
    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v
into coreth_tpu_torch/_build/lib<name>.so (a plain C entry point loaded
with ctypes; ptxas's register report in the .log beside it), and launched
on torch.cuda.current_stream().

Both take the u32 words as an int32 tensor with the same bits (torch's
uint32 op coverage is thin). A CPU tensor goes to the kernel's plain torch
version; a CUDA tensor launches the kernel or raises. `launches` counts K1
launches and `blocks_launches` K2 launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import List

import torch

from ..native._build import BUILD_DIR, build_and_load
from .keccak_staged import segment_keccak_plain
from .keccak_torch import WORDS_PER_BLOCK, keccak256_blocks_plain

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches = 0          # K1
blocks_launches = 0   # K2


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    return path


class _Kernel:
    """One CUDA source built into its own library at first use; `load()`
    returns its launch function with argtypes set."""

    def __init__(self, source: str, symbol: str, argtypes: List):
        self.src = os.path.join(_CSRC, source)
        self.lib_name = f"lib{os.path.splitext(source)[0]}.so"
        self._symbol = symbol
        self._argtypes = argtypes
        self._lock = threading.Lock()
        self._fn = None

    def load(self):
        """Build (if stale) and load; returns the C launch function."""
        if self._fn is not None:
            return self._fn
        with self._lock:
            if self._fn is None:
                lib = build_and_load([_nvcc(), *NVCC_FLAGS], [self.src],
                                     self.lib_name, timeout=600)
                fn = getattr(lib, self._symbol)
                fn.argtypes = self._argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
        return self._fn

    def build_log(self) -> str:
        """The compiler output of the last build (ptxas registers, spills)."""
        path = os.path.join(BUILD_DIR, self.lib_name + ".log")
        if not os.path.exists(path):
            return ""
        with open(path) as f:
            return f.read()


_P = ctypes.c_void_p
K1 = _Kernel("segment_keccak.cu", "segment_keccak_launch",
             [_P, _P, ctypes.c_longlong, ctypes.c_int, _P])
K2 = _Kernel("keccak_blocks.cu", "keccak_blocks_launch",
             [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P])


def _check_words(fn: str, words) -> None:
    if not isinstance(words, torch.Tensor):
        raise TypeError(f"{fn} takes a torch.Tensor")
    if words.dtype != torch.int32:
        raise TypeError(f"{fn} takes int32 words, got {words.dtype}")
    if words.dim() != 3 or words.shape[2] != WORDS_PER_BLOCK:
        raise ValueError(
            f"{fn} takes [B, L, 34] words, got {tuple(words.shape)}")
    if words.shape[1] < 1:
        raise ValueError(f"{fn} needs at least one block per lane")
    if not words.is_contiguous():
        raise ValueError(f"{fn} takes contiguous words")
    if words.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{fn} cannot run on {words.device}")


def _launch(kernel: _Kernel, name: str, device, *args) -> None:
    fn = kernel.load()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def segment_keccak(words: torch.Tensor) -> torch.Tensor:
    """int32[P, L, 34] (u32 bits) -> int32[P, 8]: K1 on CUDA, the plain
    torch version for a CPU tensor."""
    global launches
    _check_words("segment_keccak", words)
    if words.device.type == "cpu":
        return segment_keccak_plain(words)
    p, blocks, _ = words.shape
    out = torch.empty((p, 8), dtype=torch.int32, device=words.device)
    if p == 0:
        return out
    _launch(K1, "segment_keccak", words.device, words.data_ptr(),
            out.data_ptr(), p, blocks)
    launches += 1
    return out


def keccak256_blocks(words: torch.Tensor,
                     nblocks: torch.Tensor) -> torch.Tensor:
    """int32[B, L, 34] (u32 bits) + int32[B] block counts -> int32[B, 8]:
    K2 on CUDA, keccak256_blocks_plain for CPU tensors. A lane whose count
    is outside [1, L] gets an all-zero digest, as on the TPU."""
    global blocks_launches
    _check_words("keccak256_blocks", words)
    if not isinstance(nblocks, torch.Tensor):
        raise TypeError("keccak256_blocks takes nblocks as a torch.Tensor")
    if nblocks.dtype != torch.int32:
        raise TypeError(
            f"keccak256_blocks takes int32 nblocks, got {nblocks.dtype}")
    if nblocks.dim() != 1 or nblocks.shape[0] != words.shape[0]:
        raise ValueError(
            f"keccak256_blocks takes nblocks [B] for words "
            f"{tuple(words.shape)}, got {tuple(nblocks.shape)}")
    if not nblocks.is_contiguous():
        raise ValueError("keccak256_blocks takes contiguous nblocks")
    if nblocks.device != words.device:
        raise ValueError(
            f"keccak256_blocks: words on {words.device}, nblocks on "
            f"{nblocks.device}")
    if words.device.type == "cpu":
        return keccak256_blocks_plain(words, nblocks)
    b, blocks, _ = words.shape
    out = torch.empty((b, 8), dtype=torch.int32, device=words.device)
    if b == 0:
        return out
    _launch(K2, "keccak256_blocks", words.device, words.data_ptr(),
            nblocks.data_ptr(), out.data_ptr(), b, blocks)
    blocks_launches += 1
    return out
