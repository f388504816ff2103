"""Kernel K1, segment Keccak-256, on Hopper: build, bind and call.

Replaces the TPU kernel coreth_tpu/ops/keccak_pallas.py:211
segment_keccak_pallas (body _make_segment_kernel at :172). The CUDA C++
source is csrc/segment_keccak.cu; its header states the design and what
bounds it on an H100 (integer-ALU throughput: about 4.35k 32-bit ops per
136-byte block, 0.26 ns against 0.041 ns of memory time per lane-block).

Built at first use with
    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v
into coreth_tpu_torch/_build/libsegment_keccak.so (a plain C entry point
loaded with ctypes; ptxas's register report in the .log beside it), and
launched on torch.cuda.current_stream().

`segment_keccak(words)` takes the u32 words as an int32 tensor with the
same bits (torch's uint32 op coverage is thin). A CPU tensor goes to the
plain torch version; a CUDA tensor launches K1 or raises. `launches`
counts K1 launches and nothing else.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import torch

from ..native._build import build_and_load
from .keccak_staged import segment_keccak_plain
from .keccak_torch import WORDS_PER_BLOCK

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "segment_keccak.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches = 0

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    return path


def load() -> ctypes.CDLL:
    """Build (if stale) and load K1's library."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = build_and_load([_nvcc(), *NVCC_FLAGS], [_SRC],
                                 "libsegment_keccak.so", timeout=600)
            fn = lib.segment_keccak_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def build_log() -> str:
    """The compiler output of K1's last build (ptxas registers, spills)."""
    from ..native._build import BUILD_DIR

    path = os.path.join(BUILD_DIR, "libsegment_keccak.so.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def _check(words: torch.Tensor) -> None:
    if not isinstance(words, torch.Tensor):
        raise TypeError("segment_keccak takes a torch.Tensor")
    if words.dtype != torch.int32:
        raise TypeError(f"segment_keccak takes int32 words, got {words.dtype}")
    if words.dim() != 3 or words.shape[2] != WORDS_PER_BLOCK:
        raise ValueError(
            f"segment_keccak takes [P, L, 34] words, got {tuple(words.shape)}")
    if words.shape[1] < 1:
        raise ValueError("segment_keccak needs at least one block per lane")
    if not words.is_contiguous():
        raise ValueError("segment_keccak takes contiguous words")
    if words.device.type not in ("cuda", "cpu"):
        raise ValueError(f"segment_keccak cannot run on {words.device}")


def segment_keccak(words: torch.Tensor) -> torch.Tensor:
    """int32[P, L, 34] (u32 bits) -> int32[P, 8]: K1 on CUDA, the plain
    torch version for a CPU tensor."""
    global launches
    _check(words)
    if words.device.type == "cpu":
        return segment_keccak_plain(words)
    p, blocks, _ = words.shape
    out = torch.empty((p, 8), dtype=torch.int32, device=words.device)
    if p == 0:
        return out
    lib = load()
    stream = torch.cuda.current_stream(words.device).cuda_stream
    with torch.cuda.device(words.device):
        err = lib.segment_keccak_launch(words.data_ptr(), out.data_ptr(), p,
                                        blocks, stream)
    if err != 0:
        raise RuntimeError(f"segment_keccak launch failed: CUDA error {err}")
    launches += 1
    return out
