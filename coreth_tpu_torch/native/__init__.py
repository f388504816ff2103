"""Native (C++) host Keccak-256, loaded over ctypes, and the worker
fan-out policy of the native commit planners (native/mpt.py).

Counterpart of coreth_tpu/native/__init__.py (default_cpu_threads at :27,
the keccak loader at :44-106). Built with g++ into coreth_tpu_torch/_build/
at first use. A failed build raises: the secure-key hashing and the CPU
oracle at a million accounts need the native hash, and pure Python is
about 1000x slower.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ._build import build_and_load

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "keccak.cpp")
CXX_FLAGS = ["g++", "-O3", "-march=native", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None


def default_cpu_threads() -> int:
    """Worker fan-out for the native commit pipeline: the
    CORETH_TPU_CPU_THREADS env override, else min(16, cpu_count), the
    reference's 16-goroutine cap (trie/hasher.go:124-139). The same policy
    as mpt_pool.h's C-side default."""
    raw = os.environ.get("CORETH_TPU_CPU_THREADS", "")
    if raw:
        try:
            v = int(raw)
            if v > 0:
                return v
        except ValueError:
            pass
    return min(16, os.cpu_count() or 1)


def load() -> ctypes.CDLL:
    """Return the ctypes library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = build_and_load(CXX_FLAGS, [_SRC], "libkeccak.so",
                                 link=["-lpthread"], timeout=300)
            lib.keccak256.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
            ]
            lib.keccak256_batch.argtypes = [
                ctypes.c_char_p,
                np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
                ctypes.c_uint64,
                ctypes.c_char_p,
            ]
            lib.keccak256_batch_mt.argtypes = (
                lib.keccak256_batch.argtypes + [ctypes.c_int])
            _lib = lib
    return _lib


_OUT32 = ctypes.c_char * 32


def keccak256(data: bytes) -> bytes:
    lib = _lib if _lib is not None else load()
    out = _OUT32()
    lib.keccak256(data, len(data), out)
    return out.raw


def keccak256_batch(msgs, threads: int = 0) -> list:
    """Hash a list of byte strings on the CPU; threads<=1 is single-thread."""
    n = len(msgs)
    if n == 0:
        return []
    lib = load()
    blob = b"".join(msgs)
    offsets = np.zeros(n + 1, dtype=np.uint64)
    np.cumsum(np.fromiter((len(m) for m in msgs), np.uint64, count=n),
              out=offsets[1:])
    out = ctypes.create_string_buffer(32 * n)
    if threads and threads > 1:
        lib.keccak256_batch_mt(blob, offsets, n, out, threads)
    else:
        lib.keccak256_batch(blob, offsets, n, out)
    raw = out.raw
    return [raw[32 * i:32 * i + 32] for i in range(n)]
