"""ctypes wrapper for the native batched secp256k1 recovery
(secp256k1.cpp), the sender-cacher backend (semantics of coreth
core/sender_cacher.go:88-115 over cgo libsecp256k1); counterpart of
coreth_tpu/native/secp.py.

`recover_batch` takes parallel arrays for the whole tx slice and returns
the addresses, None where a signature is invalid. Built with g++ into
coreth_tpu_torch/_build/ at first use. Unlike the reference, whose loader
returns None on a failed build so that `Signer.sender` drifts to pure
Python, a failed build raises here (native/_build.py). The pure-Python
`crypto.secp256k1` stays the tests' oracle and is reached only by an
explicit call.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import CXX_FLAGS, keccak256
from ._build import build_and_load

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "secp256k1.cpp")

_lock = threading.Lock()
_lib = None


def load() -> ctypes.CDLL:
    """Return the ctypes library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = build_and_load(CXX_FLAGS, [_SRC], "libsecp256k1.so",
                                 link=["-lpthread"], timeout=300)
            lib.secp_recover_batch.restype = None
            lib.secp_recover_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_uint64, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            lib.secp_pubkey_recover_one.restype = ctypes.c_int
            lib.secp_pubkey_recover_one.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p,
            ]
            _lib = lib
    return _lib


def recover_batch(
    items: Sequence[Tuple[bytes, int, int, int]], threads: int = 0
) -> List[Optional[bytes]]:
    """items: (msg_hash32, recid, r, s) per signature. Returns the 20-byte
    sender address per item, None where the signature is invalid."""
    lib = load()
    n = len(items)
    if n == 0:
        return []
    msgs = np.empty((n, 32), np.uint8)
    sigs = np.empty((n, 64), np.uint8)
    recids = np.empty(n, np.int32)
    for i, (mh, recid, r, s) in enumerate(items):
        msgs[i] = np.frombuffer(mh, np.uint8)
        if 0 <= r < 2**256 and 0 <= s < 2**256 and 0 <= recid <= 3:
            sigs[i, :32] = np.frombuffer(r.to_bytes(32, "big"), np.uint8)
            sigs[i, 32:] = np.frombuffer(s.to_bytes(32, "big"), np.uint8)
            recids[i] = recid
        else:
            sigs[i] = 0  # r==0 -> flagged invalid by the native side
            recids[i] = 0
    addrs = np.empty((n, 20), np.uint8)
    ok = np.empty(n, np.uint8)
    lib.secp_recover_batch(
        msgs.ctypes.data_as(ctypes.c_void_p),
        sigs.ctypes.data_as(ctypes.c_void_p),
        recids.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_uint64(n), ctypes.c_int(threads),
        addrs.ctypes.data_as(ctypes.c_void_p),
        ok.ctypes.data_as(ctypes.c_void_p),
    )
    return [addrs[i].tobytes() if ok[i] else None for i in range(n)]


def recover_one(msg_hash: bytes, recid: int, r: int, s: int) -> Optional[bytes]:
    """One signature -> 20-byte address, or None if invalid."""
    lib = load()
    if not (0 < r < 2**256 and 0 < s < 2**256 and 0 <= recid <= 3):
        return None
    sig = r.to_bytes(32, "big") + s.to_bytes(32, "big")
    pub = ctypes.create_string_buffer(64)
    ok = lib.secp_pubkey_recover_one(msg_hash, sig, ctypes.c_int(recid), pub)
    if not ok:
        return None
    return keccak256(pub.raw)[12:]
