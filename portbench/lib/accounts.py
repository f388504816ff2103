"""Account leaves in bulk: the RLP of a C-Chain account, [nonce, balance,
storage root, code hash, is-multicoin] (coreth's StateAccount; the
multicoin flag false here), for many accounts at once, in NumPy, and the
(key, value) byte pairs the port's tries take.

A balance is two uint64 limbs (hi, lo), so it may exceed 2**64 wei as
real balances do; a nonce is one uint64.
"""

from __future__ import annotations

import numpy as np

EMPTY_ROOT = bytes.fromhex(
    "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421")
EMPTY_CODE_HASH = bytes.fromhex(
    "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
# list header, nonce, balance, root, code hash and the multicoin flag
WIDTH = 2 + 9 + 17 + 66 + 1


def _be(x: np.ndarray) -> np.ndarray:
    """uint64 [n] -> uint8 [n, 8] big-endian."""
    return x.astype(">u8").view(np.uint8).reshape(-1, 8)


def _int_field(be: np.ndarray):
    """RLP string of each big-endian unsigned integer in the rows of `be`
    (minimal: no leading zero; 0 is the empty string), right-aligned in a
    field of w + 1 bytes: (field uint8 [n, w + 1], length int64 [n])."""
    n, w = be.shape
    nz = be != 0
    lead = np.where(nz.any(1), nz.argmax(1), w)
    nbytes = w - lead
    first = be[np.arange(n), np.minimum(lead, w - 1)]
    single = (nbytes == 1) & (first < 0x80)
    field = np.zeros((n, w + 1), np.uint8)
    field[:, 1:] = be
    prefix = w - nbytes  # the column before the integer's first byte
    field[np.arange(n), prefix] = np.where(single, 0, 0x80 + nbytes)
    return field, nbytes + (~single)


def encode(nonce, bal_hi, bal_lo, root, code_hash):
    """uint8 [n, WIDTH] rows and int64 [n] lengths of each account's RLP.
    root and code_hash: uint8 [n, 32]."""
    n = nonce.shape[0]
    nf, ln = _int_field(_be(nonce))
    bf, lb = _int_field(np.concatenate((_be(bal_hi), _be(bal_lo)), 1))
    out = np.zeros((n, WIDTH), np.uint8)
    out[:, 0] = 0xF8
    out[:, 1] = ln + lb + 67
    # rows grouped by their two integers' lengths: each group's fields
    # land at the same offsets
    key = ln * 32 + lb
    for k in np.unique(key):
        sel = np.nonzero(key == k)[0]
        a, b = int(k) // 32, int(k) % 32
        out[sel, 2:2 + a] = nf[sel, 9 - a:]
        out[sel, 2 + a:2 + a + b] = bf[sel, 17 - b:]
        p = 2 + a + b
        out[sel, p] = 0xA0
        out[sel, p + 1:p + 33] = root[sel]
        out[sel, p + 33] = 0xA0
        out[sel, p + 34:p + 66] = code_hash[sel]
        out[sel, p + 66] = 0x80  # false
    return out, (ln + lb + 69).astype(np.int64)


def key_list(keys: np.ndarray) -> list:
    """Each 32-byte key row as a bytes object."""
    blob = keys.tobytes()
    return [blob[i:i + 32] for i in range(0, len(blob), 32)]


def byte_list(rows: np.ndarray, lens: np.ndarray) -> list:
    """Each row's first lens[i] bytes as a bytes object."""
    w = rows.shape[1]
    keep = np.arange(w)[None, :] < lens[:, None]
    blob = rows[keep].tobytes()
    off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    return [blob[a:b] for a, b in zip(off[:-1].tolist(), off[1:].tolist())]
