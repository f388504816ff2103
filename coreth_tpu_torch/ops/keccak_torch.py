"""Keccak-256 in plain torch: the counterpart of coreth_tpu/ops/keccak_jax.py.

Layout (identical to the JAX package's): messages are packed, already
keccak-padded, into little-endian 32-bit words uint32[B, L, 34] (L rate
blocks of 136 bytes); digests come back as uint32[B, 8], the lo/hi words
of state lanes 0-3.

torch on the CPU implements no `<<`, `>>`, `~` or add for uint32/uint64, so
this path carries each 64-bit Keccak lane in int64 (same bits, two's
complement) and does logical right shifts by masking after the arithmetic
shift. u32 words travel as int32 tensors holding the same bits
(`words_to_int32` / `int32_to_words` convert at the numpy boundary).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .keccak_ref import _ROTC, _ROUND_CONSTANTS

RATE = 136
WORDS_PER_BLOCK = RATE // 4  # 34 uint32 words

MASK32 = 0xFFFFFFFF
_SIGN32 = 0x80000000


def _i64(v: int) -> int:
    """Unsigned 64-bit constant -> the int64 with the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


_RC = tuple(_i64(rc) for rc in _ROUND_CONSTANTS)


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Rotate int64 lanes left by a static n (logical right shift by mask)."""
    n %= 64
    if n == 0:
        return x
    return (x << n) | ((x >> (64 - n)) & ((1 << n) - 1))


def keccak_f1600(a: List[torch.Tensor]) -> List[torch.Tensor]:
    """24-round permutation over 25 int64 lane tensors (x + 5*y order)."""
    for rc in _RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b: List[torch.Tensor] = [None] * 25  # type: ignore[list-item]
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y],
                                                         _ROTC[x + 5 * y])
        a = [b[i] ^ (~b[(i % 5 + 1) % 5 + 5 * (i // 5)]
                     & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
             for i in range(25)]
        a[0] = a[0] ^ rc
    return a


def lanes_from_words(block: torch.Tensor) -> List[torch.Tensor]:
    """int32[P, 34] words of one rate block -> 17 int64 lanes [P]."""
    w = block.to(torch.int64) & MASK32
    return [w[:, 2 * i] | (w[:, 2 * i + 1] << 32) for i in range(17)]


def digest_words(a: Sequence[torch.Tensor]) -> torch.Tensor:
    """State lanes 0-3 -> int32[P, 8] (lo, hi of each lane, u32 bits)."""
    cols = []
    for i in range(4):
        cols.append(a[i] & MASK32)
        cols.append((a[i] >> 32) & MASK32)
    return to_int32(torch.stack(cols, dim=1))


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same low 32 bits."""
    return ((x ^ _SIGN32) - _SIGN32).to(torch.int32)


def words_to_int32(words: np.ndarray) -> np.ndarray:
    """numpy uint32 words -> int32 view (no copy)."""
    return np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)


def int32_to_words(t: torch.Tensor) -> np.ndarray:
    """int32 tensor of u32 bits -> numpy uint32 (host copy)."""
    return t.detach().cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# Host-side packing (vectorized numpy; keccak_jax.py:180-218)
# ---------------------------------------------------------------------------

def pack_messages(msgs: Sequence[bytes], lengths: np.ndarray | None = None):
    """Pack messages into (words uint32[B, L, 34], nblocks int32[B]), L being
    the largest block count; shorter lanes are zero beyond their padding."""
    n = len(msgs)
    if lengths is None:
        lengths = np.fromiter((len(m) for m in msgs), dtype=np.int64, count=n)
    nblocks = (lengths // RATE + 1).astype(np.int32)
    max_blocks = int(nblocks.max()) if n else 1
    row = max_blocks * RATE

    buf = np.zeros((n, row), dtype=np.uint8)
    total = int(lengths.sum())
    if total:
        src = np.frombuffer(b"".join(msgs), dtype=np.uint8)
        starts = np.zeros(n, dtype=np.int64)
        np.cumsum(lengths[:-1], out=starts[1:])
        within = np.arange(total, dtype=np.int64) - np.repeat(starts, lengths)
        dest = np.repeat(np.arange(n, dtype=np.int64) * row, lengths) + within
        buf.reshape(-1)[dest] = src
    flat = buf.reshape(-1)
    rows = np.arange(n, dtype=np.int64) * row
    # 0x01 at the first pad byte, 0x80 at the last byte of the final block
    # (|= gives 0x81 when both land on the same byte)
    flat[rows + lengths] = 0x01
    last = rows + nblocks.astype(np.int64) * RATE - 1
    flat[last] |= 0x80
    words = buf.view("<u4").reshape(n, max_blocks, WORDS_PER_BLOCK)
    return words, nblocks


def digest_words_to_bytes(out: np.ndarray) -> list:
    """uint32[B, 8] -> list of 32-byte digests."""
    raw = np.ascontiguousarray(out).astype("<u4", copy=False).tobytes()
    return [raw[i * 32:(i + 1) * 32] for i in range(out.shape[0])]
