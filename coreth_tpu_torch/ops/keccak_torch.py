"""Keccak-256 in plain torch and the batch host dispatch: the counterpart
of coreth_tpu/ops/keccak_jax.py.

Layout (identical to the JAX package's): messages are packed, already
keccak-padded, into little-endian 32-bit words uint32[B, L, 34] (L rate
blocks of 136 bytes) plus int32[B] block counts; digests come back as
uint32[B, 8], the lo/hi words of state lanes 0-3.

`keccak256_blocks_plain` is kernel K2's plain version; `BatchedKeccak`
buckets a message list by block count and runs each bucket through K2
(ops/keccak_cuda.keccak256_blocks) on its device.

torch on the CPU implements no `<<`, `>>`, `~` or add for uint32/uint64, so
this path carries each 64-bit Keccak lane in int64 (same bits, two's
complement) and does logical right shifts by masking after the arithmetic
shift. u32 words travel as int32 tensors holding the same bits
(`words_to_int32` / `int32_to_words` convert at the numpy boundary).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve
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


def keccak256_blocks_plain(words: torch.Tensor,
                           nblocks: torch.Tensor) -> torch.Tensor:
    """int32[B, L, 34] (u32 bits) + int32[B] -> int32[B, 8]; kernel K2's
    plain version, the counterpart of keccak_jax.py:keccak256_blocks.

    Masked as there: lane i absorbs block j only while j < nblocks[i], every
    lane is permuted L times, and the digest is snapshotted at
    j == nblocks[i] - 1. A lane with nblocks[i] <= 0 or > L is never
    snapshotted and keeps an all-zero digest."""
    if words.dim() != 3 or words.shape[2] != WORDS_PER_BLOCK:
        raise ValueError(f"expected [B, L, 34] words, got {tuple(words.shape)}")
    b, blocks, _ = words.shape
    nb = nblocks.to(torch.int64)
    zero = torch.zeros(b, dtype=torch.int64, device=words.device)
    a = [zero] * 25
    out = torch.zeros((b, 8), dtype=torch.int32, device=words.device)
    for j in range(blocks):
        live = j < nb
        lanes = lanes_from_words(words[:, j])
        a = [a[i] ^ torch.where(live, lanes[i], zero) for i in range(17)] \
            + a[17:]
        a = keccak_f1600(a)
        out = torch.where((nb == j + 1)[:, None], digest_words(a), out)
    return out


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


# ---------------------------------------------------------------------------
# Batch host dispatch (keccak_jax.py:221-293)
# ---------------------------------------------------------------------------

# the least bucket of _pad_batch, as in the JAX package's BatchedKeccak
_BATCH_MULTIPLE = 128


def _pad_batch(words: np.ndarray, nblocks: np.ndarray,
               multiple: int = _BATCH_MULTIPLE):
    """Pad the batch dim to a power-of-two bucket (>= multiple), as
    keccak_jax.py:_pad_batch does, so both packages hand the kernel the
    same batch. Padded lanes get nblocks=1: they absorb one all-zero block,
    and callers drop their digests via [:real]."""
    b = words.shape[0]
    target = multiple
    while target < b:
        target *= 2
    pad = target - b
    if pad:
        words = np.concatenate(
            [words, np.zeros((pad,) + words.shape[1:], dtype=words.dtype)])
        nblocks = np.concatenate([nblocks, np.ones(pad, dtype=nblocks.dtype)])
    return words, nblocks, b


class BatchedKeccak:
    """Host dispatcher (keccak_jax.py:BatchedKeccak): bucket messages by the
    next power of two of their block count, pad the block axis to the
    bucket and the batch with _pad_batch, run `impl` once per bucket on
    `device` and drop the padding.

    impl: int32[B, L, 34] + int32[B] -> int32[B, 8] (default
    ops/keccak_cuda.keccak256_blocks: K2 for CUDA tensors, the plain version
    for CPU ones). `device` follows device.resolve: None is CUDA.

    Totals over every digests() call, plain integers for the caller:
    calls, launches (impl calls, one per bucket), lanes (real messages),
    padded_lanes (lanes handed to impl), h2d_bytes (words + block counts
    uploaded), and device_ms, CUDA-event time from each bucket's upload
    through its digest readback (None on the CPU)."""

    def __init__(self, impl=None, device: DeviceLike = None):
        if impl is None:
            from .keccak_cuda import keccak256_blocks as impl
        self.impl = impl
        self.device = resolve(device)
        self.reset_totals()

    def reset_totals(self) -> None:
        self.calls = self.launches = self.lanes = self.padded_lanes = 0
        self.h2d_bytes = 0
        self.device_ms: Optional[float] = (
            0.0 if self.device.type == "cuda" else None)

    def _run(self, words: np.ndarray, nblocks: np.ndarray) -> np.ndarray:
        """One bucket: upload, impl, read back uint32[B, 8]."""
        cuda = self.device.type == "cuda"
        if cuda:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
        w = torch.from_numpy(words_to_int32(words)).to(self.device)
        nb = torch.from_numpy(
            np.ascontiguousarray(nblocks, dtype=np.int32)).to(self.device)
        res = int32_to_words(self.impl(w, nb))
        if cuda:
            t1.record()
            t1.synchronize()
            self.device_ms += t0.elapsed_time(t1)
        self.launches += 1
        self.padded_lanes += words.shape[0]
        self.h2d_bytes += w.numel() * 4 + nb.numel() * 4
        return res

    def digests(self, msgs: Sequence[bytes]) -> list:
        n = len(msgs)
        if n == 0:
            return []
        self.calls += 1
        self.lanes += n
        lengths = np.fromiter((len(m) for m in msgs), dtype=np.int64, count=n)
        blocks_needed = lengths // RATE + 1
        out = [None] * n
        # bucket boundary = next power of two of block count
        keys = np.maximum(
            1, 1 << np.ceil(np.log2(np.maximum(blocks_needed, 1))).astype(
                np.int64))
        for key in np.unique(keys):
            (idx,) = np.nonzero(keys == key)
            words, nblocks = pack_messages([msgs[i] for i in idx],
                                           lengths[idx])
            if words.shape[1] < key:  # pad the block axis to the bucket
                extra = np.zeros((words.shape[0], int(key) - words.shape[1],
                                  WORDS_PER_BLOCK), dtype=words.dtype)
                words = np.concatenate([words, extra], axis=1)
            words, nblocks, real = _pad_batch(words, nblocks)
            digs = digest_words_to_bytes(self._run(words, nblocks)[:real])
            for i, d in zip(idx, digs):
                out[i] = d
        return out


_default: Dict[str, BatchedKeccak] = {}


def default_batched_keccak(device: DeviceLike = None) -> BatchedKeccak:
    """The per-device BatchedKeccak with the default impl."""
    d = resolve(device)
    bk = _default.get(str(d))
    if bk is None:
        bk = _default[str(d)] = BatchedKeccak(device=d)
    return bk


def keccak256_batch(msgs: Sequence[bytes], device: DeviceLike = None) -> list:
    """Hash a batch of byte strings on `device` (None: CUDA)."""
    return default_batched_keccak(device).digests(msgs)
