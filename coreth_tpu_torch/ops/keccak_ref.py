"""Pure-Python Keccak-256 reference implementation.

This is the golden model for every other keccak backend in the port
(torch, CUDA, C++). It implements the original Keccak padding (0x01), i.e.
the variant Ethereum uses (``sha3.NewLegacyKeccak256`` in coreth's
trie/hasher.go:34,51), NOT NIST SHA3 (0x06 padding).

Intentionally simple and slow — it exists for correctness testing only.
Host-side hashing uses the C++ backend (native/) and device hashing uses
the torch path (ops/keccak_torch.py) and the CUDA kernel (ops/keccak_cuda.py).
"""

from __future__ import annotations

RATE = 136  # bytes: 1088-bit rate for Keccak-256
DIGEST_SIZE = 32

_ROUND_CONSTANTS = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

# Rotation offsets r[x][y] laid out by lane index (x + 5*y).
_ROTC = (
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
)

_MASK = (1 << 64) - 1


def _rotl(value: int, shift: int) -> int:
    if shift == 0:
        return value
    return ((value << shift) | (value >> (64 - shift))) & _MASK


def keccak_f1600(state: list) -> list:
    """One Keccak-f[1600] permutation over 25 64-bit lanes (x + 5*y order)."""
    a = state
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                # B[y, 2x+3y] = rot(A[x, y], r[x, y])
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], _ROTC[x + 5 * y])
        # chi
        a = [
            b[i] ^ ((~b[(i % 5 + 1) % 5 + 5 * (i // 5)]) & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
            for i in range(25)
        ]
        a = [v & _MASK for v in a]
        # iota
        a[0] ^= rc
    return a


def keccak_pad(data: bytes, rate: int = RATE) -> bytes:
    """Multi-rate padding with Keccak domain bit 0x01 (legacy, as Ethereum)."""
    pad_len = rate - (len(data) % rate)
    if pad_len == 1:
        return data + b"\x81"
    return data + b"\x01" + b"\x00" * (pad_len - 2) + b"\x80"


def keccak256(data: bytes) -> bytes:
    """Keccak-256 digest (Ethereum flavor) of ``data``."""
    padded = keccak_pad(data)
    state = [0] * 25
    for off in range(0, len(padded), RATE):
        block = padded[off:off + RATE]
        for i in range(RATE // 8):
            state[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        state = keccak_f1600(state)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out[:DIGEST_SIZE]
