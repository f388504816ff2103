"""A plain secp256k1 signer for the harness's transactions, in Python
integers, with nothing of the port: the VM mix's inputs are signed
before the port is imported, as a wallet signs before its node sees a
transaction.

k * G is a fixed-base comb: the table holds d * 256**w * G (affine) for
every byte position w and byte value d, so one multiplication is 32
mixed Jacobian additions and one inversion. The nonce k is
deterministic: HMAC-SHA256 of the key and the message hash, hashed again
until it falls in [1, n) (the construction of RFC 6979 reduced to its
first candidate, which is all a deterministic harness needs). s is
normalised to the lower half (EIP-2), with the recovery bit flipped to
match.

Keccak-256 of the public key (the address) and of the signing payload
is the caller's (portbench/reference/keccak.py, batched).
"""

from __future__ import annotations

import hashlib
import hmac

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

_TABLE: list = []  # [w][d] -> (x, y) or None, built on first use


def _affine_add(p1, p2):
    """Sum of two affine points (None is the point at infinity)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return x3, (lam * (x1 - x3) - y1) % P


def _table() -> list:
    if not _TABLE:
        base = (GX, GY)
        for _ in range(32):
            row = [None]
            for _d in range(1, 256):
                row.append(_affine_add(row[-1], base))
            _TABLE.append(row)
            base = _affine_add(row[255], base)  # 256 * base
    return _TABLE


def _jacobian_double(x, y, z):
    if y == 0:
        return 0, 1, 0
    ysq = y * y % P
    s = 4 * x * ysq % P
    m = 3 * x * x % P
    x3 = (m * m - 2 * s) % P
    return x3, (m * (s - x3) - 8 * ysq * ysq) % P, 2 * y * z % P


def _mixed_add(x1, y1, z1, x2, y2):
    """(x1, y1, z1) Jacobian + (x2, y2) affine."""
    if z1 == 0:
        return x2, y2, 1
    z1z1 = z1 * z1 % P
    u2 = x2 * z1z1 % P
    s2 = y2 * z1 * z1z1 % P
    h = (u2 - x1) % P
    r = (s2 - y1) % P
    if h == 0:
        if r == 0:
            return _jacobian_double(x1, y1, z1)
        return 0, 1, 0
    hh = h * h % P
    hhh = h * hh % P
    v = x1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    y3 = (r * (v - x3) - y1 * hhh) % P
    return x3, y3, z1 * h % P


def base_mul(k: int):
    """k * G as an affine point (k in [1, n))."""
    table = _table()
    x, y, z = 0, 1, 0
    for w in range(32):
        d = (k >> (8 * w)) & 0xFF
        if d:
            px, py = table[w][d]
            x, y, z = _mixed_add(x, y, z, px, py)
    if z == 0:
        raise ValueError("k * G is the point at infinity")
    zi = pow(z, -1, P)
    zi2 = zi * zi % P
    return x * zi2 % P, y * zi2 * zi % P


def public_key(priv: bytes) -> bytes:
    """The 64-byte uncompressed public key (x || y) of a private key."""
    d = int.from_bytes(priv, "big")
    if not 1 <= d < N:
        raise ValueError("private key out of range")
    x, y = base_mul(d)
    return x.to_bytes(32, "big") + y.to_bytes(32, "big")


def _nonce(priv: bytes, digest: bytes) -> int:
    t = hmac.new(priv, digest, hashlib.sha256).digest()
    while True:
        k = int.from_bytes(t, "big")
        if 1 <= k < N:
            return k
        t = hashlib.sha256(t).digest()


def sign(priv: bytes, digest: bytes):
    """(y parity, r, s) of the 32-byte message hash `digest`, s in the
    lower half of the order."""
    d = int.from_bytes(priv, "big")
    z = int.from_bytes(digest, "big")
    while True:
        k = _nonce(priv, digest)
        x, y = base_mul(k)
        r = x % N
        s = pow(k, -1, N) * (z + r * d) % N
        if r and s:
            break
        digest = hashlib.sha256(digest).digest()  # never in practice
    parity = y & 1
    if s > N // 2:
        s = N - s
        parity ^= 1
    return parity, r, s
