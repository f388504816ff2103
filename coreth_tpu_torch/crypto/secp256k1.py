"""secp256k1 sign/recover (role of the reference's cgo libsecp256k1 +
decred pure-Go fallback — SURVEY.md §2.6 item 2).

Pure-Python Jacobian-coordinate implementation. Correctness-critical path;
the batched sender-recovery seam (core/sender_cacher.go:88) dispatches here
and can later swap in a native backend without API change.

Counterpart of coreth_tpu/crypto/secp256k1.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..native import keccak256

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
A = 0
B = 7


def _inv(a: int, m: int) -> int:
    return pow(a, m - 2, m)


# Jacobian point ops: (X, Y, Z) with x = X/Z^2, y = Y/Z^3; None = infinity.

def _jdouble(p):
    if p is None:
        return None
    X, Y, Z = p
    if Y == 0:
        return None
    S = (4 * X * Y * Y) % P
    M = (3 * X * X) % P  # a == 0
    X2 = (M * M - 2 * S) % P
    Y2 = (M * (S - X2) - 8 * Y * Y * Y * Y) % P
    Z2 = (2 * Y * Z) % P
    return (X2, Y2, Z2)


def _jadd(p, q):
    if p is None:
        return q
    if q is None:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = (Z1 * Z1) % P
    Z2Z2 = (Z2 * Z2) % P
    U1 = (X1 * Z2Z2) % P
    U2 = (X2 * Z1Z1) % P
    S1 = (Y1 * Z2 * Z2Z2) % P
    S2 = (Y2 * Z1 * Z1Z1) % P
    if U1 == U2:
        if S1 != S2:
            return None
        return _jdouble(p)
    H = (U2 - U1) % P
    R = (S2 - S1) % P
    HH = (H * H) % P
    HHH = (H * HH) % P
    V = (U1 * HH) % P
    X3 = (R * R - HHH - 2 * V) % P
    Y3 = (R * (V - X3) - S1 * HHH) % P
    Z3 = (H * Z1 * Z2) % P
    return (X3, Y3, Z3)


def _jmul(p, k: int):
    if k % N == 0 or p is None:
        return None
    result = None
    addend = p
    while k:
        if k & 1:
            result = _jadd(result, addend)
        addend = _jdouble(addend)
        k >>= 1
    return result


def _to_affine(p) -> Optional[Tuple[int, int]]:
    if p is None:
        return None
    X, Y, Z = p
    zi = _inv(Z, P)
    zi2 = (zi * zi) % P
    return (X * zi2) % P, (Y * zi2 * zi) % P


_G = (GX, GY, 1)


def _lift_x(x: int, odd: bool) -> Optional[Tuple[int, int]]:
    y2 = (pow(x, 3, P) + B) % P
    y = pow(y2, (P + 1) // 4, P)
    if (y * y) % P != y2:
        return None
    if (y & 1) != odd:
        y = P - y
    return (x, y)


def ecrecover(msg_hash: bytes, v: int, r: int, s: int) -> Optional[bytes]:
    """Recover the 64-byte uncompressed pubkey (no 0x04 prefix).

    v is the recovery id (0..3). Returns None on invalid signature.
    """
    if not (1 <= r < N and 1 <= s < N and 0 <= v <= 3):
        return None
    x = r + (v >> 1) * N
    if x >= P:
        return None
    Rp = _lift_x(x, bool(v & 1))
    if Rp is None:
        return None
    e = int.from_bytes(msg_hash, "big") % N
    r_inv = _inv(r, N)
    # Q = r^-1 (s*R - e*G)
    pt = _jadd(
        _jmul((Rp[0], Rp[1], 1), s),
        _jmul(_G, (N - e) % N),
    )
    Q = _to_affine(_jmul(pt, r_inv))
    if Q is None:
        return None
    return Q[0].to_bytes(32, "big") + Q[1].to_bytes(32, "big")


def sign(msg_hash: bytes, priv: bytes) -> Tuple[int, int, int]:
    """Deterministic-ish sign: returns (v, r, s) with low-s normalization.

    Nonce is derived RFC-6979-style from keccak (not the HMAC-SHA256 of the
    RFC — this signer exists for tests and local tooling, not consensus).
    """
    d = int.from_bytes(priv, "big")
    if not (1 <= d < N):
        raise ValueError("invalid private key")
    e = int.from_bytes(msg_hash, "big") % N
    k = 0
    counter = 0
    while True:
        k = int.from_bytes(
            keccak256(priv + msg_hash + counter.to_bytes(4, "big")), "big"
        ) % N
        if k == 0:
            counter += 1
            continue
        R = _to_affine(_jmul(_G, k))
        r = R[0] % N
        if r == 0:
            counter += 1
            continue
        s = (_inv(k, N) * (e + r * d)) % N
        if s == 0:
            counter += 1
            continue
        v = (R[1] & 1) | (2 if R[0] >= N else 0)
        if s > N // 2:
            s = N - s
            v ^= 1
        return v, r, s


def pubkey(priv: bytes) -> bytes:
    d = int.from_bytes(priv, "big")
    Q = _to_affine(_jmul(_G, d))
    return Q[0].to_bytes(32, "big") + Q[1].to_bytes(32, "big")


def pubkey_to_address(pub64: bytes) -> bytes:
    return keccak256(pub64)[12:]


def priv_to_address(priv: bytes) -> bytes:
    return pubkey_to_address(pubkey(priv))


def recover_address(msg_hash: bytes, v: int, r: int, s: int) -> Optional[bytes]:
    pub = ecrecover(msg_hash, v, r, s)
    return pubkey_to_address(pub) if pub is not None else None
