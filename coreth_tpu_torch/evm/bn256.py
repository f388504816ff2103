"""alt_bn128 (BN254) curve ops for precompiles 0x06-0x08.

Pure-Python implementation of G1 add/scalar-mul and the optimal ate pairing
check (role of the reference's precompiles via github.com/ethereum/go-ethereum
/crypto/bn256). Field towers: Fp2 = Fp[u]/(u^2+1), Fp12 = Fp2[w]/(w^6 - (9+u)).

Counterpart of coreth_tpu/evm/bn256.py.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
N = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# curve: y^2 = x^3 + 3;  twist: y^2 = x^3 + 3/(9+u)


def _inv(a: int, m: int = P) -> int:
    return pow(a, m - 2, m)


# --- G1 -----------------------------------------------------------------

G1Point = Optional[Tuple[int, int]]  # None = infinity


def g1_is_on_curve(pt: G1Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    if x >= P or y >= P:
        return False
    return (y * y - x * x * x - 3) % P == 0


def g1_add(a: G1Point, b: G1Point) -> G1Point:
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * _inv(2 * y1) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_mul(a: G1Point, k: int) -> G1Point:
    out: G1Point = None
    add = a
    while k:
        if k & 1:
            out = g1_add(out, add)
        add = g1_add(add, add)
        k >>= 1
    return out


# --- Fp2 / Fp6 / Fp12 towers -------------------------------------------
# Fp2 elements are (a, b) = a + b*u.

def f2_add(x, y):
    return ((x[0] + y[0]) % P, (x[1] + y[1]) % P)


def f2_sub(x, y):
    return ((x[0] - y[0]) % P, (x[1] - y[1]) % P)


def f2_mul(x, y):
    a = (x[0] * y[0] - x[1] * y[1]) % P
    b = (x[0] * y[1] + x[1] * y[0]) % P
    return (a, b)


def f2_muls(x, s: int):
    return ((x[0] * s) % P, (x[1] * s) % P)


def f2_inv(x):
    d = _inv((x[0] * x[0] + x[1] * x[1]) % P)
    return ((x[0] * d) % P, (-x[1] * d) % P)


def f2_neg(x):
    return ((-x[0]) % P, (-x[1]) % P)


F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (9, 1)  # 9 + u, the sextic twist constant


# Fp12 as pairs of Fp6; Fp6 as triples of Fp2 (c0 + c1*v + c2*v^2, v^3 = xi)

def f6_add(x, y):
    return tuple(f2_add(a, b) for a, b in zip(x, y))


def f6_sub(x, y):
    return tuple(f2_sub(a, b) for a, b in zip(x, y))


def f6_mul(x, y):
    a0, a1, a2 = x
    b0, b1, b2 = y
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    c0 = f2_add(t0, f2_mul(XI, f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)), f2_mul(XI, t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_neg(x):
    return tuple(f2_neg(a) for a in x)


def f6_mul_tau(x):  # multiply by v
    return (f2_mul(XI, x[2]), x[0], x[1])


def f6_inv(x):
    a0, a1, a2 = x
    t0 = f2_sub(f2_mul(a0, a0), f2_mul(XI, f2_mul(a1, a2)))
    t1 = f2_sub(f2_mul(XI, f2_mul(a2, a2)), f2_mul(a0, a1))
    t2 = f2_sub(f2_mul(a1, a1), f2_mul(a0, a2))
    d = f2_add(
        f2_mul(a0, t0),
        f2_mul(XI, f2_add(f2_mul(a2, t1), f2_mul(a1, t2))),
    )
    di = f2_inv(d)
    return (f2_mul(t0, di), f2_mul(t1, di), f2_mul(t2, di))


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f12_mul(x, y):
    a0, a1 = x
    b0, b1 = y
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c0 = f6_add(t0, f6_mul_tau(t1))
    c1 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), f6_add(t0, t1))
    return (c0, c1)


def f12_square(x):
    return f12_mul(x, x)


def f12_inv(x):
    a0, a1 = x
    t = f6_inv(f6_sub(f6_mul(a0, a0), f6_mul_tau(f6_mul(a1, a1))))
    return (f6_mul(a0, t), f6_neg(f6_mul(a1, t)))


def f12_conj(x):
    return (x[0], f6_neg(x[1]))


def f12_pow(x, k: int):
    out = F12_ONE
    base = x
    while k:
        if k & 1:
            out = f12_mul(out, base)
        base = f12_square(base)
        k >>= 1
    return out


F12_ONE = (F6_ONE, F6_ZERO)


# Frobenius coefficients for Fp2: (a+bu)^p = a - bu
def f2_conj(x):
    return (x[0], (-x[1]) % P)


def _f2_pow(x, k):
    out = F2_ONE
    b = x
    while k:
        if k & 1:
            out = f2_mul(out, b)
        b = f2_mul(b, b)
        k >>= 1
    return out


_XI_P_16 = _f2_pow(XI, (P - 1) // 6)
_GAMMA1 = [_f2_pow(_XI_P_16, i) for i in range(6)]
_GAMMA2 = [f2_mul(g, f2_conj(g)) for g in _GAMMA1]
_GAMMA3 = [f2_mul(g1, g2) for g1, g2 in zip(_GAMMA1, _GAMMA2)]


def f12_frobenius(x):
    (c00, c01, c02), (c10, c11, c12) = x
    c00 = f2_conj(c00)
    c01 = f2_mul(f2_conj(c01), _GAMMA1[2])
    c02 = f2_mul(f2_conj(c02), _GAMMA1[4])
    c10 = f2_mul(f2_conj(c10), _GAMMA1[1])
    c11 = f2_mul(f2_conj(c11), _GAMMA1[3])
    c12 = f2_mul(f2_conj(c12), _GAMMA1[5])
    return ((c00, c01, c02), (c10, c11, c12))


def f12_frobenius2(x):
    (c00, c01, c02), (c10, c11, c12) = x
    c01 = f2_mul(c01, _GAMMA2[2])
    c02 = f2_mul(c02, _GAMMA2[4])
    c10 = f2_mul(c10, _GAMMA2[1])
    c11 = f2_mul(c11, _GAMMA2[3])
    c12 = f2_mul(c12, _GAMMA2[5])
    return ((c00, c01, c02), (c10, c11, c12))


def f12_frobenius3(x):
    (c00, c01, c02), (c10, c11, c12) = x
    c00 = f2_conj(c00)
    c01 = f2_mul(f2_conj(c01), _GAMMA3[2])
    c02 = f2_mul(f2_conj(c02), _GAMMA3[4])
    c10 = f2_mul(f2_conj(c10), _GAMMA3[1])
    c11 = f2_mul(f2_conj(c11), _GAMMA3[3])
    c12 = f2_mul(f2_conj(c12), _GAMMA3[5])
    return ((c00, c01, c02), (c10, c11, c12))


# --- G2 (points over Fp2, on the twist) --------------------------------

G2Point = Optional[Tuple[Tuple[int, int], Tuple[int, int]]]

_TWIST_B = f2_mul((3, 0), f2_inv(XI))


def g2_is_on_curve(pt: G2Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    lhs = f2_mul(y, y)
    rhs = f2_add(f2_mul(f2_mul(x, x), x), _TWIST_B)
    return lhs == rhs


def g2_add(a: G2Point, b: G2Point) -> G2Point:
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if f2_add(y1, y2) == F2_ZERO:
            return None
        lam = f2_mul(f2_muls(f2_mul(x1, x1), 3), f2_inv(f2_muls(y1, 2)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_mul(lam, lam), x1), x2)
    y3 = f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul(a: G2Point, k: int) -> G2Point:
    out: G2Point = None
    add = a
    while k:
        if k & 1:
            out = g2_add(out, add)
        add = g2_add(add, add)
        k >>= 1
    return out


def g2_neg(a: G2Point) -> G2Point:
    if a is None:
        return None
    return (a[0], f2_neg(a[1]))


def g2_in_subgroup(pt: G2Point) -> bool:
    return g2_mul(pt, N) is None


# --- pairing (optimal ate via Miller loop) ------------------------------
#
# Implemented in the "embed everything in Fp12" style (the approach py_ecc
# proved out for bn128): G2 points are mapped through the D-twist
# ψ(x',y') = (x'·w², y'·w³) into E(Fp12), G1 points are lifted as Fp12
# scalars, and the Miller loop uses the generic affine line function over
# Fp12. Slower than a sparse-multiplication implementation, but the
# precompile gas schedule prices pairings at 34k gas/point — correctness
# dominates here.

ATE_LOOP_COUNT = 29793968203157093288  # 6u+2 for BN254
_LOG_ATE = [int(b) for b in bin(ATE_LOOP_COUNT)[2:]]


def f12_add(x, y):
    return (f6_add(x[0], y[0]), f6_add(x[1], y[1]))


def f12_sub(x, y):
    return (f6_sub(x[0], y[0]), f6_sub(x[1], y[1]))


def f12_neg(x):
    return (f6_neg(x[0]), f6_neg(x[1]))


def _f12_scalar(a: int):
    """Lift a base-field element into Fp12."""
    return (((a % P, 0), F2_ZERO, F2_ZERO), F6_ZERO)


F12_ZERO = (F6_ZERO, F6_ZERO)


def _twist(q: G2Point):
    """ψ: E'(Fp2) → E(Fp12): (x', y') ↦ (x'·w², y'·w³). With the tower
    Fp12 = Fp6[w], Fp6 = Fp2[v], v = w², this is x' into the v-slot of c0
    and y' into the v-slot of c1."""
    if q is None:
        return None
    x, y = q
    return (
        ((F2_ZERO, x, F2_ZERO), F6_ZERO),
        (F6_ZERO, (F2_ZERO, y, F2_ZERO)),
    )


def _embed_g1(p: G1Point):
    if p is None:
        return None
    return (_f12_scalar(p[0]), _f12_scalar(p[1]))


def _ec12_double(pt):
    x, y = pt
    if y == F12_ZERO:
        return None
    three_x2 = f12_mul(_f12_scalar(3), f12_square(x))
    m = f12_mul(three_x2, f12_inv(f12_add(y, y)))
    x3 = f12_sub(f12_square(m), f12_add(x, x))
    y3 = f12_sub(f12_mul(m, f12_sub(x, x3)), y)
    return (x3, y3)


def _ec12_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if y1 == y2:
            return _ec12_double(a)
        return None
    m = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    x3 = f12_sub(f12_sub(f12_square(m), x1), x2)
    y3 = f12_sub(f12_mul(m, f12_sub(x1, x3)), y1)
    return (x3, y3)


def _linefunc(p1, p2, t):
    """Value of the line through p1,p2 (or the tangent at p1) at point t;
    all points in E(Fp12) affine coordinates."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    elif y1 == y2:
        three_x2 = f12_mul(_f12_scalar(3), f12_square(x1))
        m = f12_mul(three_x2, f12_inv(f12_add(y1, y1)))
    else:
        return f12_sub(xt, x1)
    return f12_sub(f12_mul(m, f12_sub(xt, x1)), f12_sub(yt, y1))


def miller_loop(q: G2Point, p: G1Point):
    if q is None or p is None:
        return F12_ONE
    tq = _twist(q)
    tp = _embed_g1(p)
    f = F12_ONE
    r = tq
    for bit in _LOG_ATE[1:]:
        f = f12_mul(f12_square(f), _linefunc(r, r, tp))
        r = _ec12_double(r)
        if bit:
            f = f12_mul(f, _linefunc(r, tq, tp))
            r = _ec12_add(r, tq)
    # optimal-ate tail: Frobenius-twisted additions Q1, -Q2
    q1 = (f12_frobenius(tq[0]), f12_frobenius(tq[1]))
    nq2 = (f12_frobenius(q1[0]), f12_neg(f12_frobenius(q1[1])))
    f = f12_mul(f, _linefunc(r, q1, tp))
    r = _ec12_add(r, q1)
    f = f12_mul(f, _linefunc(r, nq2, tp))
    return f


def final_exponentiation(f):
    # easy part: f^((p^6-1)(p^2+1))
    f = f12_mul(f12_conj(f), f12_inv(f))
    f = f12_mul(f12_frobenius2(f), f)
    # hard part: f^((p^4 - p^2 + 1)/n) — generic exponentiation (slow but
    # correct; the precompile gas schedule prices this in)
    e = (P**4 - P**2 + 1) // N
    return f12_pow(f, e)


def pairing(q: G2Point, p: G1Point):
    return final_exponentiation(miller_loop(q, p))


def pairing_check(pairs: List[Tuple[G1Point, G2Point]]) -> bool:
    """True iff prod e(p_i, q_i) == 1."""
    acc = F12_ONE
    for p, q in pairs:
        acc = f12_mul(acc, miller_loop(q, p))
    return final_exponentiation(acc) == F12_ONE


# --- EVM wire format (EIP-196/197 encodings used by precompiles 6-8) ----


class PointNotOnCurve(Exception):
    pass


def g1_unmarshal(data: bytes) -> G1Point:
    """64-byte big-endian (x || y); (0,0) is infinity."""
    if len(data) != 64:
        raise PointNotOnCurve("bad G1 length")
    x = int.from_bytes(data[:32], "big")
    y = int.from_bytes(data[32:], "big")
    if x >= P or y >= P:
        raise PointNotOnCurve("coordinate >= field modulus")
    if x == 0 and y == 0:
        return None
    pt = (x, y)
    if not g1_is_on_curve(pt):
        raise PointNotOnCurve("not on curve")
    return pt


def g1_marshal(pt: G1Point) -> bytes:
    if pt is None:
        return b"\x00" * 64
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


def g2_unmarshal(data: bytes) -> G2Point:
    """128-byte (x_imag || x_real || y_imag || y_real) per EIP-197; all-zero
    is infinity. Subgroup membership is checked (gnark/bn256 does too)."""
    if len(data) != 128:
        raise PointNotOnCurve("bad G2 length")
    xi = int.from_bytes(data[0:32], "big")
    xr = int.from_bytes(data[32:64], "big")
    yi = int.from_bytes(data[64:96], "big")
    yr = int.from_bytes(data[96:128], "big")
    if xi >= P or xr >= P or yi >= P or yr >= P:
        raise PointNotOnCurve("coordinate >= field modulus")
    if xi == 0 and xr == 0 and yi == 0 and yr == 0:
        return None
    pt = ((xr, xi), (yr, yi))
    if not g2_is_on_curve(pt):
        raise PointNotOnCurve("not on twist")
    if not g2_in_subgroup(pt):
        raise PointNotOnCurve("not in r-torsion subgroup")
    return pt


def g2_marshal_eip197(pt: G2Point) -> bytes:
    if pt is None:
        return b"\x00" * 128
    (xr, xi), (yr, yi) = pt
    return b"".join(v.to_bytes(32, "big") for v in (xi, xr, yi, yr))
