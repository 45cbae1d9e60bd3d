"""Exact pure-Python BLS12-381 (min-pk) for the port's aggregate-key plane.

The port's trimmed copy of `hotstuff_tpu/crypto/aggsig.py`: the field
towers (Fp, Fp2, Fp6, Fp12), the curve groups (`_CurveOps` over Fp and
Fp2), ZCash-style point compression, `hash_to_g2`, the optimal ate pairing
and `ExactBlsScheme`'s `keypair_from_seed`, `sign` and `verify`. The exact
arithmetic is copied, not changed, so keys, signatures and verdicts are
the reference's bit for bit. `ops/bls.py` sums committee keys on the card
and checks the one pairing of an aggregate certificate here;
`chip_smoke.py` makes its keys and signatures with `ExactBlsScheme`.

What the consensus codec reads to check an inbound AggQC / AggTC is
copied too: `exact_scheme`, the aggregate-key registry
(`register_agg_key`, `agg_key_of`) and the certificate bitmap helpers
(`AGG_BITMAP_BYTES`, `MAX_AGG_COMMITTEE`, `members_of`,
`bitmap_to_bytes`, `bitmap_from_bytes`).

Not copied: the scheme and registry installers, the chaos runner's
trusted stub scheme, `AggSigner`, `combine` / `aggregate`, `bitmap_of`,
`_g1_in_subgroup`, `_fp2_conj` and `B_G2`. A node forms no aggregate
certificate: `Parameters.aggregate_certs` is refused.

Curve layout (min-pk, the Ethereum/ZCash convention):
  * secret keys are scalars mod r;
  * public keys live in G1 (48 B compressed) — so committee tables on
    the device need only Fp arithmetic;
  * signatures/messages live in G2 (96 B compressed), hashed by
    deterministic try-and-increment + cofactor clearing.
"""

from __future__ import annotations

import hashlib
import math
import struct

# --------------------------------------------------------------------------
# BLS12-381 parameters (the u-parametrized family; u is the Miller-loop
# count, p and r derive from it — both asserted below so a typo in any
# constant fails at import, not in a wrong-answer pairing).

X_PARAM = -0xD201000000010000  # the BLS12 curve parameter u (negative)

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R_ORDER = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

_U = -X_PARAM
assert R_ORDER == _U**4 - _U**2 + 1, "r != u^4 - u^2 + 1"
assert (
    P == (X_PARAM - 1) ** 2 * R_ORDER // 3 + X_PARAM
), "p != ((u-1)^2 r)/3 + u"
assert P % 4 == 3  # Fp sqrt via the (p+1)/4 exponent

B_G1 = 4  # E:  y^2 = x^3 + 4          over Fp

# Standard generators (ZCash serialization spec test vectors).
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

KEY_DOMAIN = b"hotstuff-aggsig-key-v1:"  # seed -> scalar derivation
DST_DOMAIN = b"hotstuff-aggsig-g2-v1:"  # hash-to-G2 domain separation

PK_BYTES = 48
SIG_BYTES = 96

# --------------------------------------------------------------------------
# Fp and Fp2 arithmetic (plain ints / int pairs)


def _inv(a: int) -> int:
    return pow(a, P - 2, P)


def _fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def _fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def _fp2_neg(a):
    return (-a[0] % P, -a[1] % P)


def _fp2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    return ((t0 - t1) % P, ((a0 + a1) * (b0 + b1) - t0 - t1) % P)


def _fp2_sqr(a):
    a0, a1 = a
    return ((a0 + a1) * (a0 - a1) % P, 2 * a0 * a1 % P)


def _fp2_scalar(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def _fp2_inv(a):
    a0, a1 = a
    norm_inv = _inv((a0 * a0 + a1 * a1) % P)
    return (a0 * norm_inv % P, -a1 * norm_inv % P)


def _fp2_pow(a, e: int):
    result = (1, 0)
    base = a
    while e:
        if e & 1:
            result = _fp2_mul(result, base)
        base = _fp2_sqr(base)
        e >>= 1
    return result


FP2_ONE = (1, 0)
FP2_ZERO = (0, 0)
XI = (1, 1)  # the sextic non-residue 1 + i (tower: v^3 = XI, w^2 = v)


def _fp2_sqrt(a):
    """Tonelli-Shanks over Fp2 (group order p^2 - 1 has 2-adicity 3 for
    this p). Returns a square root or None. Deterministic: the
    non-residue is found by a fixed small scan, never sampled."""
    if a == FP2_ZERO:
        return FP2_ZERO
    q = P * P
    # q - 1 = 2^3 * Q with Q odd
    s, Q = 3, (q - 1) >> 3
    z = _FP2_NONRESIDUE
    m = s
    c = _fp2_pow(z, Q)
    t = _fp2_pow(a, Q)
    rt = _fp2_pow(a, (Q + 1) >> 1)
    while t != FP2_ONE:
        # find least i with t^(2^i) == 1
        i, probe = 0, t
        while probe != FP2_ONE:
            probe = _fp2_sqr(probe)
            i += 1
            if i == m:
                return None  # not a square
        b = c
        for _ in range(m - i - 1):
            b = _fp2_sqr(b)
        m = i
        c = _fp2_sqr(b)
        t = _fp2_mul(t, c)
        rt = _fp2_mul(rt, b)
    return rt


def _find_fp2_nonresidue():
    euler = (P * P - 1) >> 1
    for a0, a1 in ((1, 1), (2, 1), (1, 2), (3, 1), (2, 3), (5, 2)):
        if _fp2_pow((a0, a1), euler) != FP2_ONE:
            return (a0, a1)
    raise AssertionError("no small Fp2 non-residue found")


_FP2_NONRESIDUE = _find_fp2_nonresidue()


# --------------------------------------------------------------------------
# Fp6 = Fp2[v]/(v^3 - XI), Fp12 = Fp6[w]/(w^2 - v); elements are nested
# tuples ((c0, c1, c2), ...) of Fp2 pairs.


def _fp6_add(a, b):
    return tuple(_fp2_add(x, y) for x, y in zip(a, b))


def _fp6_sub(a, b):
    return tuple(_fp2_sub(x, y) for x, y in zip(a, b))


def _fp6_neg(a):
    return tuple(_fp2_neg(x) for x in a)


def _fp6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = _fp2_mul(a0, b0)
    t1 = _fp2_mul(a1, b1)
    t2 = _fp2_mul(a2, b2)
    c0 = _fp2_add(
        t0,
        _fp2_mul(
            XI,
            _fp2_sub(
                _fp2_mul(_fp2_add(a1, a2), _fp2_add(b1, b2)), _fp2_add(t1, t2)
            ),
        ),
    )
    c1 = _fp2_add(
        _fp2_sub(
            _fp2_mul(_fp2_add(a0, a1), _fp2_add(b0, b1)), _fp2_add(t0, t1)
        ),
        _fp2_mul(XI, t2),
    )
    c2 = _fp2_add(
        _fp2_sub(
            _fp2_mul(_fp2_add(a0, a2), _fp2_add(b0, b2)), _fp2_add(t0, t2)
        ),
        t1,
    )
    return (c0, c1, c2)


def _fp6_mul_by_v(a):
    # (c0, c1, c2) * v = (XI*c2, c0, c1)
    return (_fp2_mul(XI, a[2]), a[0], a[1])


def _fp6_inv(a):
    a0, a1, a2 = a
    t0 = _fp2_sqr(a0)
    t1 = _fp2_sqr(a1)
    t2 = _fp2_sqr(a2)
    c0 = _fp2_sub(t0, _fp2_mul(XI, _fp2_mul(a1, a2)))
    c1 = _fp2_sub(_fp2_mul(XI, t2), _fp2_mul(a0, a1))
    c2 = _fp2_sub(t1, _fp2_mul(a0, a2))
    norm = _fp2_add(
        _fp2_mul(a0, c0),
        _fp2_mul(XI, _fp2_add(_fp2_mul(a2, c1), _fp2_mul(a1, c2))),
    )
    inv = _fp2_inv(norm)
    return (_fp2_mul(c0, inv), _fp2_mul(c1, inv), _fp2_mul(c2, inv))


FP6_ZERO = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = (FP2_ONE, FP2_ZERO, FP2_ZERO)

FP12_ONE = (FP6_ONE, FP6_ZERO)


def _fp12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = _fp6_mul(a0, b0)
    t1 = _fp6_mul(a1, b1)
    c1 = _fp6_sub(
        _fp6_mul(_fp6_add(a0, a1), _fp6_add(b0, b1)), _fp6_add(t0, t1)
    )
    return (_fp6_add(t0, _fp6_mul_by_v(t1)), c1)


def _fp12_sqr(a):
    return _fp12_mul(a, a)


def _fp12_conj(a):
    # conjugation == the p^6 Frobenius on Fp12
    return (a[0], _fp6_neg(a[1]))


def _fp12_inv(a):
    a0, a1 = a
    norm = _fp6_sub(_fp6_mul(a0, a0), _fp6_mul_by_v(_fp6_mul(a1, a1)))
    inv = _fp6_inv(norm)
    return (_fp6_mul(a0, inv), _fp6_neg(_fp6_mul(a1, inv)))


def _fp12_pow(a, e: int):
    result = FP12_ONE
    base = a
    while e:
        if e & 1:
            result = _fp12_mul(result, base)
        base = _fp12_sqr(base)
        e >>= 1
    return result


# w^(p^2) = gamma * w with gamma = XI^((p^2-1)/6) in Fp2; the p^2
# Frobenius is coefficient-wise multiplication by gamma^k for basis
# element w^k (the towered basis element v^j w^i has k = 2j + i).
_GAMMA_P2 = _fp2_pow(XI, (P * P - 1) // 6)
_GAMMA_P2_POWERS = [FP2_ONE]
for _ in range(5):
    _GAMMA_P2_POWERS.append(_fp2_mul(_GAMMA_P2_POWERS[-1], _GAMMA_P2))


def _fp12_frob_p2(a):
    out = []
    for i, half in enumerate(a):  # w^0 half, w^1 half
        coeffs = []
        for j, c in enumerate(half):  # v^j
            coeffs.append(_fp2_mul(c, _GAMMA_P2_POWERS[2 * j + i]))
        out.append(tuple(coeffs))
    return tuple(out)


# --------------------------------------------------------------------------
# Curve arithmetic, generic over the coordinate field. Jacobian
# coordinates (X, Y, Z) with x = X/Z^2, y = Y/Z^3 — no per-step field
# inversions, which is what keeps pure-python scalar multiplication in
# the milliseconds. `None` is the point at infinity throughout.


class _CurveOps:
    """Short-Weierstrass y^2 = x^3 + b over a field given by ops."""

    def __init__(self, add, sub, mul, sqr, inv, neg, scalar, zero, one, b):
        self.add, self.sub, self.mul, self.sqr = add, sub, mul, sqr
        self.inv, self.neg, self.scalar = inv, neg, scalar
        self.zero, self.one, self.b = zero, one, b

    def on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        return self.sqr(y) == self.add(self.mul(self.sqr(x), x), self.b)

    def dbl_j(self, pt):
        if pt is None:
            return None
        X, Y, Z = pt
        if Y == self.zero:
            return None
        A = self.sqr(X)
        B = self.sqr(Y)
        C = self.sqr(B)
        D = self.scalar(
            self.sub(self.sub(self.sqr(self.add(X, B)), A), C), 2
        )
        E = self.scalar(A, 3)
        X3 = self.sub(self.sqr(E), self.scalar(D, 2))
        Y3 = self.sub(self.mul(E, self.sub(D, X3)), self.scalar(C, 8))
        Z3 = self.scalar(self.mul(Y, Z), 2)
        return (X3, Y3, Z3)

    def add_j(self, p1, p2):
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        X1, Y1, Z1 = p1
        X2, Y2, Z2 = p2
        Z1Z1 = self.sqr(Z1)
        Z2Z2 = self.sqr(Z2)
        U1 = self.mul(X1, Z2Z2)
        U2 = self.mul(X2, Z1Z1)
        S1 = self.mul(self.mul(Y1, Z2), Z2Z2)
        S2 = self.mul(self.mul(Y2, Z1), Z1Z1)
        if U1 == U2:
            if S1 != S2:
                return None
            return self.dbl_j(p1)
        H = self.sub(U2, U1)
        I = self.sqr(self.scalar(H, 2))
        J = self.mul(H, I)
        rr = self.scalar(self.sub(S2, S1), 2)
        V = self.mul(U1, I)
        X3 = self.sub(self.sub(self.sqr(rr), J), self.scalar(V, 2))
        Y3 = self.sub(
            self.mul(rr, self.sub(V, X3)),
            self.scalar(self.mul(S1, J), 2),
        )
        Z3 = self.scalar(self.mul(self.mul(Z1, Z2), H), 2)
        return (X3, Y3, Z3)

    def to_jacobian(self, pt):
        if pt is None:
            return None
        return (pt[0], pt[1], self.one)

    def to_affine(self, pt):
        if pt is None:
            return None
        X, Y, Z = pt
        zinv = self.inv(Z)
        zinv2 = self.sqr(zinv)
        return (self.mul(X, zinv2), self.mul(Y, self.mul(zinv, zinv2)))

    def add_affine(self, p1, p2):
        return self.to_affine(
            self.add_j(self.to_jacobian(p1), self.to_jacobian(p2))
        )

    def mul_affine(self, pt, k: int):
        if pt is None or k == 0:
            return None
        if k < 0:
            x, y = pt
            pt = (x, self.neg(y))
            k = -k
        acc = None
        base = self.to_jacobian(pt)
        while k:
            if k & 1:
                acc = self.add_j(acc, base)
            base = self.dbl_j(base)
            k >>= 1
        return self.to_affine(acc)


_FP_OPS = _CurveOps(
    add=lambda a, b: (a + b) % P,
    sub=lambda a, b: (a - b) % P,
    mul=lambda a, b: a * b % P,
    sqr=lambda a: a * a % P,
    inv=_inv,
    neg=lambda a: -a % P,
    scalar=lambda a, k: a * k % P,
    zero=0,
    one=1,
    b=B_G1,
)

_FP2_OPS = _CurveOps(
    add=_fp2_add,
    sub=_fp2_sub,
    mul=_fp2_mul,
    sqr=_fp2_sqr,
    inv=_fp2_inv,
    neg=_fp2_neg,
    scalar=_fp2_scalar,
    zero=FP2_ZERO,
    one=FP2_ONE,
    b=_fp2_scalar(XI, 4),  # 4(1 + i)
)

assert _FP_OPS.on_curve(G1_GEN), "G1 generator not on E(Fp)"
assert _FP2_OPS.on_curve(G2_GEN), "G2 generator not on the M-twist"


def _g2_cofactor() -> int:
    """#E'(Fp2) / r, derived (not memorized): the sextic twists of E over
    Fp2 have orders p^2 + 1 - (±3f ± t2)/2 where t2 = t^2 - 2p is the
    Fp2 Frobenius trace and t2^2 - 4p^2 = -3 f^2 (CM discriminant -3).
    The correct twist is the candidate divisible by r whose order
    annihilates the standard G2 generator."""
    t = X_PARAM + 1  # Frobenius trace of E/Fp for BLS12
    t2 = t * t - 2 * P
    f2 = (4 * P * P - t2 * t2) // 3
    f = _isqrt(f2)
    assert f * f == f2, "CM discriminant is not -3?"
    for c in ((3 * f + t2) // 2, (3 * f - t2) // 2, (-3 * f + t2) // 2,
              (-3 * f - t2) // 2):
        order = P * P + 1 - c
        if order % R_ORDER == 0 and _FP2_OPS.mul_affine(G2_GEN, order) is None:
            return order // R_ORDER
    raise AssertionError("no sextic twist order matched the G2 generator")


def _isqrt(n: int) -> int:
    return math.isqrt(n)


_G2_COFACTOR: int | None = None  # computed lazily (one ~760-bit scalar mul)


def _g2_clear_cofactor(pt):
    global _G2_COFACTOR
    if _G2_COFACTOR is None:
        _G2_COFACTOR = _g2_cofactor()
    return _FP2_OPS.mul_affine(pt, _G2_COFACTOR)


# --------------------------------------------------------------------------
# Serialization (ZCash flag convention: bit7 compressed, bit6 infinity,
# bit5 y-sign = lexicographically-largest y)


def _fp_is_larger(y: int) -> bool:
    return y > P - y


def _fp2_is_larger(y) -> bool:
    if y[1] != 0:
        return y[1] > P - y[1]
    return y[0] > P - y[0]


def compress_g1(pt) -> bytes:
    if pt is None:
        return bytes([0xC0]) + bytes(47)
    x, y = pt
    flags = 0x80 | (0x20 if _fp_is_larger(y) else 0)
    raw = bytearray(x.to_bytes(48, "big"))
    raw[0] |= flags
    return bytes(raw)


def decompress_g1(data: bytes):
    if len(data) != 48:
        raise ValueError("G1 point must be 48 bytes")
    flags = data[0]
    if not flags & 0x80:
        raise ValueError("uncompressed G1 encoding unsupported")
    if flags & 0x40:
        if any(data[1:]) or flags & 0x20 or data[0] & 0x1F:
            raise ValueError("malformed G1 infinity encoding")
        return None
    x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if x >= P:
        raise ValueError("G1 x out of range")
    y2 = (x * x % P * x + B_G1) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        raise ValueError("G1 x not on curve")
    if _fp_is_larger(y) != bool(flags & 0x20):
        y = P - y
    return (x, y)


def compress_g2(pt) -> bytes:
    if pt is None:
        return bytes([0xC0]) + bytes(95)
    (x0, x1), y = pt
    flags = 0x80 | (0x20 if _fp2_is_larger(y) else 0)
    raw = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    raw[0] |= flags
    return bytes(raw)


def decompress_g2(data: bytes):
    if len(data) != 96:
        raise ValueError("G2 point must be 96 bytes")
    flags = data[0]
    if not flags & 0x80:
        raise ValueError("uncompressed G2 encoding unsupported")
    if flags & 0x40:
        if any(data[1:]) or flags & 0x20 or data[0] & 0x1F:
            raise ValueError("malformed G2 infinity encoding")
        return None
    x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if x0 >= P or x1 >= P:
        raise ValueError("G2 x out of range")
    x = (x0, x1)
    y2 = _fp2_add(_fp2_mul(_fp2_sqr(x), x), _FP2_OPS.b)
    y = _fp2_sqrt(y2)
    if y is None:
        raise ValueError("G2 x not on curve")
    if _fp2_is_larger(y) != bool(flags & 0x20):
        y = _fp2_neg(y)
    return (x, y)


# --------------------------------------------------------------------------
# Hash to G2: deterministic try-and-increment over counter-separated
# SHA-512 draws (NOT constant-time — fine for signing public protocol
# digests), then cofactor clearing into the r-torsion subgroup.


def hash_to_g2(msg: bytes):
    for ctr in range(256):
        h = hashlib.sha512(DST_DOMAIN + struct.pack("<B", ctr) + msg)
        d0 = h.digest()
        d1 = hashlib.sha512(b"\x01" + d0).digest()
        x = (int.from_bytes(d0, "big") % P, int.from_bytes(d1, "big") % P)
        y2 = _fp2_add(_fp2_mul(_fp2_sqr(x), x), _FP2_OPS.b)
        y = _fp2_sqrt(y2)
        if y is None:
            continue
        # Deterministic sign choice keyed off the draw, so the map is a
        # pure function of (DST_DOMAIN, msg).
        if _fp2_is_larger(y) != bool(d1[0] & 1):
            y = _fp2_neg(y)
        pt = _g2_clear_cofactor((x, y))
        if pt is not None:
            return pt
    raise AssertionError("hash_to_g2 exhausted 256 counters")


# --------------------------------------------------------------------------
# Pairing: untwist E'(Fp2) -> E(Fp12), Miller loop over |u|, final
# exponentiation split into the cheap (p^6-1)(p^2+1) part (conjugation +
# one Frobenius) and a plain pow for the hard (p^4-p^2+1)/r exponent.


def _fp12_from_fp(a: int):
    return (((a, 0), FP2_ZERO, FP2_ZERO), FP6_ZERO)


def _fp12_from_fp2(a):
    return ((a, FP2_ZERO, FP2_ZERO), FP6_ZERO)


_W = (FP6_ZERO, FP6_ONE)  # the tower generator w (w^2 = v, w^6 = XI)
_W2_INV = _fp12_inv(_fp12_mul(_W, _W))
_W3_INV = _fp12_inv(_fp12_mul(_fp12_mul(_W, _W), _W))

_FP12_OPS = _CurveOps(
    add=lambda a, b: (_fp6_add(a[0], b[0]), _fp6_add(a[1], b[1])),
    sub=lambda a, b: (_fp6_sub(a[0], b[0]), _fp6_sub(a[1], b[1])),
    mul=_fp12_mul,
    sqr=_fp12_sqr,
    inv=_fp12_inv,
    neg=lambda a: (_fp6_neg(a[0]), _fp6_neg(a[1])),
    scalar=lambda a, k: tuple(
        tuple(_fp2_scalar(c, k) for c in half) for half in a
    ),
    zero=(FP6_ZERO, FP6_ZERO),
    one=FP12_ONE,
    b=_fp12_from_fp(B_G1),
)


def _untwist(pt):
    """E'(Fp2) -> E(Fp12): (x', y') -> (x'/w^2, y'/w^3). With w^6 = XI
    this lands on y^2 = x^3 + 4 (the twist equation divides through)."""
    if pt is None:
        return None
    x, y = pt
    return (
        _fp12_mul(_fp12_from_fp2(x), _W2_INV),
        _fp12_mul(_fp12_from_fp2(y), _W3_INV),
    )


def _line(a, b, at):
    """Evaluate the line through a, b (or the tangent when a == b) at
    `at`; all points affine in Fp12. Vertical lines return the x-offset
    (the factor lives in a proper subfield and dies in the final
    exponentiation, the standard omission)."""
    ops = _FP12_OPS
    ax, ay = a
    bx, by = b
    tx, ty = at
    if ax == bx:
        if ay == by:
            if ay == ops.zero:
                return ops.sub(tx, ax), None
            lam = ops.mul(
                ops.scalar(ops.sqr(ax), 3),
                ops.inv(ops.scalar(ay, 2)),
            )
        else:
            return ops.sub(tx, ax), None
    else:
        lam = ops.mul(ops.sub(by, ay), ops.inv(ops.sub(bx, ax)))
    val = ops.sub(ops.sub(ty, ay), ops.mul(lam, ops.sub(tx, ax)))
    return val, lam


def _miller(q_tw, p_g1):
    """f_{|u|, Q}(P) for the ate pairing, conjugated for the negative u.
    Q arrives in twist coordinates; P in E(Fp) affine."""
    ops = _FP12_OPS
    Q = _untwist(q_tw)
    Pm = (_fp12_from_fp(p_g1[0]), _fp12_from_fp(p_g1[1]))
    f = FP12_ONE
    T = Q
    for bit in bin(_U)[3:]:  # skip the leading 1
        val, _ = _line(T, T, Pm)
        f = _fp12_mul(_fp12_sqr(f), val)
        T = ops.add_affine(T, T)
        if bit == "1":
            val, _ = _line(T, Q, Pm)
            f = _fp12_mul(f, val)
            T = ops.add_affine(T, Q)
    return _fp12_conj(f)  # u < 0: 1/f and conj(f) agree after final exp


_HARD_EXP = (P**4 - P**2 + 1) // R_ORDER
assert (P**4 - P**2 + 1) % R_ORDER == 0


def _final_exp(f):
    # easy part: f^((p^6 - 1)(p^2 + 1))
    f = _fp12_mul(_fp12_conj(f), _fp12_inv(f))
    f = _fp12_mul(_fp12_frob_p2(f), f)
    # hard part: plain square-and-multiply over (p^4 - p^2 + 1)/r
    return _fp12_pow(f, _HARD_EXP)


def _pairings_are_one(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 with ONE shared final exponentiation —
    the aggregate-verify shape (P_i in E(Fp) affine, Q_i in twist
    coordinates)."""
    f = FP12_ONE
    for p_g1, q_tw in pairs:
        if p_g1 is None or q_tw is None:
            continue  # e(O, Q) = e(P, O) = 1
        f = _fp12_mul(f, _miller(q_tw, p_g1))
    return _final_exp(f) == FP12_ONE


def _g1_neg(pt):
    if pt is None:
        return None
    return (pt[0], -pt[1] % P)


def _g2_in_subgroup(pt) -> bool:
    return _FP2_OPS.mul_affine(pt, R_ORDER) is None


# --------------------------------------------------------------------------
# The scheme


class ExactBlsScheme:
    """Exact-integer BLS12-381 min-pk aggregate signatures."""

    name = "bls12381"
    pk_bytes = PK_BYTES
    sig_bytes = SIG_BYTES

    def keypair_from_seed(self, seed: bytes) -> tuple[bytes, int]:
        sk = (
            int.from_bytes(
                hashlib.sha512(KEY_DOMAIN + seed).digest(), "little"
            )
            % R_ORDER
        )
        if sk == 0:
            sk = 1
        return compress_g1(_FP_OPS.mul_affine(G1_GEN, sk)), sk

    def sign(self, sk: int, msg: bytes) -> bytes:
        return compress_g2(_FP2_OPS.mul_affine(hash_to_g2(msg), sk))

    def verify(self, pks, msg: bytes, sig: bytes) -> bool:
        return self.verify_groups([(list(pks), msg)], sig)

    def verify_groups(self, groups, sig: bytes) -> bool:
        """prod_g e(apk_g, H(msg_g)) == e(g1, S): the multi-message
        aggregate check (a TC spans one group per distinct high-qc
        round; a QC is the single-group case)."""
        try:
            s = decompress_g2(sig)
            if s is None or not _g2_in_subgroup(s):
                return False
            pairs = [(_g1_neg(G1_GEN), s)]
            for pks, msg in groups:
                if not pks:
                    return False
                apk = None
                for pk in pks:
                    apk = _FP_OPS.add_affine(apk, decompress_g1(pk))
                if apk is None:
                    return False
                pairs.append((apk, hash_to_g2(msg)))
            return _pairings_are_one(pairs)
        except ValueError:
            return False


# --------------------------------------------------------------------------
# The scheme that checks aggregate certificates: the exact curve.

_EXACT: ExactBlsScheme | None = None


def exact_scheme() -> ExactBlsScheme:
    global _EXACT
    if _EXACT is None:
        _EXACT = ExactBlsScheme()
    return _EXACT


# --------------------------------------------------------------------------
# Aggregate-key registry: consensus identity (Ed25519 pk bytes) ->
# aggregate pk bytes. Certificates carry NO keys on the wire (that is
# the point); verifiers resolve bitmap members here. Registration is
# the proof-of-possession boundary.

_REGISTRY: dict[bytes, bytes] = {}


def register_agg_key(identity: bytes, agg_pk: bytes) -> None:
    _REGISTRY[bytes(identity)] = bytes(agg_pk)


def agg_key_of(identity: bytes) -> bytes | None:
    return _REGISTRY.get(bytes(identity))


# --------------------------------------------------------------------------
# Committee bitmaps: bit i = sorted_keys()[i] of the round's committee.

AGG_BITMAP_BYTES = 64
MAX_AGG_COMMITTEE = AGG_BITMAP_BYTES * 8


def members_of(bitmap: int, sorted_keys) -> list:
    """Resolve a bitmap against a sorted committee; raises ValueError on
    bits beyond the committee (a malformed or wrong-epoch bitmap)."""
    if bitmap < 0:
        raise ValueError("negative bitmap")
    if bitmap >> len(sorted_keys):
        raise ValueError(
            f"bitmap claims member {bitmap.bit_length() - 1} of a "
            f"{len(sorted_keys)}-member committee"
        )
    return [pk for i, pk in enumerate(sorted_keys) if bitmap >> i & 1]


def bitmap_to_bytes(bitmap: int) -> bytes:
    return bitmap.to_bytes(AGG_BITMAP_BYTES, "little")


def bitmap_from_bytes(data: bytes) -> int:
    return int.from_bytes(data, "little")
