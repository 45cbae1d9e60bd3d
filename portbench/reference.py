"""The plain reference: ed25519 verification in Python integers.

RFC 8032, section 5.1.7, with the cofactorless equation the RFC allows:
a lane is valid when A and R decode (y < p, x = 0 only with a clear sign
bit), s < L, and the encoding of [s]B - [h]A equals R byte for byte,
where h = SHA-512(R || A || M) mod L. Written from the RFC alone: it
imports the standard library and nothing of the program, so what the
program verifies is worked out again here from the same bytes.

`verdicts(triples, workers)` verifies a list of (message, key, signature)
triples, split over `workers` processes when there are many (spawned, so
they start from a fresh import of this module alone). A key that signs
many of them (a validator's) gets a table of its own multiples, as B has,
so that its [h]A needs no doublings.
"""

from __future__ import annotations

import hashlib
import multiprocessing
from typing import Sequence

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = -121665 * pow(121666, P - 2, P) % P
D2 = 2 * D % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

IDENT = (0, 1, 1, 0)


def _add(p, q):
    """Extended-coordinate addition (add-2008-hwcd-3)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * D2 % P * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return e * f % P, g * h % P, f * g % P, e * h % P


def _double(p):
    """Extended-coordinate doubling (dbl-2008-hwcd)."""
    x, y, z, _ = p
    a = x * x % P
    b = y * y % P
    c = 2 * z * z % P
    h = a + b
    e = h - (x + y) * (x + y) % P
    g = a - b
    f = c + g
    return e * f % P, g * h % P, f * g % P, e * h % P


def _neg(p):
    x, y, z, t = p
    return (P - x) % P, y, z, (P - t) % P


def decode(data: bytes):
    """A 32-byte encoding -> the point in extended coordinates, or None
    when y >= p, x^2 has no root, or x = 0 comes with the sign bit set."""
    if len(data) != 32:
        return None
    enc = int.from_bytes(data, "little")
    y, sign = enc & ((1 << 255) - 1), enc >> 255
    if y >= P:
        return None
    u, v = (y * y - 1) % P, (D * y * y + 1) % P
    x = u * pow(v, 3, P) * pow(u * pow(v, 7, P), (P - 5) // 8, P) % P
    if (v * x * x - u) % P:
        x = x * SQRT_M1 % P
        if (v * x * x - u) % P:
            return None
    if x == 0 and sign:
        return None
    if x & 1 != sign:
        x = P - x
    return x, y, 1, x * y % P


def encode(p) -> bytes:
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return (y | (x & 1) << 255).to_bytes(32, "little")


BASE = decode((4 * pow(5, P - 2, P) % P).to_bytes(32, "little"))
# Keys seen this often in one call of `verdicts` get a comb of their own.
COMB_AT = 16


def comb(p) -> list[list]:
    """[j 16^i]p for i < 64, j < 16: [k]p is then 64 additions at most."""
    rows, row = [], p
    for _ in range(64):
        mults = [IDENT, row]
        for _ in range(14):
            mults.append(_add(mults[-1], row))
        rows.append(mults)
        row = _add(mults[-1], row)
    return rows


def _comb_mul(k: int, rows):
    acc = IDENT
    for i in range(64):
        j = k >> (4 * i) & 15
        if j:
            acc = _add(acc, rows[i][j])
    return acc


_BASE_COMB: list = []


def _var_mul(k: int, p):
    """[k]p by 4-bit windows, most significant first."""
    mults = [IDENT, p]
    for _ in range(14):
        mults.append(_add(mults[-1], p))
    acc = IDENT
    for i in range(63, -1, -1):
        acc = _double(_double(_double(_double(acc))))
        j = k >> (4 * i) & 15
        if j:
            acc = _add(acc, mults[j])
    return acc


def verify(message: bytes, key: bytes, signature: bytes, key_comb: list | None = None) -> bool:
    """The verdict of one (message, key, signature) triple; `key_comb`,
    where given, is `comb` of the decoded key."""
    if len(key) != 32 or len(signature) != 64:
        return False
    a = decode(key)
    if a is None:
        return False
    r_enc = signature[:32]
    if decode(r_enc) is None:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= L:
        return False
    h = int.from_bytes(hashlib.sha512(r_enc + key + message).digest(), "little") % L
    if not _BASE_COMB:
        _BASE_COMB.append(comb(BASE))
    ha = _comb_mul(h, key_comb) if key_comb is not None else _var_mul(h, a)
    return encode(_add(_comb_mul(s, _BASE_COMB[0]), _neg(ha))) == r_enc


def _verify_all(part: tuple[Sequence[tuple[bytes, bytes, bytes]], frozenset]) -> list[bool]:
    triples, frequent = part
    combs: dict[bytes, list | None] = {}
    out = []
    for m, k, s in triples:
        if k in frequent and k not in combs:
            a = decode(k)
            combs[k] = comb(a) if a is not None else None
        out.append(verify(m, k, s, combs.get(k)))
    return out


def verdicts(triples: Sequence[tuple[bytes, bytes, bytes]], workers: int = 1) -> list[bool]:
    """Each triple's verdict, in order, over `workers` spawned processes
    (in this process when `workers` is 1 or the list is short)."""
    triples = list(triples)
    seen: dict[bytes, int] = {}
    for _, k, _ in triples:
        seen[k] = seen.get(k, 0) + 1
    frequent = frozenset(k for k, n in seen.items() if n >= COMB_AT)
    if workers <= 1 or len(triples) < 64 * workers:
        return _verify_all((triples, frequent))
    step = -(-len(triples) // (4 * workers))
    parts = [(triples[i : i + step], frequent) for i in range(0, len(triples), step)]
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        out = pool.map(_verify_all, parts)
    return [v for part in out for v in part]
