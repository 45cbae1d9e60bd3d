"""ed25519 curve arithmetic, key decompression, compression, the packed
wire format and host staging — kernels K3 (`decompress_table`) and K4
(`compress_eq`) with their plain versions.

Counterpart of `hotstuff_tpu/ops/ed25519.py`: the generic path, and the
committee path's `CommitteeTable` and staging. Verification is the strict
cofactorless equation of the JAX package:

    valid_i  <=>  enc([s_i]B - [h_i]A_i) == R_i,  h_i = SHA-512(R||A||M) mod L

Curve ops are the extended-coordinate formulas for a = -1 twisted Edwards
(dbl-2008-hwcd, madd-2008-hwcd-3, add-2008-hwcd-3) with the JAX package's
`with_t` schedule; `csrc/quad.cuh` runs the same steps on the card.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np
import torch

from .. import resolve_device
from ..crypto import native_staging
from . import _build
from . import field as f
from .sha512 import h_digits, nibble_rows

P = f.P
NL = f.NL
L_ORDER = 2**252 + 27742317777372353535851937790883648493

# --- curve constants (host Python ints -> limbs) ----------------------------
D_INT = (-121665 * pow(121666, P - 2, P)) % P
D2_INT = (2 * D_INT) % P
SQRTM1_INT = pow(2, (P - 1) // 4, P)

BY_INT = (4 * pow(5, P - 2, P)) % P
_u = (BY_INT * BY_INT - 1) % P
_v = (D_INT * BY_INT * BY_INT + 1) % P
_x2 = (_u * pow(_v, P - 2, P)) % P
BX_INT = pow(_x2, (P + 3) // 8, P)
if (BX_INT * BX_INT - _x2) % P != 0:
    BX_INT = (BX_INT * SQRTM1_INT) % P
if BX_INT % 2 != 0:
    BX_INT = P - BX_INT

D = f.limbs_of_int(D_INT)
D2 = f.limbs_of_int(D2_INT)
SQRTM1 = f.limbs_of_int(SQRTM1_INT)

WINDOW = 4
NGROUPS = 64  # 4-bit windows of a 256-bit scalar; s, h < 2^253

Point = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]  # X,Y,Z,T


def _c(name: str, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return f.const(name, t, like.device)


def point_identity(batch: int, device: torch.device) -> Point:
    zero = torch.zeros((NL, batch), dtype=torch.int64, device=device)
    one = zero.clone()
    one[0] = 1
    return zero, one, one.clone(), zero.clone()


def point_dbl(p: Point, with_t: bool = True) -> Point:
    """dbl-2008-hwcd for a = -1. Doubling never reads T, so a doubling
    feeding another doubling skips producing it (`with_t=False`: T is
    zeros and must not feed an addition)."""
    X, Y, Z, _ = p
    xx = f.sqr(X)
    yy = f.sqr(Y)
    zz = f.sqr(Z)
    zz2 = f.add(zz, zz)
    aa = f.sqr(f.add(X, Y))
    yp = f.add(yy, xx)
    zp = f.sub(yy, xx)
    xp = f.sub(aa, yp)
    tp = f.sub(zz2, zp)
    t_out = f.mul(xp, yp) if with_t else torch.zeros_like(xp)
    return f.mul(xp, tp), f.mul(yp, zp), f.mul(zp, tp), t_out


def point_madd(p: Point, q_ypx, q_ymx, q_xy2d, with_t: bool = True) -> Point:
    """Unified mixed addition (madd-2008-hwcd-3): P + affine precomp Q."""
    X1, Y1, Z1, T1 = p
    a = f.mul(f.add(Y1, X1), q_ypx)
    b = f.mul(f.sub(Y1, X1), q_ymx)
    c = f.mul(T1, q_xy2d)
    d2z = f.add(Z1, Z1)
    x3 = f.sub(a, b)
    y3 = f.add(a, b)
    z3 = f.add(d2z, c)
    t3 = f.sub(d2z, c)
    t_out = f.mul(x3, y3) if with_t else torch.zeros_like(x3)
    return f.mul(x3, t3), f.mul(y3, z3), f.mul(z3, t3), t_out


def point_add_cached(p: Point, q_ypx, q_ymx, q_z, q_t2d, with_t: bool = True) -> Point:
    """Unified addition with a cached point (Y2+X2, Y2-X2, Z2, 2d*T2)
    (add-2008-hwcd-3). Cached identity is (1, 1, 1, 0)."""
    X1, Y1, Z1, T1 = p
    a = f.mul(f.add(Y1, X1), q_ypx)
    b = f.mul(f.sub(Y1, X1), q_ymx)
    c = f.mul(T1, q_t2d)
    zz = f.mul(Z1, q_z)
    d2z = f.add(zz, zz)
    x3 = f.sub(a, b)
    y3 = f.add(a, b)
    z3 = f.add(d2z, c)
    t3 = f.sub(d2z, c)
    t_out = f.mul(x3, y3) if with_t else torch.zeros_like(x3)
    return f.mul(x3, t3), f.mul(y3, z3), f.mul(z3, t3), t_out


# --- shared k*B table ---------------------------------------------------------


def _edwards_add_int(p1, p2):
    """Exact affine Edwards addition over Python ints (host precompute)."""
    (x1, y1), (x2, y2) = p1, p2
    dxy = D_INT * x1 * x2 % P * y1 * y2 % P
    x3 = (x1 * y2 + x2 * y1) * pow(1 + dxy, P - 2, P) % P
    y3 = (y1 * y2 + x1 * x2) * pow(1 - dxy, P - 2, P) % P
    return x3, y3


def _base_table() -> torch.Tensor:
    """(3, 16, NL) int32 canonical limbs of k*B, k = 0..15, in affine
    precomp form (y+x, y-x, 2d*x*y); row 0 is the identity (1, 1, 0)."""
    pts = [(0, 1)]
    for _ in range(15):
        pts.append(_edwards_add_int(pts[-1], (BX_INT, BY_INT)))
    coords = (
        [(y + x) % P for x, y in pts],
        [(y - x) % P for x, y in pts],
        [D2_INT * x * y % P for x, y in pts],
    )
    return torch.stack([f.limbs_of_int(c).T for c in coords]).to(torch.int32)


BASE_TABLE = _base_table()

# --- committee-resident -A tables ----------------------------------------------
#
# Consensus traffic is signed by a fixed committee of validator keys. A
# `CommitteeTable` decompresses each key and builds its 16-entry k*(-A)
# table once per registration, with exact Python ints on the host, and keeps
# the result on the device; committee lanes then carry a validator index and
# read their table by it (kernel K5, `ops/committee.py`). Host precompute
# gives AFFINE entries, so the per-item adds become mixed additions.


def decompress_int(key: bytes) -> tuple[int, int] | None:
    """Exact host decompression of a 32-byte compressed point, with the
    device's semantics (as `_decompress_int`, hotstuff_tpu/ops/ed25519.py:
    326-346): y is reduced mod p (y >= p is not rejected), x = 0 takes either
    sign, and None is returned only when no square root exists. The host
    verifier (`pysigner.verify_device_semantics`) decodes keys with it;
    strict `pysigner.verify` rejects both."""
    enc = int.from_bytes(key, "little")
    sign = enc >> 255
    y = (enc & ((1 << 255) - 1)) % P
    u = (y * y - 1) % P
    v = (D_INT * y * y + 1) % P
    x2 = u * pow(v, P - 2, P) % P
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * SQRTM1_INT % P
    if (x * x - x2) % P != 0:
        return None
    if x % 2 != sign:
        x = (P - x) % P
    return x, y


class CommitteeTable:
    """Per-validator k*(-A) tables, built once per committee and kept on
    `device` (as `CommitteeTable`, hotstuff_tpu/ops/ed25519.py:349-409):
    the card unless `device="cpu"`; no card raises.

    N = committee size:
      entries : (N, 16, 3, NL) int32 canonical limbs of the affine precomp
                (y+x, y-x, 2d*x*y) of k*(-A_v), k = 0..15, validator-major
                (the reference's (16, 32, N) tables per coordinate, laid out
                so one lane's entry is 120 contiguous bytes: the lanes of a
                warp hold different validators); entry 0 is the madd
                identity (1, 1, 0); an undecompressable key has zeros in
                entries 1-15 (as the reference; its lanes always fail)
      valid   : (N,) bool, False for keys with no decompression
      keys_u8 : (32, N) uint8 raw key bytes, read by index by kernel K2g
    `index` maps raw key -> validator index (the first index wins for a
    duplicate key). `replicas` maps each device that holds a copy of the
    table to that copy, this table's own device to itself; the mesh verifier
    (`parallel/mesh.py`) adds one copy per device of its mesh with `to`."""

    def __init__(self, keys: Sequence[bytes], device: str | torch.device | None = None) -> None:
        dev = resolve_device(device)
        keys = [bytes(k) for k in keys]
        if not keys:
            raise ValueError("committee must have at least one key")
        self.keys = keys
        self.index: dict[bytes, int] = {}
        for i, k in enumerate(keys):
            self.index.setdefault(k, i)
        n = len(keys)
        cols: list[list[int]] = [[], [], []]  # per coordinate: validator, then entry
        valid = []
        for kb in keys:
            pt = decompress_int(kb)
            valid.append(pt is not None)
            rows = [(1, 1, 0)] + [(0, 0, 0)] * 15
            if pt is not None:
                neg = ((P - pt[0]) % P, pt[1])
                cur = (0, 1)
                for k in range(1, 16):
                    cur = _edwards_add_int(cur, neg)
                    cx, cy = cur
                    rows[k] = ((cy + cx) % P, (cy - cx) % P, D2_INT * cx * cy % P)
            for c in range(3):
                cols[c].extend(row[c] for row in rows)
        # limbs_of_int gives (NL, N*16) with column v*16 + k.
        ta = torch.stack([f.limbs_of_int(c).view(NL, n, 16) for c in cols])  # (3, NL, N, 16)
        self.entries = ta.permute(2, 3, 0, 1).to(torch.int32).contiguous().to(dev)
        self.valid = torch.tensor(valid, dtype=torch.bool, device=dev)
        self.keys_u8 = torch.from_numpy(
            np.frombuffer(b"".join(keys), np.uint8).reshape(n, 32).T.copy()
        ).to(dev)
        self.size = n
        self.replicas: dict[torch.device, CommitteeTable] = {self.entries.device: self}

    def to(self, device: str | torch.device) -> CommitteeTable:
        """This table on `device`: itself when it is there already, else a
        copy that shares `keys` and `index` and redoes none of the host's
        exact-integer work. The copy goes through host memory by blocking
        copies, so it has landed when this returns and a kernel on any
        stream reads it complete (a device-to-device copy would still be in
        flight on the caller's stream)."""
        dev = torch.device(device)
        if dev == self.entries.device:
            return self
        out = object.__new__(CommitteeTable)
        out.keys, out.index, out.size = self.keys, self.index, self.size
        out.entries, out.valid, out.keys_u8 = (t.cpu().to(dev) for t in (self.entries, self.valid, self.keys_u8))
        out.replicas = {out.entries.device: out}
        return out

# --- decompression and the per-item -A table ---------------------------------


def decompress(y: torch.Tensor, sign: torch.Tensor, mul=f.mul, sqr=f.sqr, pow2523=f.pow2523):
    """Compressed y limbs (value < 2^255, not necessarily < p) + sign of x
    -> (x, -x, valid), x and -x canonical (as ops/ed25519.py:561-588).

    ref10 recipe: x = u v^3 (u v^7)^((p-5)/8) with u = y^2 - 1,
    v = d y^2 + 1; times sqrt(-1) when v x^2 == -u; invalid when
    v x^2 != +-u. y >= p is reduced, not rejected; x = 0 takes either sign.
    `mul`, `sqr` and `pow2523` are the field's products: every caller but
    the test-only `decompress_split`, which passes the split ones, keeps
    the defaults."""
    yy = sqr(y)
    u = f.sub(yy, _c("one", f.ONE, y))
    v = f.add(mul(_c("d", D, y), yy), _c("one", f.ONE, y))
    v3 = mul(sqr(v), v)
    v7 = mul(sqr(v3), v)
    w = pow2523(mul(u, v7))
    r = mul(mul(u, v3), w)
    chk = f.canonical(mul(v, sqr(r)))
    u_c = f.canonical(u)
    negu_c = f.canonical(f.sub(_c("zero", f.ZERO, y), u))
    is_pos = f.eq_canonical(chk, u_c)
    is_neg = f.eq_canonical(chk, negu_c) & ~is_pos
    valid = is_pos | is_neg
    x = f.select(is_neg, mul(r, _c("sqrtm1", SQRTM1, y)), r)
    x_c = f.canonical(x)
    xneg_c = f.canonical(f.sub(_c("zero", f.ZERO, y), x_c))
    flip = f.parity(x_c) != sign.long()
    return f.select(flip, xneg_c, x_c), f.select(flip, x_c, xneg_c), valid


def decompress_split(y: torch.Tensor, sign: torch.Tensor):
    """K3's phase 1 in its integer steps: `decompress` with every product
    split over four warps (`field.mul_split`, `sqr_split`, `pow2523_split`;
    csrc/decompress_table.cu). A model for the CPU tests, which no plain
    version calls; its outputs are canonical, so they equal `decompress`'s
    exactly."""
    return decompress(y, sign, f.mul_split, f.sqr_split, f.pow2523_split)


def build_neg_a_table(x_neg: torch.Tensor, a_y: torch.Tensor) -> torch.Tensor:
    """(4, 16, NL, B) int32 cached table of k*(-A), k = 0..15: components
    (y+x, y-x, z, 2d*t) — as `_build_neg_a_table` (ops/ed25519.py:242-264),
    stacked into one lane-fastest tensor."""
    d2 = _c("d2", D2, a_y)
    na_ypx = f.add(a_y, x_neg)
    na_ymx = f.sub(a_y, x_neg)
    na_xy2d = f.mul(d2, f.mul(x_neg, a_y))
    pts = [point_identity(a_y.shape[1], a_y.device)]
    cur = (x_neg, a_y, _c("one", f.ONE, a_y).expand_as(a_y), f.mul(x_neg, a_y))
    pts.append(cur)
    for _ in range(14):
        cur = point_madd(cur, na_ypx, na_ymx, na_xy2d)
        pts.append(cur)
    ypx = torch.stack([f.add(p[1], p[0]) for p in pts])
    ymx = torch.stack([f.sub(p[1], p[0]) for p in pts])
    z = torch.stack([p[2] for p in pts])
    t2d = torch.stack([f.mul(d2, p[3]) for p in pts])
    return torch.stack([ypx, ymx, z, t2d]).to(torch.int32)


def unpack_key(a_bytes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(32, B) uint8 key rows -> (y limbs (NL, B) int64, sign (B,) int64)."""
    return f.from_bytes(a_bytes), (a_bytes[31] >> 7).long()


def decompress_table_plain(a_bytes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(32, B) uint8 keys -> ((4, 16, NL, B) int32 -A table, (B,) bool valid)."""
    y, sign = unpack_key(a_bytes)
    _, x_neg, valid = decompress(y, sign)
    return build_neg_a_table(x_neg, y), valid


def decompress_table(a_bytes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K3 wrapper (replaces `decompress` + `_build_neg_a_table`):
    CPU tensors -> `decompress_table_plain`; CUDA tensors ->
    `csrc/decompress_table.cu`."""
    if a_bytes.device.type == "cpu":
        return decompress_table_plain(a_bytes)
    batch = a_bytes.shape[1]
    _build.check(a_bytes, (32, batch), torch.uint8, a_bytes.device)
    table = torch.empty((4, 16, NL, batch), dtype=torch.int32, device=a_bytes.device)
    valid = torch.empty((batch,), dtype=torch.bool, device=a_bytes.device)
    _build.KERNELS["decompress_table"].launch(a_bytes, table, valid, batch)
    return table, valid


# --- compression and the R compare -------------------------------------------


def compress(xyzt: torch.Tensor) -> torch.Tensor:
    """(4, NL, B) point -> (32, B) uint8 canonical encoding (y, with the
    sign of x in bit 255), as `compress` (ops/ed25519.py:591-596)."""
    X, Y, Z = xyzt[0].long(), xyzt[1].long(), xyzt[2].long()
    zinv = f.invert(Z)
    x_c = f.canonical(f.mul(X, zinv))
    enc = f.to_bytes(f.canonical(f.mul(Y, zinv)))
    enc[31] |= (f.parity(x_c) << 7).to(torch.uint8)
    return enc


def compress_eq_plain(xyzt: torch.Tensor, r_bytes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B,) bool: valid & (enc(point) == R byte for byte)."""
    return valid & (compress(xyzt) == r_bytes).all(dim=0)


def compress_eq(xyzt: torch.Tensor, r_bytes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Kernel K4 wrapper (replaces `compress` + the R compare,
    pallas_ladder.py:160-161): CPU -> `compress_eq_plain`; CUDA ->
    `csrc/compress_eq.cu`."""
    if xyzt.device.type == "cpu":
        return compress_eq_plain(xyzt, r_bytes, valid)
    batch = xyzt.shape[-1]
    dev = xyzt.device
    _build.check(xyzt, (4, NL, batch), torch.int32, dev)
    _build.check(r_bytes, (32, batch), torch.uint8, dev)
    _build.check(valid, (batch,), torch.bool, dev)
    out = torch.empty((batch,), dtype=torch.bool, device=dev)
    _build.KERNELS["compress_eq"].launch(xyzt, r_bytes, valid, out, batch)
    return out


# --- packed (u8) wire format -------------------------------------------------
#
# (128, B) uint8 per chunk: rows 0-31 = A, 32-63 = R, 64-95 = S, 96-127 =
# h = SHA-512(R||A||M) mod L (host-hash) or the 32-byte message M
# (device-hash). 128 B per signature on the host->device link.


def split_packed128(packed: torch.Tensor) -> tuple:
    """(128, B) u8 wire array -> (a, r, s, h_or_m) (32, B) row groups."""
    return packed[0:32], packed[32:64], packed[64:96], packed[96:128]


def unpack_packed_inputs(a_bytes, r_bytes, s_bytes, h_bytes):
    """Host-hash rows -> (a bytes, r bytes, s digits, h digits); the kernels
    read the key and R bytes directly, so only the scalars are unpacked."""
    return a_bytes, r_bytes, nibble_rows(s_bytes), nibble_rows(h_bytes)


def unpack_packed_inputs_dh(packed: torch.Tensor):
    """Device-hash wire array -> (a bytes, r bytes, s digits, h digits) with
    h = SHA-512(R||A||M) mod L computed on the device (kernel K2)."""
    a_b, r_b, s_b, m_b = split_packed128(packed)
    return a_b, r_b, nibble_rows(s_b), h_digits(r_b, a_b, m_b)


# ---------------------------------------------------------------------------
# Host staging (numpy; Python hashlib for the host-hash format)
# ---------------------------------------------------------------------------

_L_BE = np.frombuffer(L_ORDER.to_bytes(32, "big"), np.uint8)


def _s_canonical_mask(s: np.ndarray) -> np.ndarray:
    """(B, 32) little-endian s rows -> (B,) bool s < L, vectorized."""
    diff = s[:, ::-1].astype(np.int16) - _L_BE.astype(np.int16)
    nz = diff != 0
    first = nz.argmax(axis=1)
    return nz.any(axis=1) & (diff[np.arange(len(s)), first] < 0)


def _stage_scalars(messages, a, r, s) -> tuple[np.ndarray, np.ndarray]:
    """Per-item host scalar work: s < L and h = SHA-512(R||A||M) mod L."""
    n = len(messages)
    h_bytes = np.empty((n, 32), np.uint8)
    for i in range(n):
        hd = hashlib.sha512(r[i].tobytes() + a[i].tobytes() + messages[i]).digest()
        h = int.from_bytes(hd, "little") % L_ORDER
        h_bytes[i] = np.frombuffer(h.to_bytes(32, "little"), np.uint8)
    return _s_canonical_mask(s), h_bytes


def _sig_rows(signatures) -> tuple[np.ndarray, np.ndarray]:
    sig = np.frombuffer(b"".join(signatures), np.uint8).reshape(len(signatures), 64)
    return sig[:, :32], sig[:, 32:]


def _rows(keys, signatures):
    a = np.frombuffer(b"".join(keys), np.uint8).reshape(len(keys), 32)
    return (a, *_sig_rows(signatures))


def prepare_batch_packed(
    messages: Sequence[bytes], keys: Sequence[bytes], signatures: Sequence[bytes]
) -> dict:
    """Host-hash staging: dict(packed=(128, B) u8, s_ok=(B,) bool), rows
    96-127 = h computed on the host."""
    a, r, s = _rows(keys, signatures)
    s_ok, h_bytes = _stage_scalars(messages, a, r, s)
    packed = np.ascontiguousarray(np.vstack([a.T, r.T, s.T, h_bytes.T]))
    return dict(packed=packed, s_ok=s_ok)


def prepare_batch_packed_dh(
    messages: Sequence[bytes], keys: Sequence[bytes], signatures: Sequence[bytes]
) -> dict:
    """Device-hash staging: rows 96-127 = the 32-byte message; only byte
    concatenation and the vectorized s < L check run on the host. Every
    message must be 32 bytes."""
    a, r, s = _rows(keys, signatures)
    m = np.frombuffer(b"".join(messages), np.uint8).reshape(len(messages), 32)
    packed = np.ascontiguousarray(np.vstack([a.T, r.T, s.T, m.T]))
    return dict(packed=packed, s_ok=_s_canonical_mask(s))


# The f32-argument form (`packed=False`): the reference's `prepare_batch`
# arrays (hotstuff_tpu/ops/ed25519.py:644-689), as uint8 with the same
# values instead of float32. It is derived from the host-hash wire rows.

SCALAR_BITS = 253


def _digits(b: np.ndarray) -> np.ndarray:
    """(32, B) u8 -> (64, B) u8 4-bit digits, row d of significance 16^d
    (the reference's `_nibbles`, :810-817)."""
    return np.stack((b & 0x0F, b >> 4), axis=1).reshape(2 * b.shape[0], b.shape[1])


_BIT_SHIFTS = np.arange(8, dtype=np.uint8)[:, None]


def _bits(b: np.ndarray) -> np.ndarray:
    """(32, B) u8 -> (253, B) u8 bits, row i = bit i (the reference's
    `unpackbits(..., bitorder="little")[:253]`, :685-686); shifts, which
    take a fraction of `np.unpackbits`' time along the byte axis."""
    return ((b[:, None, :] >> _BIT_SHIFTS) & 1).reshape(8 * b.shape[0], b.shape[1])[:SCALAR_BITS]


def f32_form(packed: np.ndarray, s_ok: np.ndarray, want_bits: bool = False) -> dict:
    """(128, B) host-hash wire rows (A, R, S, h) and the s < L mask -> the
    f32-form arrays: a_y (32, B) key bytes with row 31 & 0x7F, a_sign (B,),
    r_enc (32, B), s_digits and h_digits (64, B), s_ok (B,) bool and, with
    `want_bits`, s_bits and h_bits (253, B), row i = bit i. All uint8."""
    a, r, s, h = packed[0:32], packed[32:64], packed[64:96], packed[96:128]
    a_y = a.copy()
    a_y[31] &= 0x7F
    staged = dict(a_y=a_y, a_sign=a[31] >> 7, r_enc=r.copy(), s_digits=_digits(s), h_digits=_digits(h),
                  s_ok=np.asarray(s_ok, bool))
    if want_bits:
        staged["s_bits"], staged["h_bits"] = _bits(s), _bits(h)
    return staged


def prepare_batch(
    messages: Sequence[bytes],
    keys: Sequence[bytes],
    signatures: Sequence[bytes],
    want_bits: bool = False,
    staging: str = "native",
) -> dict:
    """f32-form staging of a batch (the reference's `prepare_batch`): the
    host-hash wire rows from the native plane's `stage_packed_hh`, one call
    (`staging="native"`), or from `prepare_batch_packed` (`"numpy"`), then
    `f32_form`. The reference's native `stage_batch` is not carried over."""
    n = len(messages)
    if staging == "native":
        out = np.empty((1, 128, n), np.uint8)
        staged = native_staging.stage_packed_hh(messages, keys, signatures, out, n, 1)
        packed = out[0]
    elif staging == "numpy":
        staged = prepare_batch_packed(messages, keys, signatures)
        packed = staged["packed"]
    else:
        raise ValueError(f"staging must be native or numpy, got {staging!r}")
    return f32_form(packed, staged["s_ok"], want_bits)


def _pad(arr: np.ndarray, width: int) -> np.ndarray:
    """`arr` zero-padded on its last axis to `width` lanes (the reference's
    `_pad`)."""
    pad = width - arr.shape[-1]
    if pad == 0:
        return arr
    return np.pad(arr, [(0, 0)] * (arr.ndim - 1) + [(0, pad)])


def kernel_args(staged: dict, width: int, kernel: str = "w4") -> tuple:
    """Padded arguments of `ladder.verify_args` for the kernel flavour
    (:1300-1310): (a_y, a_sign, r_enc, s, h), s and h as bits for "bits",
    as digits for "w4" and "pallas"."""
    scalars = ("s_bits", "h_bits") if kernel == "bits" else ("s_digits", "h_digits")
    return tuple(_pad(staged[k], width) for k in ("a_y", "a_sign", "r_enc", *scalars))


# Committee wire format: (96, B) uint8 rows 0-31 = R, 32-63 = S, 64-95 = h
# (host hash) or the 32-byte message (device hash), plus a (B,) int32
# validator index. No key row: the device holds the committee's keys.

def prepare_batch_committee(
    messages: Sequence[bytes],
    key_bytes: Sequence[bytes],
    indices: Sequence[int],
    signatures: Sequence[bytes],
) -> dict:
    """Committee host-hash staging: dict(packed=(96, B) u8, idx=(B,) int32,
    s_ok=(B,) bool), rows 64-95 = h. `key_bytes` are the resolved committee
    keys, used only to hash on the host; they are not shipped."""
    r, s = _sig_rows(signatures)
    a = np.frombuffer(b"".join(key_bytes), np.uint8).reshape(len(key_bytes), 32)
    s_ok, h_bytes = _stage_scalars(messages, a, r, s)
    packed = np.ascontiguousarray(np.vstack([r.T, s.T, h_bytes.T]))
    return dict(packed=packed, idx=np.asarray(indices, np.int32), s_ok=s_ok)


def prepare_batch_committee_dh(
    messages: Sequence[bytes], indices: Sequence[int], signatures: Sequence[bytes]
) -> dict:
    """Committee device-hash staging: rows 64-95 = the 32-byte message; the
    device reads each lane's key bytes from the committee table by index.
    Every message must be 32 bytes."""
    r, s = _sig_rows(signatures)
    m = np.frombuffer(b"".join(messages), np.uint8).reshape(len(messages), 32)
    packed = np.ascontiguousarray(np.vstack([r.T, s.T, m.T]))
    return dict(packed=packed, idx=np.asarray(indices, np.int32), s_ok=_s_canonical_mask(s))
