"""BLS12-381 G1 committee aggregation on the card — kernel K6.

Counterpart of `hotstuff_tpu/ops/bls.py`. An aggregate certificate (AggQC /
AggTC) carries one BLS signature and a committee bitmap, and is checked with
one pairing against the SUM of the bitmap members' G1 public keys. The sum
is O(committee) and costs the host a field inversion per key; here it runs
on the card over a device-resident key table:

  * Fp in 12 limbs of 32 bits (the reference's 32 limbs of 12 bits hold the
    same 384 bits). The Montgomery radix is R = 2^384 in both packages, so
    a residue is the same integer on both sides and `convert.py` carries one
    across by repacking its bits. Tensors hold limbs as int64 values in
    [0, 2^32) in the plain functions, and as int32 bit patterns at the
    kernel's boundary (tables, outputs).
  * Residues are fully reduced, in [0, p), after every operation (the
    reference keeps them in [0, 2p)). A value then has one digit string:
    zero is all-zero limbs, and the kernel and the plain version, which
    compute the same formulas in the same order, agree limb for limb. The
    plain field functions take operands in [0, 2p), the reference's
    invariant, so they take the reference's values as they are.
  * Montgomery multiplication: the kernel interleaves product and
    reduction a 32-bit digit of b at a time, in two carry chains (the even
    and the odd limbs' products, `csrc/carry.cuh`); the plain `mont_mul`
    reduces over 16-bit digits on int64 tensors (every product is of two
    16-bit halves, every column sum exact and non-negative). Both compute
    t = (ab + mp) / R with m the one value in [0, R) that makes the sum
    divisible by R, so t is the same integer; a conditional subtraction of
    p makes it canonical.
  * Jacobian points with Z = 0 as the identity, written (mont(1), mont(1),
    0) as in the reference. `point_dbl` (dbl-2009-l, a = 0) and `point_add`
    (add-2007-bl, the four special cases resolved in the reference's order)
    are the reference's formulas; `point_madd` adds an affine point (Z2 = 1,
    madd-2007-bl, 7M + 4S) and is what the fold runs per member.

`g1_aggregate` and `g1_aggregate_affine` are the kernel wrappers: CUDA
tensors launch `csrc/g1_aggregate.cu` (`hs_g1_aggregate`, the fold alone,
and `hs_g1_aggregate_affine`, the fold and each row's affine conversion in
one launch), CPU tensors take `g1_aggregate_plain` /
`g1_aggregate_affine_plain`. Both fold a row's members in one order:
THREADS partial sums, member k into partial k mod THREADS in ascending k (a
mixed add each), then a halving tree of Jacobian adds over the partials.
The conversion inverts Z by the kernel's fixed chain, Z^(p - 2) over
INV_WINDOWS (`invert_plain`), as the reference does on its host
(`pow(z, P - 2, P)`), and leaves Montgomery form by a product with 1.
`mont_mul_device` runs the kernel's field product alone (a test entry).

`CommitteeTable` mirrors the reference's, name for name: keys decompressed
once per committee on the host (exact integers, the port's
`crypto/aggsig.py`), Montgomery-affine limbs resident on the device,
`aggregate_masks` / `aggregate_bitmaps` in one launch per call that returns
affine limbs (the host only reads them into ints, `affine_of_limbs`), and
`verify_aggregate` with one exact pairing on the host. There is no host
fallback: the table asks for the card unless `device="cpu"` is given, and
the plain version runs only on CPU tensors.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import resolve_device
from ..crypto import aggsig
from ..utils import metrics
from . import _build
from .field import const, from_i32, to_i32

P = aggsig.P
NLIMB = 12
BITS = 32
MASK = (1 << BITS) - 1
R_MONT = (1 << (BITS * NLIMB)) % P  # 2^384 mod p, the reference's R
R_INV = pow(R_MONT, -1, P)
PINV32 = (-pow(P, -1, 1 << 32)) % (1 << 32)  # -p^-1 mod 2^32: the kernel's CIOS digit factor
PINV16 = (-pow(P, -1, 1 << 16)) % (1 << 16)  # -p^-1 mod 2^16: the plain reduction's
THREADS = 32  # partial sums per row; a row's warp in csrc/g1_aggregate.cu

_M_TABLE_BUILDS = metrics.counter("bls.table_builds")
_M_AGGREGATIONS = metrics.counter("bls.aggregations")
_M_POINTS = metrics.counter("bls.points_aggregated")


def _digits(x: int, n: int, bits: int) -> list[int]:
    return [(x >> (bits * i)) & ((1 << bits) - 1) for i in range(n)]


def limbs_of_int(values: int | Sequence[int]) -> torch.Tensor:
    """int or ints in [0, 2^384) -> (12, B) int64 limbs of 32 bits (limb i
    has weight 2^(32 i))."""
    if isinstance(values, int):
        values = [values]
    for v in values:
        assert 0 <= v < 1 << (BITS * NLIMB)
    return torch.tensor([_digits(v, NLIMB, BITS) for v in values], dtype=torch.int64).reshape(-1, NLIMB).T.contiguous()


def int_of_limbs(limbs: torch.Tensor) -> list[int]:
    """(12, B) limbs, int64 values or int32 bit patterns -> B ints."""
    cols = (limbs.reshape(NLIMB, -1).long() & MASK).T.tolist()
    return [sum(d << (BITS * i) for i, d in enumerate(col)) for col in cols]


def sliding_windows(e: int, width: int) -> tuple[tuple[int, int], ...]:
    """e > 0 as (squarings, odd digit) pairs, most significant first, each
    digit below 2^width: x^e is x^d0, then per later pair s squarings and
    a product by x^d. Every digit ends on a set bit, so a zero run lands in
    the next pair's squarings; e must be odd (no squarings after the last
    digit)."""
    bits = bin(e)[2:]
    assert e > 0 and bits[-1] == "1"
    out, i, shift = [], 0, 0
    while i < len(bits):
        if bits[i] == "0":
            shift, i = shift + 1, i + 1
            continue
        j = min(i + width, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        out.append((shift + j - i, int(bits[i:j], 2)))
        shift, i = 0, j
    return tuple(out)


# p - 2 in 5-bit windows: the kernel's `__constant__ INV_WINDOWS` (the
# same pairs; tests/test_torch_bls.py parses them from the source).
INV_WINDOWS = sliding_windows(P - 2, 5)
INV_ODD = 16  # odd powers x, x^3, ..., x^31 a 5-bit window reads


def to_mont(x: int) -> int:
    return x * R_MONT % P


def from_mont(x: int) -> int:
    return x * R_INV % P


P_LIMBS = limbs_of_int(P)
TWOP_LIMBS = limbs_of_int(2 * P)
MONT_ONE = to_mont(1)
_P_DIGITS = _digits(P, NLIMB, BITS)
_TWOP_DIGITS = _digits(2 * P, NLIMB, BITS)
_P16 = torch.tensor(_digits(P, 2 * NLIMB, 16), dtype=torch.int64)
_ONE_LIMBS = limbs_of_int(MONT_ONE)
_PLAIN_ONE = limbs_of_int(1)  # a product by 1 leaves Montgomery form


def _col(name: str, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (k, 1) constant on `like`'s device, shaped to broadcast against
    (k, *like.shape[1:])."""
    return const(name, t, like.device).reshape((t.shape[0],) + (1,) * (like.dim() - 1))


# --- the field, plain versions on int64 limbs ---------------------------------


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """Non-negative int64 columns (12, ...) -> limbs in [0, 2^32); the carry
    out of the top limb is dropped (every caller's value is known)."""
    out, carry = [], None
    for j in range(NLIMB):
        v = x[j] if carry is None else x[j] + carry
        out.append(v & MASK)
        carry = v >> BITS
    return torch.stack(out)


def _cond_sub(x: torch.Tensor, m: list[int]) -> torch.Tensor:
    """x - m where x >= m, else x; normalized limbs, m a constant's limbs."""
    out, borrow = [], None
    for j in range(NLIMB):
        v = x[j] - m[j] if borrow is None else x[j] - m[j] - borrow
        borrow = (v < 0).long()
        out.append(v + (borrow << BITS))
    return torch.where((borrow == 0)[None], torch.stack(out), x)


def add_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b mod p, canonical in [0, p); a, b in [0, 2p)."""
    return _cond_sub(_cond_sub(_normalize(a + b), _TWOP_DIGITS), _P_DIGITS)


def sub_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod p, canonical in [0, p); a, b in [0, 2p). Computed as
    a + 2p + (2^384 - 1 - b) + 1 = a - b + 2p + 2^384, every column
    non-negative; the 2^384 is the carry dropped out of the top limb."""
    s = a + (MASK - b) + _col("bls_twop", TWOP_LIMBS, a)
    s[0] += 1
    return _cond_sub(_cond_sub(_normalize(s), _TWOP_DIGITS), _P_DIGITS)


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a b / R mod p, canonical in [0, p); a in [0, 2p),
    b in [0, 4p) (the reference's admissible operands). The product and
    the reduction run on 16-bit digits: 24 x 24 digit products < 2^32,
    columns < 2^39 with the reduction's addends and carries."""
    a, b = torch.broadcast_tensors(a, b)
    rest = a.shape[1:]
    a16 = torch.stack((a & 0xFFFF, a >> 16), dim=1).reshape((2 * NLIMB,) + rest)
    b16 = torch.stack((b & 0xFFFF, b >> 16), dim=1).reshape((2 * NLIMB,) + rest)
    c = torch.zeros((4 * NLIMB,) + rest, dtype=torch.int64, device=a.device)
    for i in range(2 * NLIMB):
        c[i:i + 2 * NLIMB] += a16[i] * b16
    p16 = _col("bls_p16", _P16, a)
    for i in range(2 * NLIMB):
        m = ((c[i] & 0xFFFF) * PINV16) & 0xFFFF
        c[i:i + 2 * NLIMB] += m * p16
        c[i + 1] += c[i] >> 16  # digit i is now 0 mod 2^16: retire it
    hi = c[2 * NLIMB:]  # t = (ab + mp) / R in 24 columns of weight 2^(16 k)
    cols = hi[0::2] + (hi[1::2] << 16)  # 12 columns of weight 2^(32 k), < 2^56
    return _cond_sub(_normalize(cols), _P_DIGITS)  # t < 2p < 2^384


def mont_sqr(a: torch.Tensor) -> torch.Tensor:
    return mont_mul(a, a)


def is_zero_mod_p(a: torch.Tensor) -> torch.Tensor:
    """Value = 0 (mod p) for a residue in [0, 2p): its limbs are 0 or p's
    (the plain functions return 0 only as all-zero limbs)."""
    return (a == 0).all(0) | (a == _col("bls_p", P_LIMBS, a)).all(0)


def dbl_mod(a: torch.Tensor) -> torch.Tensor:
    return add_mod(a, a)


# --- the group, plain versions -------------------------------------------------


def point_identity(batch: tuple, device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    one = const("bls_one", _ONE_LIMBS, device).reshape((NLIMB,) + (1,) * len(batch)).expand((NLIMB,) + batch)
    return one, one, torch.zeros((NLIMB,) + batch, dtype=torch.int64, device=device)


def _pick(m: torch.Tensor, a: tuple, b: tuple) -> tuple:
    return tuple(torch.where(m[None], x, y) for x, y in zip(a, b))


def point_dbl(pt: tuple) -> tuple:
    """Jacobian doubling (dbl-2009-l, a = 0), the reference's steps. Y = 0
    gives Z3 = 0, the identity."""
    X, Y, Z = pt
    A = mont_sqr(X)
    B = mont_sqr(Y)
    C = mont_sqr(B)
    D = dbl_mod(sub_mod(sub_mod(mont_sqr(add_mod(X, B)), A), C))
    E = add_mod(dbl_mod(A), A)
    X3 = sub_mod(sub_mod(mont_sqr(E), D), D)
    Y3 = sub_mod(mont_mul(E, sub_mod(D, X3)), dbl_mod(dbl_mod(dbl_mod(C))))
    Z3 = dbl_mod(mont_mul(Y, Z))
    return X3, Y3, Z3


def point_add(p1: tuple, p2: tuple) -> tuple:
    """Jacobian addition (add-2007-bl) with the special cases selected by
    lane masks in the reference's order: doubling and the inverse pair
    first (H = 0 on identity lanes too), then p1 the identity -> p2, then
    p2 the identity -> p1 (both: p1)."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    Z1Z1 = mont_sqr(Z1)
    Z2Z2 = mont_sqr(Z2)
    U1 = mont_mul(X1, Z2Z2)
    U2 = mont_mul(X2, Z1Z1)
    S1 = mont_mul(mont_mul(Y1, Z2), Z2Z2)
    S2 = mont_mul(mont_mul(Y2, Z1), Z1Z1)
    H = sub_mod(U2, U1)
    Sd = sub_mod(S2, S1)
    Rr = dbl_mod(Sd)
    I = mont_sqr(dbl_mod(H))
    J = mont_mul(H, I)
    V = mont_mul(U1, I)
    X3 = sub_mod(sub_mod(mont_sqr(Rr), J), dbl_mod(V))
    Y3 = sub_mod(mont_mul(Rr, sub_mod(V, X3)), dbl_mod(mont_mul(S1, J)))
    Z3 = dbl_mod(mont_mul(mont_mul(Z1, Z2), H))

    eq_x, eq_y = is_zero_mod_p(H), is_zero_mod_p(Sd)
    out = _pick(eq_x & eq_y, point_dbl(p1), (X3, Y3, Z3))
    out = _pick(eq_x & ~eq_y, point_identity(tuple(X1.shape[1:]), X1.device), out)
    out = _pick(is_zero_mod_p(Z1), p2, out)
    return _pick(is_zero_mod_p(Z2), p1, out)


def point_madd(p1: tuple, x2: torch.Tensor, y2: torch.Tensor, sel: torch.Tensor) -> tuple:
    """p1 + (x2, y2) on the lanes where `sel` is set (madd-2007-bl: the
    affine point has Z2 = 1, 7M + 4S), p1 elsewhere. (x2, y2) is never the
    identity. Special cases in the kernel's order: p1 the identity ->
    (x2, y2, mont(1)); H = 0 -> doubling, or the identity for the inverse
    pair."""
    X1, Y1, Z1 = p1
    Z1Z1 = mont_sqr(Z1)
    U2 = mont_mul(x2, Z1Z1)
    S2 = mont_mul(y2, mont_mul(Z1, Z1Z1))
    H = sub_mod(U2, X1)
    Sd = sub_mod(S2, Y1)
    HH = mont_sqr(H)
    I = dbl_mod(dbl_mod(HH))
    J = mont_mul(H, I)
    r = dbl_mod(Sd)
    V = mont_mul(X1, I)
    X3 = sub_mod(sub_mod(mont_sqr(r), J), dbl_mod(V))
    Y3 = sub_mod(mont_mul(r, sub_mod(V, X3)), dbl_mod(mont_mul(Y1, J)))
    Z3 = sub_mod(sub_mod(mont_sqr(add_mod(Z1, H)), Z1Z1), HH)

    batch = tuple(X1.shape[1:])
    eq_x, eq_y = is_zero_mod_p(H), is_zero_mod_p(Sd)
    out = _pick(eq_x & eq_y, point_dbl(p1), (X3, Y3, Z3))
    out = _pick(eq_x & ~eq_y, point_identity(batch, X1.device), out)
    one = point_identity(batch, X1.device)[0]
    out = _pick(is_zero_mod_p(Z1), (x2.expand_as(X1), y2.expand_as(X1), one), out)
    return _pick(sel, out, p1)


def g1_aggregate_plain(
    tx: torch.Tensor, ty: torch.Tensor, present: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """(12, N) int32 Montgomery-affine key limbs, (N,) bool present, (B, N)
    bool mask -> (3, 12, B) int32 Montgomery Jacobian limbs of each row's
    sum over the lanes with both bits set. The kernel's fold: partial t of
    THREADS takes lanes t, t + THREADS, ... in order by mixed adds, then
    partial t += partial t + s for s = THREADS / 2, ..., 1."""
    n, batch = tx.shape[1], mask.shape[0]
    steps = -(-n // THREADS)
    pad = steps * THREADS - n
    eff = torch.cat((mask & present[None], mask.new_zeros((batch, pad))), 1)
    x = torch.cat((from_i32(tx), tx.new_zeros((NLIMB, pad), dtype=torch.int64)), 1)
    y = torch.cat((from_i32(ty), ty.new_zeros((NLIMB, pad), dtype=torch.int64)), 1)
    acc = point_identity((batch, THREADS), tx.device)
    for s in range(steps):
        lanes = slice(s * THREADS, (s + 1) * THREADS)
        acc = point_madd(acc, x[:, None, lanes], y[:, None, lanes], eff[:, lanes])
    width = THREADS
    while width > 1:
        half = width // 2
        acc = point_add(tuple(c[..., :half] for c in acc), tuple(c[..., half:width] for c in acc))
        width = half
    return torch.stack([to_i32(c[..., 0]) for c in acc])


def g1_aggregate(tx: torch.Tensor, ty: torch.Tensor, present: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Kernel K6 wrapper (replaces `masked_tree_aggregate` and the field and
    point functions it runs, `hotstuff_tpu/ops/bls.py:180-319`): CPU
    tensors -> `g1_aggregate_plain`; CUDA tensors -> `hs_g1_aggregate` in
    `csrc/g1_aggregate.cu`, one warp per mask row (raises if it cannot
    launch)."""
    if tx.device.type == "cpu":
        return g1_aggregate_plain(tx, ty, present, mask)
    n, batch = tx.shape[1], mask.shape[0]
    dev = tx.device
    _build.check(tx, (NLIMB, n), torch.int32, dev)
    _build.check(ty, (NLIMB, n), torch.int32, dev)
    _build.check(present, (n,), torch.bool, dev)
    _build.check(mask, (batch, n), torch.bool, dev)
    out = torch.empty((3, NLIMB, batch), dtype=torch.int32, device=dev)
    if batch:
        _build.KERNELS["g1_aggregate"].launch(tx, ty, present, mask, out, n, batch)
    return out


def mont_pow_plain(a: torch.Tensor, windows: Sequence[tuple[int, int]]) -> torch.Tensor:
    """a^e by the kernel's window chain, e given as `sliding_windows`
    pairs with digits below 32; Montgomery limbs in and out, canonical. The
    odd powers a, a^3, ..., a^31 (one squaring, INV_ODD - 1 products), then
    acc = a^d0 and per later window s squarings and a product."""
    a2 = mont_sqr(a)
    odd = [a]
    for _ in range(INV_ODD - 1):
        odd.append(mont_mul(odd[-1], a2))
    acc = odd[windows[0][1] >> 1]
    for s, d in windows[1:]:
        for _ in range(s):
            acc = mont_sqr(acc)
        acc = mont_mul(acc, odd[d >> 1])
    return acc


def invert_plain(a: torch.Tensor) -> torch.Tensor:
    """(12, ...) Montgomery limbs of z -> those of z^-1 (0 for 0): z^(p - 2)
    over INV_WINDOWS, the chain `hs_g1_aggregate_affine` runs."""
    return mont_pow_plain(a, INV_WINDOWS)


def g1_aggregate_affine_plain(
    tx: torch.Tensor, ty: torch.Tensor, present: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """`g1_aggregate_plain`'s sums in affine form: (2, 12, B) int32
    canonical limbs of x and y (not Montgomery) and (B,) uint8, 1 where the
    sum is the identity (Z = 0; x and y are then 0). The kernel's steps:
    zi = invert_plain(Z), then X zi^2 and Y zi^3, each times 1."""
    X, Y, Z = (from_i32(c) for c in g1_aggregate_plain(tx, ty, present, mask))
    one = _col("bls_plain_one", _PLAIN_ONE, Z)
    zi = invert_plain(Z)
    zi2 = mont_sqr(zi)
    x = mont_mul(mont_mul(zi2, X), one)
    y = mont_mul(mont_mul(mont_mul(zi2, zi), Y), one)
    return torch.stack([to_i32(x), to_i32(y)]), (Z == 0).all(0).to(torch.uint8)


def g1_aggregate_affine(
    tx: torch.Tensor, ty: torch.Tensor, present: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K6's affine entry (replaces `masked_tree_aggregate` and
    `aggregate_masks`' conversion, `hotstuff_tpu/ops/bls.py:297,389-419`):
    CPU tensors -> `g1_aggregate_affine_plain`; CUDA tensors ->
    `hs_g1_aggregate_affine` in `csrc/g1_aggregate.cu` (raises if it cannot
    launch). Returns (2, 12, B) int32 limbs of x and y and (B,) uint8
    identity flags."""
    if tx.device.type == "cpu":
        return g1_aggregate_affine_plain(tx, ty, present, mask)
    n, batch = tx.shape[1], mask.shape[0]
    dev = tx.device
    _build.check(tx, (NLIMB, n), torch.int32, dev)
    _build.check(ty, (NLIMB, n), torch.int32, dev)
    _build.check(present, (n,), torch.bool, dev)
    _build.check(mask, (batch, n), torch.bool, dev)
    out = torch.empty((2, NLIMB, batch), dtype=torch.int32, device=dev)
    identity = torch.empty((batch,), dtype=torch.uint8, device=dev)
    if batch:
        _build.KERNELS["g1_aggregate_affine"].launch(tx, ty, present, mask, out, identity, n, batch)
    return out, identity


def mont_mul_device(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's Montgomery product alone (`hs_bls_mont_mul` in
    `csrc/g1_aggregate.cu`, a test entry) on (12, B) int32 limbs in [0, 2p):
    CPU tensors -> `mont_mul`; CUDA tensors -> the kernel's own
    `__device__` product (raises if it cannot launch)."""
    if a.device.type == "cpu":
        return to_i32(mont_mul(from_i32(a), from_i32(b)))
    batch = a.shape[1]
    _build.check(a, (NLIMB, batch), torch.int32, a.device)
    _build.check(b, (NLIMB, batch), torch.int32, a.device)
    out = torch.empty((NLIMB, batch), dtype=torch.int32, device=a.device)
    _build.KERNELS["bls_mont_mul"].launch(a, b, out, batch)
    return out


def affine_of_limbs(limbs: torch.Tensor, identity: torch.Tensor) -> list[tuple[int, int] | None]:
    """(2, 12, B) canonical limbs of x and y and (B,) identity flags, as
    `g1_aggregate_affine` returns them -> B affine integer points, None
    for the identity. One bytes view of all rows, then `int.from_bytes`
    per coordinate."""
    raw = limbs.cpu().permute(2, 0, 1).contiguous().numpy().view(np.uint32).astype("<u4", copy=False).tobytes()
    size = NLIMB * BITS // 8
    out: list[tuple[int, int] | None] = []
    for b, flag in enumerate(identity.cpu().tolist()):
        if flag:
            out.append(None)
            continue
        o = 2 * size * b
        out.append((int.from_bytes(raw[o:o + size], "little"), int.from_bytes(raw[o + size:o + 2 * size], "little")))
    return out


def affine_points(jac: torch.Tensor) -> list[tuple[int, int] | None]:
    """(3, 12, B) Montgomery Jacobian limbs -> B affine integer points, None
    for the identity (Z = 0 mod p). Exact integers on the host: the
    conversion `aggregate_masks` ran before the kernel took it over, kept
    for the tests and for timing the two against each other."""
    xs, ys, zs = (int_of_limbs(c) for c in jac.cpu())
    out = []
    for x, y, z in zip(xs, ys, zs):
        x, y, z = from_mont(x % P), from_mont(y % P), from_mont(z % P)
        if z == 0:
            out.append(None)
            continue
        zinv = pow(z, -1, P)
        zi2 = zinv * zinv % P
        out.append((x * zi2 % P, y * zinv % P * zi2 % P))
    return out


# --- the committee table --------------------------------------------------------


class CommitteeTable:
    """Device-resident Montgomery-affine G1 limbs of one committee's
    aggregate keys, built once per epoch (as `CommitteeTable`,
    `hotstuff_tpu/ops/bls.py:326-453`).

    `keys` are 48-byte compressed G1 public keys in bitmap order. A key that
    does not decompress occupies an identity lane and is flagged in
    `invalid`; its bits add nothing to a sum, and `verify_aggregate` refuses
    any bitmap that selects it. `index` maps a key to its first lane;
    `points` holds each key's affine integers (None: no point).

      tx, ty  : (12, N) int32 limbs of mont(x), mont(y) (zeros where absent)
      present : (N,) bool, a point decompressed there
    on `device` (the card unless `device="cpu"`; no card raises)."""

    def __init__(self, keys: Sequence[bytes], device: str | torch.device | None = None) -> None:
        self.device = resolve_device(device)
        keys = [bytes(k) for k in keys]
        if not keys:
            raise ValueError("committee must have at least one key")
        n = len(keys)
        self.keys = keys
        self.index: dict[bytes, int] = {}
        for i, k in enumerate(keys):
            self.index.setdefault(k, i)
        self.points: list[tuple[int, int] | None] = []
        xs, ys = [0] * n, [0] * n
        present = np.zeros(n, bool)
        invalid = np.zeros(n, bool)
        for i, kb in enumerate(keys):
            try:
                pt = aggsig.decompress_g1(kb)
            except ValueError:
                pt = None
                invalid[i] = True
            self.points.append(pt)
            if pt is None:
                continue
            present[i] = True
            xs[i], ys[i] = to_mont(pt[0]), to_mont(pt[1])
        self.size = n
        self.invalid = invalid
        self.tx = to_i32(limbs_of_int(xs)).to(self.device)
        self.ty = to_i32(limbs_of_int(ys)).to(self.device)
        self.present = torch.from_numpy(present).to(self.device)
        _M_TABLE_BUILDS.inc()

    def aggregate_masks(self, masks) -> list[tuple[int, int] | None]:
        """(B, N) bool mask rows -> affine integer G1 sums (None = the
        identity), one kernel launch that also converts each sum to affine
        form; the host only reads the limbs into ints. Masked lanes whose
        key was invalid contribute the identity; callers gate on `invalid`
        first."""
        masks = np.ascontiguousarray(masks, bool)
        if masks.ndim == 1:
            masks = masks[None]
        if masks.shape[1] != self.size:
            raise ValueError(f"mask width {masks.shape[1]} != committee size {self.size}")
        _M_AGGREGATIONS.inc(masks.shape[0])
        _M_POINTS.inc(int(masks.sum()))
        rows = torch.from_numpy(masks).to(self.device)
        return affine_of_limbs(*g1_aggregate_affine(self.tx, self.ty, self.present, rows))

    def _masks_of_bitmaps(self, bitmaps: Sequence[int]) -> np.ndarray:
        """Bitmaps (bit i = lane i) -> (B, N) bool rows; a bit beyond the
        committee raises ValueError."""
        nbytes = -(-self.size // 8)
        masks = np.zeros((len(bitmaps), self.size), bool)
        for b, bm in enumerate(bitmaps):
            if bm < 0 or bm >> self.size:
                raise ValueError(f"bitmap {bm:#x} exceeds committee")
            bits = np.unpackbits(np.frombuffer(bm.to_bytes(nbytes, "little"), np.uint8), bitorder="little")
            masks[b] = bits[: self.size]
        return masks

    def aggregate_bitmaps(self, bitmaps: Sequence[int]) -> list[tuple[int, int] | None]:
        return self.aggregate_masks(self._masks_of_bitmaps(bitmaps))

    def verify_aggregate(self, bitmap: int, msg: bytes, sig: bytes) -> bool:
        """One AggQC-shaped check: the device-summed aggregate key of
        `bitmap`, then one pairing equation on the exact host backend. A
        bitmap that selects an invalid lane is refused before the sum."""
        for i in range(self.size):
            if bitmap >> i & 1 and self.invalid[i]:
                return False
        apk = self.aggregate_bitmaps([bitmap])[0]
        if apk is None:
            return False
        try:
            s = aggsig.decompress_g2(sig)
        except ValueError:
            return False
        if s is None or not aggsig._g2_in_subgroup(s):
            return False
        return aggsig._pairings_are_one(
            [(aggsig._g1_neg(aggsig.G1_GEN), s), (apk, aggsig.hash_to_g2(msg))]
        )
