"""GF(2^255 - 19) on integer limbs, batched over the lane dimension — the
plain PyTorch version of the `__device__` field in `csrc/field.cuh`.

Counterpart of `hotstuff_tpu/ops/field.py`. The JAX package keeps 32
radix-256 f32 limbs because TPU int32 multiplies lower to multi-op
sequences; Hopper has a native 32x32->64 multiply, so the port uses the
ref10 / ed25519-dalek u32 layout instead:

  * an element batch is a `(NL, B)` integer tensor, NL = 10 limbs of
    alternating 26 and 25 bits (radix 2^25.5), batch on the last axis;
  * limbs are signed and fit int32 at every function boundary; the plain
    version computes in int64 (products of 26-bit limbs with the x19 and x2
    factors stay below 2^63);
  * `add`/`sub` are limb-wise and lazy (no carry), `mul`/`sqr` carry with
    the ref10 chain, so every mul output has |limb| <= 2^25 (even) or
    ~2^24 (odd), and every operand the curve code feeds to a mul stays
    below 2^27 — the bound the overflow argument in `mul` needs.

The CUDA kernels run the very same integer operations in the same order,
so kernel and plain version agree limb for limb, not only modulo p. The
exceptions are K4's inversion and K3's square root, whose field ops are
split over four warps (`csrc/split_field.cuh`): their limbs differ from
the ref10 chain's, their values mod p and the kernels' outputs do not;
`carry_split` and its callers below model them.
"""

from __future__ import annotations

import torch

from . import _build

P = 2**255 - 19
NL = 10
WIDTHS = (26, 25, 26, 25, 26, 25, 26, 25, 26, 25)
OFFSETS = tuple(sum(WIDTHS[:i]) for i in range(NL))  # 0, 26, 51, ..., 230

# Limb products one field op costs on the card (`csrc/field.cuh`): a mul
# is the full 10x10 schoolbook, a squaring its symmetric half (10 + 45).
MUL_PRODUCTS = NL * NL
SQR_PRODUCTS = NL + NL * (NL - 1) // 2


class ProductCount:
    """Limb products per lane done by `mul`/`sqr` since the last reset —
    the operation count behind a kernel's least time (`chip_smoke.py`).
    The count is per lane: no op here has data-dependent control flow."""

    def __init__(self) -> None:
        self.n = 0


PRODUCTS = ProductCount()

# ---------------------------------------------------------------------------
# Host-side conversions (Python ints <-> limbs)
# ---------------------------------------------------------------------------


def limbs_of_int(values, device: str | torch.device = "cpu") -> torch.Tensor:
    """(NL, len(values)) int64 limbs of nonnegative ints < 2^255 (an int
    gives one column). Limbs are in [0, 2^width); the value is NOT
    reduced mod p, so encodings of y >= p keep their value."""
    if isinstance(values, int):
        values = [values]
    cols = []
    for x in values:
        if not 0 <= x < 2**255:
            raise ValueError("limbs_of_int takes 0 <= x < 2^255")
        cols.append([(x >> o) & ((1 << w) - 1) for o, w in zip(OFFSETS, WIDTHS)])
    return torch.tensor(cols, dtype=torch.int64, device=device).T.contiguous()


def int_of_limbs(limbs: torch.Tensor) -> list[int]:
    """Exact value per batch column (limbs may be signed / unreduced)."""
    arr = limbs.detach().to("cpu", torch.int64).tolist()
    return [
        sum(int(arr[i][b]) << OFFSETS[i] for i in range(NL))
        for b in range(len(arr[0]))
    ]


ZERO = limbs_of_int(0)
ONE = limbs_of_int(1)

# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lazy limb-wise addition (no carry)."""
    return a + b


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lazy limb-wise subtraction (no carry; limbs may go negative)."""
    return a - b


def _factor_table() -> tuple[torch.Tensor, torch.Tensor]:
    """For the schoolbook product f_i * g_j: its output limb (i + j) mod NL
    and its factor — x2 when both limbs are odd (two 25-bit limbs meet at
    an odd offset: 2^(25.5 i) * 2^(25.5 j) carries a spare bit), x19 when
    i + j >= NL (2^255 = 19 mod p)."""
    factor = torch.ones(NL, NL, dtype=torch.int64)
    gather = torch.empty(NL * NL, dtype=torch.int64)
    for i in range(NL):
        for j in range(NL):
            if i % 2 and j % 2:
                factor[i, j] *= 2
            if i + j >= NL:
                factor[i, j] *= 19
    # gather[k * NL + i] = flat index of the product (i, (k - i) mod NL),
    # so a (NL, NL, B) view sums over its middle axis into output limb k.
    for k in range(NL):
        for i in range(NL):
            gather[k * NL + i] = i * NL + (k - i) % NL
    return factor, gather


_FACTOR, _GATHER = _factor_table()
_DEVICE_CONSTS: dict[tuple[str, torch.device], torch.Tensor] = {}


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors of the same bits (the
    uint32 limbs of `ops/bls.py` and `ops/field12.py`)."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def from_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int32, or int64 values below 2^32) -> int64 values in
    [0, 2^32)."""
    return x.long() & 0xFFFFFFFF


def const(name: str, t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Device-resident copy of a module constant, made once per device."""
    key = (name, device)
    out = _DEVICE_CONSTS.get(key)
    if out is None:
        out = _DEVICE_CONSTS[key] = t.to(device)
    return out


def carry(h: torch.Tensor) -> torch.Tensor:
    """The ref10 carry chain: signed rounding carries, the top carry folds
    into limb 0 as x19. Takes |limb| < 2^62; returns |even limb| <= 2^25,
    |odd limb| <= 2^24 (+ a small final carry). Value unchanged mod p."""
    r = list(h.unbind(0))

    def step(i: int) -> None:
        w = WIDTHS[i]
        c = (r[i] + (1 << (w - 1))) >> w
        r[i] = r[i] - (c << w)
        if i == NL - 1:
            r[0] = r[0] + c * 19
        else:
            r[i + 1] = r[i + 1] + c

    for i in (0, 4, 1, 5, 2, 6, 3, 7, 4, 8, 9, 0):
        step(i)
    return torch.stack(r)


def _column_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(NL, B) int64: output limb k's sum of the schoolbook products,
    lo_k + 19 hi_k (before any carry)."""
    dev = a.device
    prod = a.long()[:, None, :] * b.long()[None, :, :]
    prod = prod * const("factor", _FACTOR, dev)[:, :, None]
    flat = prod.reshape(NL * NL, -1)[const("gather", _GATHER, dev)]
    return flat.view(NL, NL, -1).sum(1)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field multiplication, carried output.

    Overflow bound: operands have |limb| <= 2^27 (even) and 2^26 (odd)
    (at most two lazy adds of carried values); an output limb sums 10
    products with factors <= 38, < 2^61 — exact in int64."""
    PRODUCTS.n += MUL_PRODUCTS
    return carry(_column_sums(a, b))


def sqr(a: torch.Tensor) -> torch.Tensor:
    """Squaring. The kernel sums the symmetric half of the products; the
    integer result (and so every carried limb) is the same as mul(a, a)."""
    PRODUCTS.n += SQR_PRODUCTS - MUL_PRODUCTS
    return mul(a, a)


def sqr_n(a: torch.Tensor, n: int, sqr=sqr) -> torch.Tensor:
    for _ in range(n):
        a = sqr(a)
    return a


def sqr_chain(x: torch.Tensor, n: int) -> torch.Tensor:
    """n squarings of (NL, B) carried limbs, int32 out: CPU tensors ->
    `sqr_n`; CUDA tensors -> `csrc/field_sqr_n.cu` (`fe_sq` n times a lane
    in one launch, the device tuning tool's production-field chain), which
    equals `sqr_n` limb for limb."""
    if x.device.type == "cpu":
        return sqr_n(x.long(), n).to(torch.int32)
    batch = x.shape[1]
    _build.check(x, (NL, batch), torch.int32, x.device)
    out = torch.empty_like(x)
    _build.KERNELS["field_sqr_n"].launch(x, out, n, batch)
    return out


# ---------------------------------------------------------------------------
# The split multiply (`csrc/split_field.cuh`): a model, not a plain version
# ---------------------------------------------------------------------------
#
# K4 and K3 spread each field product over four warps by output column. Warp g
# sums the columns of SPLIT_GROUPS[g] and takes one rounding carry out of
# each (round 1); after one exchange every warp adds the carries in and
# takes a second rounding carry over all ten limbs (round 2). The limbs
# differ from the ref10 chain's; the value mod p does not. These functions
# run round 1 and round 2 in the kernel's integer steps, so the CPU tests
# hold the kernel's arithmetic and bounds; no plain version calls them.

SPLIT_GROUPS = ((0, 1, 2), (3, 4, 5), (6, 7), (8, 9))
# Bound on a carry_split output limb (csrc/split_field.cuh), for column
# sums below 2^61 (operands within mul's bound): |even| <= 2^25 + 2^15,
# |odd| <= 2^24 + 2^15.
SPLIT_BOUND = tuple((1 << (w - 1)) + (1 << 15) for w in WIDTHS)


def carry_split(h: torch.Tensor) -> torch.Tensor:
    """The split carry of (NL, B) column sums (|h| < 2^61): round 1, one
    rounding carry c_i out of every limb (r_i = h_i - c_i 2^w_i); limb i
    then holds r_i + c_{i-1}, limb 0 r_0 + 19 c_9; round 2, the same once
    more over all ten limbs. Value unchanged mod p."""

    def round_(h: torch.Tensor) -> torch.Tensor:
        w = const("widths", torch.tensor(WIDTHS, dtype=torch.int64)[:, None], h.device)
        c = (h + (1 << (w - 1))) >> w
        c_in = torch.roll(c, 1, 0)
        c_in[0] *= 19
        return h - (c << w) + c_in

    return round_(round_(h.long()))


def mul_split(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field multiplication with the split carry (same column sums as
    `mul`, so the same bound on its operands)."""
    return carry_split(_column_sums(a, b))


def sqr_split(a: torch.Tensor) -> torch.Tensor:
    """Squaring with the split carry (the kernel sums the symmetric half
    of the products per column; the integer column sums are mul's)."""
    return mul_split(a, a)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane select: mask (B,) bool -> a where True else b."""
    return torch.where(mask[None, :], a, b)


# ---------------------------------------------------------------------------
# Fixed-exponent chains (ref10 addition chains, as ops/field.py:289-316)
# ---------------------------------------------------------------------------


def _chain_250(z: torch.Tensor, mul=mul, sqr=sqr) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (z^(2^250 - 1), z^11) — the shared prefix of invert/pow2523,
    with the given multiply and squaring."""
    z2 = sqr(z)
    z8 = sqr_n(z2, 2, sqr)
    z9 = mul(z, z8)
    z11 = mul(z2, z9)
    z22 = sqr(z11)
    z_5_0 = mul(z9, z22)
    z_10_0 = mul(sqr_n(z_5_0, 5, sqr), z_5_0)
    z_20_0 = mul(sqr_n(z_10_0, 10, sqr), z_10_0)
    z_40_0 = mul(sqr_n(z_20_0, 20, sqr), z_20_0)
    z_50_0 = mul(sqr_n(z_40_0, 10, sqr), z_10_0)
    z_100_0 = mul(sqr_n(z_50_0, 50, sqr), z_50_0)
    z_200_0 = mul(sqr_n(z_100_0, 100, sqr), z_100_0)
    z_250_0 = mul(sqr_n(z_200_0, 50, sqr), z_50_0)
    return z_250_0, z11


def invert(z: torch.Tensor) -> torch.Tensor:
    """z^(p-2): multiplicative inverse (0 -> 0)."""
    z_250_0, z11 = _chain_250(z)
    return mul(sqr_n(z_250_0, 5), z11)


def pow2523(z: torch.Tensor) -> torch.Tensor:
    """z^((p-5)/8) = z^(2^252 - 3): the square-root exponent."""
    z_250_0, _ = _chain_250(z)
    return mul(sqr_n(z_250_0, 2), z)


def invert_split(z: torch.Tensor) -> torch.Tensor:
    """`invert` with the split multiply and squaring (K4's inversion)."""
    z_250_0, z11 = _chain_250(z, mul_split, sqr_split)
    return mul_split(sqr_n(z_250_0, 5, sqr_split), z11)


def pow2523_split(z: torch.Tensor) -> torch.Tensor:
    """`pow2523` with the split multiply and squaring (K3's square root)."""
    z_250_0, _ = _chain_250(z, mul_split, sqr_split)
    return mul_split(sqr_n(z_250_0, 2, sqr_split), z)


# ---------------------------------------------------------------------------
# Canonical form (value mod p, limbs in [0, 2^width))
# ---------------------------------------------------------------------------


def canonical(x: torch.Tensor) -> torch.Tensor:
    """THE representative of x mod p: carry, then ref10's fe_tobytes
    reduction — q = floor(x / p) from the rounded estimate 19 * h9 / 2^25
    rippled through the limbs, x + 19q, floor carries that drop 2^255 q."""
    r = list(carry(x.long()).unbind(0))
    q = (19 * r[NL - 1] + (1 << 24)) >> 25
    for i in range(NL):
        q = (r[i] + q) >> WIDTHS[i]
    r[0] = r[0] + 19 * q
    for i in range(NL):
        w = WIDTHS[i]
        c = r[i] >> w
        r[i] = r[i] - (c << w)
        if i + 1 < NL:
            r[i + 1] = r[i + 1] + c
    return torch.stack(r)


def eq_canonical(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B,) bool equality of two canonical elements."""
    return (a == b).all(dim=0)


def parity(x_canonical: torch.Tensor) -> torch.Tensor:
    """(B,) int64 in {0, 1}: low bit of the canonical value (sign of x)."""
    return x_canonical[0] & 1


# ---------------------------------------------------------------------------
# Bytes <-> limbs (little-endian, as the wire rows carry them)
# ---------------------------------------------------------------------------


def from_bytes(b: torch.Tensor) -> torch.Tensor:
    """(32, B) uint8 little-endian encoding -> (NL, B) limbs of its low 255
    bits (bit 255, the sign of x in a point encoding, is dropped)."""
    v = b.long()
    out = []
    for o, w in zip(OFFSETS, WIDTHS):
        acc = torch.zeros_like(v[0])
        for j in range(o // 8, (o + w - 1) // 8 + 1):
            s = 8 * j - o
            acc = acc | ((v[j] << s) if s >= 0 else (v[j] >> -s))
        out.append(acc & ((1 << w) - 1))
    return torch.stack(out)


def to_bytes(x_canonical: torch.Tensor) -> torch.Tensor:
    """(NL, B) canonical limbs -> (32, B) uint8 little-endian encoding."""
    v = x_canonical.long()
    out = []
    for k in range(32):
        acc = torch.zeros_like(v[0])
        for i, (o, w) in enumerate(zip(OFFSETS, WIDTHS)):
            if o + w <= 8 * k or o >= 8 * k + 8:
                continue
            s = o - 8 * k
            acc = acc | ((v[i] << s) if s >= 0 else (v[i] >> -s))
        out.append(acc & 0xFF)
    return torch.stack(out).to(torch.uint8)
