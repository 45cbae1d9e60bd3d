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
so kernel and plain version agree limb for limb, not only modulo p.
"""

from __future__ import annotations

import torch

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


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field multiplication, carried output.

    Overflow bound: operands have |limb| <= 2^27 (even) and 2^26 (odd)
    (at most two lazy adds of carried values); an output limb sums 10
    products with factors <= 38, < 2^61 — exact in int64."""
    PRODUCTS.n += MUL_PRODUCTS
    dev = a.device
    prod = a.long()[:, None, :] * b.long()[None, :, :]
    prod = prod * const("factor", _FACTOR, dev)[:, :, None]
    flat = prod.reshape(NL * NL, -1)[const("gather", _GATHER, dev)]
    return carry(flat.view(NL, NL, -1).sum(1))


def sqr(a: torch.Tensor) -> torch.Tensor:
    """Squaring. The kernel sums the symmetric half of the products; the
    integer result (and so every carried limb) is the same as mul(a, a)."""
    PRODUCTS.n += SQR_PRODUCTS - MUL_PRODUCTS
    return mul(a, a)


def sqr_n(a: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        a = sqr(a)
    return a


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane select: mask (B,) bool -> a where True else b."""
    return torch.where(mask[None, :], a, b)


# ---------------------------------------------------------------------------
# Fixed-exponent chains (ref10 addition chains, as ops/field.py:289-316)
# ---------------------------------------------------------------------------


def _chain_250(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (z^(2^250 - 1), z^11) — the shared prefix of invert/pow2523."""
    z2 = sqr(z)
    z8 = sqr_n(z2, 2)
    z9 = mul(z, z8)
    z11 = mul(z2, z9)
    z22 = sqr(z11)
    z_5_0 = mul(z9, z22)
    z_10_0 = mul(sqr_n(z_5_0, 5), z_5_0)
    z_20_0 = mul(sqr_n(z_10_0, 10), z_10_0)
    z_40_0 = mul(sqr_n(z_20_0, 20), z_20_0)
    z_50_0 = mul(sqr_n(z_40_0, 10), z_10_0)
    z_100_0 = mul(sqr_n(z_50_0, 50), z_50_0)
    z_200_0 = mul(sqr_n(z_100_0, 100), z_100_0)
    z_250_0 = mul(sqr_n(z_200_0, 50), z_50_0)
    return z_250_0, z11


def invert(z: torch.Tensor) -> torch.Tensor:
    """z^(p-2): multiplicative inverse (0 -> 0)."""
    z_250_0, z11 = _chain_250(z)
    return mul(sqr_n(z_250_0, 5), z11)


def pow2523(z: torch.Tensor) -> torch.Tensor:
    """z^((p-5)/8) = z^(2^252 - 3): the square-root exponent."""
    z_250_0, _ = _chain_250(z)
    return mul(sqr_n(z_250_0, 2), z)


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
