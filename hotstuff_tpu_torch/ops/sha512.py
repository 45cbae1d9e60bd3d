"""Batched h = SHA-512(R || A || M) mod L on the card — kernel K2.

Counterpart of `hotstuff_tpu/ops/sha512.py:h_digits_on_device`. The
protocol signs 32-byte digests, so R || A || M is a fixed 96-byte message:
one padded SHA-512 block. The JAX package emulates 64-bit words as (hi, lo)
uint32 pairs and reduces mod L with f32 limb folds; the port has native
64-bit integers:

  * `sha512_96`: 80 rounds on int64 words (two's complement wraps like
    uint64; right shifts are masked to act as logical shifts);
  * `reduce_mod_l`: three limb-aligned folds with 2^252 = -C (mod L),
    C = L - 2^252, on radix-2^28 limbs in int64 columns, then one
    conditional add of L; exact and canonical for any 512-bit x;
  * `nibble_rows`: the 64 little-endian 4-bit ladder digits of bytes.

`h_digits` is the kernel wrapper: CUDA tensors launch `csrc/h_digits.cu`,
CPU tensors take `h_digits_plain`, which runs the kernel's integer steps
(the digits come straight from the reduction's limbs, as in the kernel).
`reduce_mod_l_device` runs the kernel's reduction alone (a test entry).
`h_digits_gather` (kernel K2g, the committee path) is the same hash with
each lane's key read from the committee's key table by validator index.
"""

from __future__ import annotations

import math

import torch

from . import _build

L = 2**252 + 27742317777372353535851937790883648493

# --- round constants (FIPS 180-4: frac of cube/square roots of primes) -----


def _primes(n: int) -> list[int]:
    out, k = [], 2
    while len(out) < n:
        if all(k % p for p in out):
            out.append(k)
        k += 1
    return out


def _icbrt(x: int) -> int:
    r = 1 << ((x.bit_length() + 2) // 3)
    while True:
        nr = (2 * r + x // (r * r)) // 3
        if nr >= r:
            break
        r = nr
    while (r + 1) ** 3 <= x:
        r += 1
    return r


K64 = [_icbrt(p << 192) & (2**64 - 1) for p in _primes(80)]
H0 = [math.isqrt(p << 128) & (2**64 - 1) for p in _primes(8)]


def _signed(v: int) -> int:
    """uint64 constant -> the int64 with the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


# --- 64-bit word ops on int64 tensors ---------------------------------------


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x >> n) & ((1 << (64 - n)) - 1)


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return _shr(x, n) | (x << (64 - n))


def sha512_96(r: torch.Tensor, a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """SHA-512 of the 96-byte messages R||A||M. Inputs (32, B) uint8 rows;
    output (64, B) uint8: the digest bytes in order (byte i has weight
    256^i in RFC 8032's digest-to-scalar convention)."""
    msg = torch.cat([r, a, m]).long()  # (96, B)
    batch = msg.shape[1]

    def const(v: int) -> torch.Tensor:
        return torch.full((batch,), _signed(v), dtype=torch.int64, device=msg.device)

    w = []
    for j in range(16):  # big-endian words of the padded block
        if j < 12:
            word = msg[8 * j] << 56
            for k in range(1, 8):
                word = word | (msg[8 * j + k] << (56 - 8 * k))
            w.append(word)
        elif j == 12:  # 0x80 then zeros
            w.append(const(0x8000000000000000))
        elif j == 15:  # message length in bits
            w.append(const(96 * 8))
        else:
            w.append(const(0))
    for t in range(16, 80):
        s0 = _rotr(w[t - 15], 1) ^ _rotr(w[t - 15], 8) ^ _shr(w[t - 15], 7)
        s1 = _rotr(w[t - 2], 19) ^ _rotr(w[t - 2], 61) ^ _shr(w[t - 2], 6)
        w.append(w[t - 16] + s0 + w[t - 7] + s1)

    state = [const(h) for h in H0]
    a_, b_, c_, d_, e_, f_, g_, h_ = state
    for t in range(80):
        s1 = _rotr(e_, 14) ^ _rotr(e_, 18) ^ _rotr(e_, 41)
        ch = (e_ & f_) ^ (~e_ & g_)
        t1 = h_ + s1 + ch + _signed(K64[t]) + w[t]
        s0 = _rotr(a_, 28) ^ _rotr(a_, 34) ^ _rotr(a_, 39)
        maj = (a_ & b_) ^ (a_ & c_) ^ (b_ & c_)
        t2 = s0 + maj
        h_, g_, f_, e_ = g_, f_, e_, d_ + t1
        d_, c_, b_, a_ = c_, b_, a_, t1 + t2
    digest = [s + v for s, v in zip(state, (a_, b_, c_, d_, e_, f_, g_, h_))]
    rows = [(word >> (56 - 8 * k)) & 0xFF for word in digest for k in range(8)]
    return torch.stack(rows).to(torch.uint8)


# --- h mod L on radix-2^28 limbs (the kernel's reduction, step for step) ----
#
# x < 2^512 is 19 limbs of 28 bits. 2^252 = 2^(9 * 28) is the start of limb
# 9, and 2^252 = -C (mod L) with C = L - 2^252 < 2^125 (5 limbs), so each
# fold x_lo - x_hi * C is limb-aligned:
#   fold 1: 19 limbs -> 14 columns, 10 x 5 products; y in (-2^385, 2^252);
#   fold 2: limbs 9..13 of y (signed top) -> 9 columns, 5 x 5 products;
#           z in [0, 2^252 + 2^258), carried to 10 limbs, z_hi = limb 9 <= 65;
#   fold 3: 5 products z_hi * C; w in (-2^132, 2^252), w_hi = limb 9 in {-1, 0};
#   w < 0: add L, i.e. w_lo + C < L, so the result is canonical.
# Columns are signed int64 sums of int32 products (one IMAD.WIDE each on
# the card); `column_bounds` gives the largest |column| of each fold
# (< 2^58; tests/test_torch_sha512.py pins it below 2^63).

RADIX = 28
MASK28 = (1 << RADIX) - 1
C = L - 2**252
C_LIMBS = tuple((C >> (RADIX * i)) & MASK28 for i in range(5))
# Ranges of the limbs each fold reads (w: what the final add of L reads),
# as the comment above derives them from the value bounds: (low limbs, top
# limb).
LIMB_RANGES = {
    "x": ((0, MASK28), (0, 255)),  # 19 limbs, limb 18 holds bits 504..511
    "y": ((0, MASK28), (-(1 << 21), 0)),  # 14 limbs, floor(y / 2^364)
    "z": ((0, MASK28), (0, 65)),  # 10 limbs, floor(z / 2^252)
    "w": ((0, MASK28), (-1, 0)),  # 10 limbs, floor(w / 2^252)
}


def _le_words(x64: torch.Tensor) -> list[torch.Tensor]:
    """(64, B) uint8 little-endian value -> 8 int64 words, word q holding
    bytes 8q..8q+7 (value = sum of word q * 2^(64 q), words as uint64)."""
    x = x64.long()
    words = []
    for q in range(8):
        w = x[8 * q + 7] << 56
        for k in range(6, -1, -1):
            w = w | (x[8 * q + k] << (8 * k))
        words.append(w)
    return words


def _limbs_of_words(e: list[torch.Tensor]) -> list[torch.Tensor]:
    """8 little-endian 64-bit words -> 19 limbs of 28 bits (limb k = bits
    28k..28k+27; limb 18 = bits 504..511)."""
    limbs = []
    for k in range(19):
        q, off = divmod(RADIX * k, 64)
        v = _shr(e[q], off) if off else e[q]
        if off > 64 - RADIX and q + 1 < 8:
            v = v | (e[q + 1] << (64 - off))
        limbs.append(v & MASK28)
    return limbs


def _carry(cols: list[torch.Tensor]) -> list[torch.Tensor]:
    """Normalise columns: limbs 0..n-2 into [0, 2^28), the top limb takes
    the (signed) rest. Arithmetic shifts, as `>>` on int64 on the card."""
    out = list(cols)
    for k in range(len(out) - 1):
        carry = out[k] >> RADIX
        out[k] = out[k] & MASK28
        out[k + 1] = out[k + 1] + carry
    return out


def _reduce_stages(e: list[torch.Tensor]) -> dict[str, list[torch.Tensor]]:
    """The reduction of the value held by 8 little-endian 64-bit words, fold
    by fold: {"x", "y", "z", "w", "h"} limb lists, `h` the 10 canonical
    limbs of value mod L (limb 9 is bit 252)."""
    x = _limbs_of_words(e)
    zero = torch.zeros_like(x[0])
    y = [x[k] if k < 9 else zero for k in range(14)]
    for i in range(10):
        for j in range(5):
            y[i + j] = y[i + j] - x[9 + i] * C_LIMBS[j]
    y = _carry(y)
    z = y[:9] + [zero]
    for i in range(5):
        for j in range(5):
            z[i + j] = z[i + j] - y[9 + i] * C_LIMBS[j]
    z = _carry(z)
    w = z[:9] + [zero]
    for j in range(5):
        w[j] = w[j] - z[9] * C_LIMBS[j]
    w = _carry(w)
    h = w[:9] + [zero]  # w < 0 (w_hi = -1): w + L = w_lo + C
    for j in range(5):
        h[j] = h[j] + (w[9] & C_LIMBS[j])
    return {"x": x, "y": y, "z": z, "w": w, "h": _carry(h)}


def column_bounds() -> dict[str, int]:
    """Largest |column| of each fold as its carry reads it: the kept low
    limb, the column's products -limb * C_j over the limb ranges of
    LIMB_RANGES, and the carry in from the column below."""

    def fold(src: str, n_hi: int, n_cols: int) -> int:
        low, top = LIMB_RANGES[src]
        ranges = [low] * (n_hi - 1) + [top]
        best = carry = 0
        for k in range(n_cols):
            lo, hi = -carry, (MASK28 if k < 9 else 0) + carry
            for i, (a, b) in enumerate(ranges):
                if 0 <= k - i < 5:
                    lo, hi = lo - b * C_LIMBS[k - i], hi - a * C_LIMBS[k - i]
            best = max(best, -lo, hi)
            carry = (max(-lo, hi) >> RADIX) + 1
        return best

    return {"fold1": fold("x", 10, 14), "fold2": fold("y", 5, 9), "fold3": fold("z", 1, 5)}


def reduce_mod_l(x64: torch.Tensor) -> torch.Tensor:
    """(64, B) uint8 little-endian value < 2^512 -> (32, B) uint8 bytes of
    value mod L, canonical. The kernel's limb steps (`_reduce_stages`)."""
    d = _limb_nibbles(_reduce_stages(_le_words(x64))["h"])
    return d[0::2] | (d[1::2] << 4)


def _limb_nibbles(h: list[torch.Tensor]) -> torch.Tensor:
    """10 canonical limbs -> (64, B) uint8 4-bit digits: 7 per 28-bit limb,
    digit 63 = limb 9 (bit 252)."""
    rows = [(h[k] >> (4 * i)) & 15 for k in range(9) for i in range(7)] + [h[9]]
    return torch.stack(rows).to(torch.uint8)


def reduce_mod_l_device(x64: torch.Tensor) -> torch.Tensor:
    """The kernel's reduction alone (`hs_reduce_mod_l` in
    `csrc/h_digits.cu`, a test entry): CPU tensors -> `reduce_mod_l`; CUDA
    tensors -> the kernel's own `__device__` reduction on the given
    (64, B) uint8 little-endian values (raises if it cannot launch)."""
    if x64.device.type == "cpu":
        return reduce_mod_l(x64)
    batch = x64.shape[1]
    _build.check(x64, (64, batch), torch.uint8, x64.device)
    out = torch.empty((32, batch), dtype=torch.uint8, device=x64.device)
    _build.KERNELS["reduce_mod_l"].launch(x64, out, batch)
    return out


def nibble_rows(b: torch.Tensor) -> torch.Tensor:
    """(32, B) uint8 -> (64, B) uint8 4-bit digits, row 2k = low nibble of
    byte k (row d has significance 16^d) — the ladder's digit layout."""
    return torch.stack((b & 0x0F, b >> 4), dim=1).reshape(2 * b.shape[0], b.shape[1])


def h_digits_plain(r: torch.Tensor, a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(32, B) uint8 x3 -> (64, B) uint8 ladder digits of
    SHA-512(R||A||M) mod L."""
    return _limb_nibbles(_reduce_stages(_le_words(sha512_96(r, a, m)))["h"])


def h_digits(r: torch.Tensor, a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Kernel K2 wrapper: CPU tensors -> `h_digits_plain`; CUDA tensors ->
    `csrc/h_digits.cu` (raises if it cannot launch)."""
    if r.device.type == "cpu":
        return h_digits_plain(r, a, m)
    batch = r.shape[1]
    for t in (r, a, m):
        _build.check(t, (32, batch), torch.uint8, r.device)
    out = torch.empty((64, batch), dtype=torch.uint8, device=r.device)
    _build.KERNELS["h_digits"].launch(r, a, m, out, batch)
    return out


def h_digits_gather_plain(
    r: torch.Tensor, keys_u8: torch.Tensor, idx: torch.Tensor, m: torch.Tensor
) -> torch.Tensor:
    """`h_digits` with A = keys_u8[:, idx] ((32, N) uint8 committee keys,
    (B,) int32 validator indices). A lane whose index is outside [0, N)
    gets all-zero digits (its index is clamped so nothing is read out of
    bounds, then the lane is masked)."""
    n = keys_u8.shape[1]
    in_range = (idx >= 0) & (idx < n)
    a = keys_u8.index_select(1, idx.long().clamp(0, n - 1))
    return torch.where(in_range[None, :], h_digits_plain(r, a, m), 0)


def h_digits_gather(r: torch.Tensor, keys_u8: torch.Tensor, idx: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Kernel K2g wrapper (replaces the `jnp.take(keys_u8, idx, axis=1)`
    gather + `h_digits_on_device` of the committee path): CPU tensors ->
    `h_digits_gather_plain`; CUDA tensors -> `hs_h_digits_idx` in
    `csrc/h_digits.cu`, which reads each lane's key column itself."""
    if r.device.type == "cpu":
        return h_digits_gather_plain(r, keys_u8, idx, m)
    batch, n = r.shape[1], keys_u8.shape[1]
    _build.check(r, (32, batch), torch.uint8, r.device)
    _build.check(m, (32, batch), torch.uint8, r.device)
    _build.check(keys_u8, (32, n), torch.uint8, r.device)
    _build.check(idx, (batch,), torch.int32, r.device)
    out = torch.empty((64, batch), dtype=torch.uint8, device=r.device)
    _build.KERNELS["h_digits_idx"].launch(r, keys_u8, idx, m, out, n, batch)
    return out
