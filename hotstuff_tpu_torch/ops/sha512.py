"""Batched h = SHA-512(R || A || M) mod L on the card — kernel K2.

Counterpart of `hotstuff_tpu/ops/sha512.py:h_digits_on_device`. The
protocol signs 32-byte digests, so R || A || M is a fixed 96-byte message:
one padded SHA-512 block. The JAX package emulates 64-bit words as (hi, lo)
uint32 pairs and reduces mod L with f32 limb folds; the port has native
64-bit integers:

  * `sha512_96`: 80 rounds on int64 words (two's complement wraps like
    uint64; right shifts are masked to act as logical shifts);
  * `reduce_mod_l`: TweetNaCl's `modL` on 64 signed byte limbs — folds the
    top bytes down with 2^256 = -16C (mod L), C = L - 2^252, then one
    estimate-and-subtract at the 2^252 boundary; exact for any 512-bit x;
  * `nibble_rows`: the 64 little-endian 4-bit ladder digits.

`h_digits` is the kernel wrapper: CUDA tensors launch `csrc/h_digits.cu`,
CPU tensors take `h_digits_plain`, which runs the same integer steps.
`h_digits_gather` (kernel K2g, the committee path) is the same hash with
each lane's key read from the committee's key table by validator index.
"""

from __future__ import annotations

import math

import torch

from . import _build

L = 2**252 + 27742317777372353535851937790883648493
L_BYTES = tuple(L.to_bytes(32, "little"))

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


def reduce_mod_l(x64: torch.Tensor) -> torch.Tensor:
    """(64, B) uint8 little-endian value < 2^512 -> (32, B) uint8 bytes of
    value mod L, canonical (TweetNaCl `modL`, the algorithm of the kernel)."""
    x = list(x64.long().unbind(0))
    for i in range(63, 31, -1):
        carry = torch.zeros_like(x[0])
        for j in range(i - 32, i - 12):
            x[j] = x[j] + carry - 16 * x[i] * L_BYTES[j - (i - 32)]
            carry = (x[j] + 128) >> 8
            x[j] = x[j] - (carry << 8)
        x[i - 12] = x[i - 12] + carry
        x[i] = torch.zeros_like(x[i])
    carry = torch.zeros_like(x[0])
    for j in range(32):
        x[j] = x[j] + carry - (x[31] >> 4) * L_BYTES[j]
        carry = x[j] >> 8
        x[j] = x[j] & 255
    for j in range(32):
        x[j] = x[j] - carry * L_BYTES[j]
    out = []
    for i in range(32):
        x[i + 1] = x[i + 1] + (x[i] >> 8)
        out.append(x[i] & 255)
    return torch.stack(out).to(torch.uint8)


def nibble_rows(b: torch.Tensor) -> torch.Tensor:
    """(32, B) uint8 -> (64, B) uint8 4-bit digits, row 2k = low nibble of
    byte k (row d has significance 16^d) — the ladder's digit layout."""
    return torch.stack((b & 0x0F, b >> 4), dim=1).reshape(2 * b.shape[0], b.shape[1])


def h_digits_plain(r: torch.Tensor, a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(32, B) uint8 x3 -> (64, B) uint8 ladder digits of
    SHA-512(R||A||M) mod L."""
    return nibble_rows(reduce_mod_l(sha512_96(r, a, m)))


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
