// GF(2^255 - 19) on integer limbs, one element per thread.
//
// Replaces the TPU field of hotstuff_tpu/ops/field.py (32 radix-256 f32
// limbs, chosen there because TPU int32 multiplies lower to multi-op
// sequences). Hopper has a native 32x32->64 multiply (IMAD.WIDE), so an
// element is the ref10 / ed25519-dalek u32 layout: 10 signed int32 limbs
// of alternating 26 and 25 bits (radix 2^25.5).
//
// Every function here runs the same integer steps, in the same order, as
// the plain PyTorch version in ops/field.py, so a kernel and its plain
// version agree limb for limb. Bounds (see field.py): mul/sq outputs have
// |limb| <= 2^25 (even) / ~2^24 (odd); lazy add/sub of at most two such
// values feed a mul, whose 10-term sums with x2/x19 factors stay < 2^61.
//
// What bounds a field-heavy kernel on this card is the integer multiply
// rate: a mul is 100 IMAD.WIDE products (a square 55) plus ~40 carry ops.
#pragma once

#include <cstdint>

#define HS_NL 10

struct fe {
  int32_t v[HS_NL];
};

__host__ __device__ constexpr int hs_width(int i) { return (i & 1) ? 25 : 26; }
__host__ __device__ constexpr int hs_offset(int i) { return 26 * ((i + 1) / 2) + 25 * (i / 2); }

__device__ __forceinline__ fe fe_const(int32_t a0, int32_t a1, int32_t a2, int32_t a3,
                                       int32_t a4, int32_t a5, int32_t a6, int32_t a7,
                                       int32_t a8, int32_t a9) {
  fe r = {{a0, a1, a2, a3, a4, a5, a6, a7, a8, a9}};
  return r;
}

__device__ __forceinline__ fe fe_zero() { return fe_const(0, 0, 0, 0, 0, 0, 0, 0, 0, 0); }
__device__ __forceinline__ fe fe_one() { return fe_const(1, 0, 0, 0, 0, 0, 0, 0, 0, 0); }
__device__ __forceinline__ fe fe_d() {
  return fe_const(56195235, 13857412, 51736253, 6949390, 114729, 24766616, 60832955,
                  30306712, 48412415, 21499315);
}
__device__ __forceinline__ fe fe_d2() {
  return fe_const(45281625, 27714825, 36363642, 13898781, 229458, 15978800, 54557047,
                  27058993, 29715967, 9444199);
}
__device__ __forceinline__ fe fe_sqrtm1() {
  return fe_const(34513072, 25610706, 9377949, 3500415, 12389472, 33281959, 41962654,
                  31548777, 326685, 11406482);
}

__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < HS_NL; i++) r.v[i] = a.v[i] + b.v[i];
  return r;
}

__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < HS_NL; i++) r.v[i] = a.v[i] - b.v[i];
  return r;
}

// One rounding carry out of limb I (the top limb folds into limb 0 as x19).
template <int I>
__device__ __forceinline__ void hs_carry_step(int64_t* h) {
  constexpr int W = hs_width(I);
  const int64_t c = (h[I] + ((int64_t)1 << (W - 1))) >> W;
  h[I] -= c * ((int64_t)1 << W);
  if constexpr (I == HS_NL - 1) {
    h[0] += c * 19;
  } else {
    h[I + 1] += c;
  }
}

// The ref10 carry chain, in place.
__device__ __forceinline__ void hs_carry(int64_t* h) {
  hs_carry_step<0>(h);
  hs_carry_step<4>(h);
  hs_carry_step<1>(h);
  hs_carry_step<5>(h);
  hs_carry_step<2>(h);
  hs_carry_step<6>(h);
  hs_carry_step<3>(h);
  hs_carry_step<7>(h);
  hs_carry_step<4>(h);
  hs_carry_step<8>(h);
  hs_carry_step<9>(h);
  hs_carry_step<0>(h);
}

__device__ __forceinline__ fe hs_narrow(const int64_t* h) {
  fe r;
#pragma unroll
  for (int i = 0; i < HS_NL; i++) r.v[i] = (int32_t)h[i];
  return r;
}

// Sums lo[k] (i + j = k) and hi[k] (i + j = k + 10, weight 2^255 = 19),
// then carries.
__device__ __forceinline__ fe hs_reduce(const int64_t* lo, const int64_t* hi) {
  int64_t h[HS_NL];
#pragma unroll
  for (int k = 0; k < HS_NL; k++) h[k] = lo[k] + 19 * hi[k];
  hs_carry(h);
  return hs_narrow(h);
}

__device__ __forceinline__ fe fe_mul(const fe& f, const fe& g) {
  int64_t lo[HS_NL], hi[HS_NL];
#pragma unroll
  for (int k = 0; k < HS_NL; k++) lo[k] = hi[k] = 0;
#pragma unroll
  for (int i = 0; i < HS_NL; i++) {
    const int32_t fi = f.v[i];
    const int32_t fi2 = (i & 1) ? 2 * fi : fi;  // odd x odd limbs carry a spare bit
#pragma unroll
    for (int j = 0; j < HS_NL; j++) {
      const int64_t p = (int64_t)(((i & 1) && (j & 1)) ? fi2 : fi) * g.v[j];
      if (i + j < HS_NL) {
        lo[i + j] += p;
      } else {
        hi[i + j - HS_NL] += p;
      }
    }
  }
  return hs_reduce(lo, hi);
}

// Squaring: the symmetric half of fe_mul's products (55 of 100), same sum.
__device__ __forceinline__ fe fe_sq(const fe& f) {
  int64_t lo[HS_NL], hi[HS_NL];
#pragma unroll
  for (int k = 0; k < HS_NL; k++) lo[k] = hi[k] = 0;
#pragma unroll
  for (int i = 0; i < HS_NL; i++) {
    const int32_t fi = f.v[i];
#pragma unroll
    for (int j = i; j < HS_NL; j++) {
      const int m = (j == i ? 1 : 2) * (((i & 1) && (j & 1)) ? 2 : 1);
      const int64_t p = (int64_t)(m * fi) * f.v[j];
      if (i + j < HS_NL) {
        lo[i + j] += p;
      } else {
        hi[i + j - HS_NL] += p;
      }
    }
  }
  return hs_reduce(lo, hi);
}

// Per-lane select: c ? a : b.
__device__ __forceinline__ fe fe_select(bool c, const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < HS_NL; i++) r.v[i] = c ? a.v[i] : b.v[i];
  return r;
}

// THE representative mod p (limbs in [0, 2^width)): carry, then ref10's
// fe_tobytes reduction (ops/field.py canonical).
__device__ __forceinline__ fe fe_canonical(const fe& x) {
  int64_t h[HS_NL];
#pragma unroll
  for (int i = 0; i < HS_NL; i++) h[i] = x.v[i];
  hs_carry(h);
  int64_t q = (19 * h[HS_NL - 1] + ((int64_t)1 << 24)) >> 25;
#pragma unroll
  for (int i = 0; i < HS_NL; i++) q = (h[i] + q) >> hs_width(i);
  h[0] += 19 * q;
#pragma unroll
  for (int i = 0; i < HS_NL; i++) {
    const int64_t c = h[i] >> hs_width(i);
    h[i] -= c * ((int64_t)1 << hs_width(i));
    if (i + 1 < HS_NL) h[i + 1] += c;
  }
  return hs_narrow(h);
}

__device__ __forceinline__ bool fe_eq(const fe& a, const fe& b) {
  bool r = true;
#pragma unroll
  for (int i = 0; i < HS_NL; i++) r = r && (a.v[i] == b.v[i]);
  return r;
}

// Low bit of a canonical element (the sign of x).
__device__ __forceinline__ int fe_parity(const fe& c) { return c.v[0] & 1; }

// 32 little-endian bytes -> limbs of the low 255 bits (ops/field.py from_bytes).
__device__ __forceinline__ fe fe_frombytes(const uint8_t* b) {
  fe r;
#pragma unroll
  for (int i = 0; i < HS_NL; i++) {
    const int o = hs_offset(i), w = hs_width(i);
    int64_t acc = 0;
#pragma unroll
    for (int j = o / 8; j <= (o + w - 1) / 8; j++) {
      const int s = 8 * j - o;
      acc |= s >= 0 ? ((int64_t)b[j] << s) : ((int64_t)b[j] >> -s);
    }
    r.v[i] = (int32_t)(acc & (((int64_t)1 << w) - 1));
  }
  return r;
}

// Canonical limbs -> 32 little-endian bytes (ops/field.py to_bytes).
__device__ __forceinline__ void fe_tobytes(const fe& c, uint8_t* out) {
#pragma unroll
  for (int k = 0; k < 32; k++) {
    int64_t acc = 0;
#pragma unroll
    for (int i = 0; i < HS_NL; i++) {
      const int o = hs_offset(i), w = hs_width(i);
      if (o + w <= 8 * k || o >= 8 * k + 8) continue;
      const int s = o - 8 * k;
      acc |= s >= 0 ? ((int64_t)c.v[i] << s) : ((int64_t)c.v[i] >> -s);
    }
    out[k] = (uint8_t)(acc & 0xFF);
  }
}

// Strided loads/stores of one element: limb i at p[i * stride] (the
// lane-fastest (10, B) layout of the kernels' tensors).
__device__ __forceinline__ fe load_fe(const int32_t* p, int stride) {
  fe r;
#pragma unroll
  for (int i = 0; i < HS_NL; i++) r.v[i] = p[i * stride];
  return r;
}

__device__ __forceinline__ void store_fe(int32_t* p, int stride, const fe& a) {
#pragma unroll
  for (int i = 0; i < HS_NL; i++) p[i * stride] = a.v[i];
}

// One element stored contiguously (10 int32, `p` 8-byte aligned), read as
// five 8-byte loads through the read-only data path.
__device__ __forceinline__ fe load_fe_ro(const int32_t* p) {
  const int2* q = reinterpret_cast<const int2*>(p);
  fe r;
#pragma unroll
  for (int i = 0; i < HS_NL / 2; i++) {
    const int2 t = __ldg(q + i);
    r.v[2 * i] = t.x;
    r.v[2 * i + 1] = t.y;
  }
  return r;
}
