// GF(2^255 - 19) with each field product split over the four warps of a
// block by output column: a chain of field operations (an inversion, a
// square root's power) for 32 elements, one per lane of each warp.
//
// Warp g of the block computes column group g of every product for the 32
// elements of the block: columns {0,1,2}, {3,4,5}, {6,7}, {8,9}. A squaring
// has 6 or 5 limb products per column, so the groups take 17, 16, 11 and 11
// of its 55 products; a multiply 30, 30, 20 and 20 of 100. The group is
// uniform per warp and a template argument, so each group's columns and
// products are constants: no divergence inside a warp and no run-time
// index into a register array. A caller runs `switch (threadIdx.x / 32)`
// once, around its whole body templated on the group.
//
// One op (split_sq / split_mul):
//   1. warp g sums its columns, h_k = lo_k + 19 hi_k (as hs_reduce), and
//      takes one rounding carry out of each: c_k as in hs_carry_step,
//      r_k = h_k - c_k 2^w_k (round 1). It publishes r_k and the carry into
//      limb k+1 (19 c_9 into limb 0), split as q 2^w + s with s in [0, 2^w).
//   2. one __syncthreads (the exchange area is double-buffered, so one
//      barrier per op is enough);
//   3. every warp reads all ten limbs, h'_i = r_i + (carry into i), and
//      takes a second rounding carry over all ten limbs in registers
//      (round 2), ten limbs wide. With r_i + s + 2^(w-1) in [0, 2^(w+1)),
//      round 2 runs in 32-bit integers. Every warp then holds the whole
//      carried element, which feeds the next op.
// ops/field.py `carry_split` / `mul_split` / `sqr_split` / `invert_split`
// run the same integer steps (the CPU tests hold them against `mul` and
// JAX's field mod p).
//
// Bounds. Operands within fe_mul's (|limb| <= 2^27 even, 2^26 odd: two lazy
// adds of carried values) give column sums |h| < 2^61, so |c_k| <= 2^36 and
// |19 c_9| < 2^41; round 2's carries are then at most 2^15 and an output
// limb has |even| <= 2^25 + 2^15, |odd| <= 2^24 + 2^15 (field.py
// SPLIT_BOUND): within fe_mul's operand bound, so the chain stays exact.
// The limbs differ from the ref10 chain's; the value mod p does not.
//
// Tail lanes: every warp must reach every barrier, so a lane past the
// batch computes on a valid lane and only skips its stores.
#pragma once

#include "field.cuh"

#define HS_SPLIT_THREADS 128  // four warps: 32 elements per block

// Column group G: columns K0 .. K0 + N - 1.
template <int G> struct split_group;
template <> struct split_group<0> { static constexpr int K0 = 0, N = 3; };
template <> struct split_group<1> { static constexpr int K0 = 3, N = 3; };
template <> struct split_group<2> { static constexpr int K0 = 6, N = 2; };
template <> struct split_group<3> { static constexpr int K0 = 8, N = 2; };

// The block's exchange area, two buffers, structure of arrays so that a
// warp's 32 lanes read one limb from consecutive words.
struct split_area {
  int32_t r[2][HS_NL][32];  // r_i: limb i after round 1's carry out
  int2 sq[2][HS_NL][32];    // (s, q): the carry into limb i, q 2^w_i + s
};

struct split_xchg {
  split_area& a;
  int lane;  // lane of the warp
  int p;     // the buffer of the next op
  __device__ __forceinline__ explicit split_xchg(split_area& area)
      : a(area), lane(threadIdx.x & 31), p(0) {}
};

// Round 1 of column K (h = its column sum) and its stores.
template <int K>
__device__ __forceinline__ void split_put(split_xchg& x, int64_t h) {
  constexpr int W = hs_width(K);
  constexpr int KN = (K + 1) % HS_NL;
  constexpr int WN = hs_width(KN);
  const int64_t c = (h + ((int64_t)1 << (W - 1))) >> W;
  x.a.r[x.p][K][x.lane] = (int32_t)(h - c * ((int64_t)1 << W));
  const int64_t cin = (K == HS_NL - 1) ? 19 * c : c;
  const int32_t q = (int32_t)(cin >> WN);
  const int32_t s = (int32_t)cin & ((1 << WN) - 1);
  x.a.sq[x.p][KN][x.lane] = make_int2(s, q);
}

// The barrier and round 2; flips the buffer.
__device__ __forceinline__ fe split_get(split_xchg& x) {
  __syncthreads();
  int32_t rem[HS_NL], c2[HS_NL];
#pragma unroll
  for (int i = 0; i < HS_NL; i++) {
    const int w = hs_width(i);
    const int2 sq = x.a.sq[x.p][i][x.lane];
    const int32_t u = x.a.r[x.p][i][x.lane] + sq.x + (1 << (w - 1));
    c2[i] = sq.y + (u >> w);
    rem[i] = (u & ((1 << w) - 1)) - (1 << (w - 1));
  }
  x.p ^= 1;
  fe out;
  out.v[0] = rem[0] + 19 * c2[HS_NL - 1];
#pragma unroll
  for (int i = 1; i < HS_NL; i++) out.v[i] = rem[i] + c2[i - 1];
  return out;
}

// Column sum k of f * g (the terms of fe_mul with i + j = k or k + 10).
template <int K>
__device__ __forceinline__ int64_t split_mul_col(const fe& f, const fe& g) {
  int64_t lo = 0, hi = 0;
#pragma unroll
  for (int i = 0; i < HS_NL; i++) {
    const int j = (K - i + HS_NL) % HS_NL;
    const int32_t fi = ((i & 1) && (j & 1)) ? 2 * f.v[i] : f.v[i];
    const int64_t p = (int64_t)fi * g.v[j];
    if (i + j == K) {
      lo += p;
    } else {
      hi += p;
    }
  }
  return lo + 19 * hi;
}

// Column sum k of f^2 (the terms of fe_sq with i + j = k or k + 10).
template <int K>
__device__ __forceinline__ int64_t split_sq_col(const fe& f) {
  int64_t lo = 0, hi = 0;
#pragma unroll
  for (int i = 0; i < HS_NL; i++) {
    const int j = (K - i + HS_NL) % HS_NL;
    if (j < i) continue;
    const int m = (j == i ? 1 : 2) * (((i & 1) && (j & 1)) ? 2 : 1);
    const int64_t p = (int64_t)(m * f.v[i]) * f.v[j];
    if (i + j == K) {
      lo += p;
    } else {
      hi += p;
    }
  }
  return lo + 19 * hi;
}

// Group G's columns of one product, published.
template <int G, bool SQ>
__device__ __forceinline__ void split_cols(split_xchg& x, const fe& f, const fe& g) {
  constexpr int K0 = split_group<G>::K0, N = split_group<G>::N;
  const int64_t h0 = SQ ? split_sq_col<K0>(f) : split_mul_col<K0>(f, g);
  const int64_t h1 = SQ ? split_sq_col<K0 + 1>(f) : split_mul_col<K0 + 1>(f, g);
  split_put<K0>(x, h0);
  split_put<K0 + 1>(x, h1);
  if constexpr (N == 3) {
    const int64_t h2 = SQ ? split_sq_col<K0 + 2>(f) : split_mul_col<K0 + 2>(f, g);
    split_put<K0 + 2>(x, h2);
  }
}

template <int G>
__device__ __forceinline__ fe split_mul(split_xchg& x, const fe& f, const fe& g) {
  split_cols<G, false>(x, f, g);
  return split_get(x);
}

template <int G>
__device__ __forceinline__ fe split_sq(split_xchg& x, const fe& f) {
  split_cols<G, true>(x, f, f);
  return split_get(x);
}

template <int G>
__device__ __forceinline__ fe split_sq_n(split_xchg& x, fe a, int n) {
#pragma unroll 1
  for (int k = 0; k < n; k++) a = split_sq<G>(x, a);
  return a;
}

// ops/field.py `_chain_250` on the split ops: z^(2^250 - 1) and z^11, the
// shared prefix of the inversion and of the square root's z^((p-5)/8).
template <int G>
__device__ __forceinline__ void split_chain_250(split_xchg& x, const fe& z, fe& z_250_0, fe& z11) {
  const fe z2 = split_sq<G>(x, z);
  const fe z8 = split_sq_n<G>(x, z2, 2);
  const fe z9 = split_mul<G>(x, z, z8);
  z11 = split_mul<G>(x, z2, z9);
  const fe z22 = split_sq<G>(x, z11);
  const fe z_5_0 = split_mul<G>(x, z9, z22);
  const fe z_10_0 = split_mul<G>(x, split_sq_n<G>(x, z_5_0, 5), z_5_0);
  const fe z_20_0 = split_mul<G>(x, split_sq_n<G>(x, z_10_0, 10), z_10_0);
  const fe z_40_0 = split_mul<G>(x, split_sq_n<G>(x, z_20_0, 20), z_20_0);
  const fe z_50_0 = split_mul<G>(x, split_sq_n<G>(x, z_40_0, 10), z_10_0);
  const fe z_100_0 = split_mul<G>(x, split_sq_n<G>(x, z_50_0, 50), z_50_0);
  const fe z_200_0 = split_mul<G>(x, split_sq_n<G>(x, z_100_0, 100), z_100_0);
  z_250_0 = split_mul<G>(x, split_sq_n<G>(x, z_200_0, 50), z_50_0);
}

template <int G>
__device__ __forceinline__ fe split_invert(split_xchg& x, const fe& z) {
  fe z_250_0, z11;
  split_chain_250<G>(x, z, z_250_0, z11);
  return split_mul<G>(x, split_sq_n<G>(x, z_250_0, 5), z11);
}

// z^((p-5)/8) = z^(2^252 - 3): the square root's power (K3; field.py
// `pow2523_split`).
template <int G>
__device__ __forceinline__ fe split_pow2523(split_xchg& x, const fe& z) {
  fe z_250_0, z11;
  split_chain_250<G>(x, z, z_250_0, z11);
  return split_mul<G>(x, split_sq_n<G>(x, z_250_0, 2), z);
}
