// Kernel K6: BLS12-381 G1 committee-key sums, one per certificate bitmap
// row, and `hs_bls_mont_mul`, a test entry that runs K6's field product
// alone.
//
// K6 replaces hotstuff_tpu/ops/bls.py:masked_tree_aggregate (:297) with the
// eff = mask & present of CommitteeTable.aggregate_masks (:405), and the
// jnp field and point functions it runs: mont_mul (:180), point_dbl (:238)
// and point_add (:253), on 32 x 12-bit uint32 digits there.
//
// Arithmetic (ops/bls.py runs the same steps on int64 tensors; the two
// agree limb for limb, as chip_smoke.py checks):
//   * Fp in 12 x 32-bit limbs, Montgomery form with R = 2^384 (the
//     reference's R), every residue fully reduced to [0, p), so zero is the
//     all-zero digit string and each value has one;
//   * Montgomery product by CIOS over 32-bit digits: 12 x 12 products of
//     a x b, 12 digit factors m = t0 * (-p^-1 mod 2^32) and 12 x 12
//     products of m x p, each a 32 x 32 -> 64-bit multiply-add (one
//     IMAD.WIDE) into a 64-bit accumulator: 300 products; with a, b < 2p
//     the result is < 2p and one conditional subtraction of p ends it;
//   * Jacobian points, the identity (mont(1), mont(1), 0). The fold adds
//     an affine table point to a partial sum (madd-2007-bl, Z2 = 1,
//     7M + 4S); the tree adds two partials (add-2007-bl); doubling is
//     dbl-2009-l (a = 0). The special cases are branches: a partial that
//     is the identity takes the other operand, H = 0 doubles (same point)
//     or gives the identity (the inverse pair), in the order of the
//     reference's selects.
//
// Layout: one block of K6_THREADS threads per mask row. Thread t folds the
// row's lanes t, t + K6_THREADS, ... (lanes >= N are never read, so
// K6_THREADS need not divide N) into its partial sum; the K6_THREADS
// partials then reduce in a halving tree through shared memory (partial t
// += partial t + s, s = 16, 8, 4, 2, 1) and thread 0's sum goes out as
// (3, 12, B) int32 limbs. The table (12, N) x 2 is read by lane index, so
// neighbouring threads read neighbouring words.
//
// Bound: integer operations. A member after a row's first costs one mixed
// add, 11 products of 300 IMAD.WIDE each (chip_smoke.py BLS_OPS_PER_MEMBER);
// a row of a 256-member committee's quorum reads 7.3 KB of table. The
// design does nothing about it yet: one thread per partial runs its whole
// chain of dependent products, and the row's 32 threads share one warp's
// issue slot. Filling the SMs (several rows a block, partials split over
// threads, products across the warp) is a later redesign's work.
#include <cuda_runtime.h>

#include <cstdint>

constexpr int K6_THREADS = 32;  // partial sums per row: ops/bls.py THREADS

namespace {

constexpr int NL = 12;

// p and mont(1) = 2^384 mod p in 32-bit limbs (ops/bls.py _P_DIGITS, MONT_ONE).
__device__ __forceinline__ constexpr uint32_t p_limb(int j) {
  return j == 0 ? 0xffffaaabu : j == 1 ? 0xb9feffffu : j == 2 ? 0xb153ffffu : j == 3 ? 0x1eabfffeu
       : j == 4 ? 0xf6b0f624u : j == 5 ? 0x6730d2a0u : j == 6 ? 0xf38512bfu : j == 7 ? 0x64774b84u
       : j == 8 ? 0x434bacd7u : j == 9 ? 0x4b1ba7b6u : j == 10 ? 0x397fe69au : 0x1a0111eau;
}

__device__ __forceinline__ constexpr uint32_t one_limb(int j) {
  return j == 0 ? 0x0002fffdu : j == 1 ? 0x76090000u : j == 2 ? 0xc40c0002u : j == 3 ? 0xebf4000bu
       : j == 4 ? 0x53c758bau : j == 5 ? 0x5f489857u : j == 6 ? 0x70525745u : j == 7 ? 0x77ce5853u
       : j == 8 ? 0xa256ec6du : j == 9 ? 0x5c071a97u : j == 10 ? 0xfa80e493u : 0x15f65ec3u;
}

constexpr uint32_t PINV = 0xfffcfffdu;  // -p^-1 mod 2^32 (ops/bls.py PINV32)

struct Fe {
  uint32_t v[NL];
};

struct Point {
  Fe x, y, z;
};

// r = t - p when t (13 limbs, t[12] the top word) >= p, else t.
__device__ __forceinline__ void reduce_once(Fe& r, const uint32_t (&t)[NL + 1]) {
  uint32_t d[NL];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NL; j++) {
    uint64_t w = (uint64_t)t[j] - p_limb(j) - borrow;
    d[j] = (uint32_t)w;
    borrow = w >> 63;
  }
  const bool ge = t[NL] != 0 || borrow == 0;
#pragma unroll
  for (int j = 0; j < NL; j++) r.v[j] = ge ? d[j] : t[j];
}

// Montgomery product a b / R mod p in [0, p), a and b in [0, 2p) (CIOS).
__device__ __forceinline__ void mont_mul(Fe& r, const Fe& a, const Fe& b) {
  uint32_t t[NL + 2];
#pragma unroll
  for (int j = 0; j < NL + 2; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; j++) {
      c += (uint64_t)a.v[j] * b.v[i] + t[j];  // < 2^64: (2^32 - 1)^2 + 2 (2^32 - 1)
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NL];
    t[NL] = (uint32_t)c;
    t[NL + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * PINV;
    c = ((uint64_t)m * p_limb(0) + t[0]) >> 32;  // the low word is 0 by m's choice
#pragma unroll
    for (int j = 1; j < NL; j++) {
      c += (uint64_t)m * p_limb(j) + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NL];
    t[NL - 1] = (uint32_t)c;
    t[NL] = t[NL + 1] + (uint32_t)(c >> 32);
  }
  uint32_t u[NL + 1];
#pragma unroll
  for (int j = 0; j <= NL; j++) u[j] = t[j];
  reduce_once(r, u);
}

__device__ __forceinline__ void mont_sqr(Fe& r, const Fe& a) { mont_mul(r, a, a); }

// a + b mod p, a and b in [0, p): the sum is < 2p < 2^384.
__device__ __forceinline__ void add_mod(Fe& r, const Fe& a, const Fe& b) {
  uint32_t t[NL + 1];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NL; j++) {
    c += (uint64_t)a.v[j] + b.v[j];
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  t[NL] = (uint32_t)c;
  reduce_once(r, t);
}

// a - b mod p, a and b in [0, p): p is added back where a < b.
__device__ __forceinline__ void sub_mod(Fe& r, const Fe& a, const Fe& b) {
  uint32_t d[NL];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NL; j++) {
    uint64_t w = (uint64_t)a.v[j] - b.v[j] - borrow;
    d[j] = (uint32_t)w;
    borrow = w >> 63;
  }
  const uint32_t keep = borrow ? 0xffffffffu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NL; j++) {
    c += (uint64_t)d[j] + (p_limb(j) & keep);
    r.v[j] = (uint32_t)c;
    c >>= 32;
  }
}

__device__ __forceinline__ void dbl_mod(Fe& r, const Fe& a) { add_mod(r, a, a); }

__device__ __forceinline__ bool is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < NL; j++) acc |= a.v[j];
  return acc == 0;
}

__device__ __forceinline__ void set_identity(Point& p) {
#pragma unroll
  for (int j = 0; j < NL; j++) {
    p.x.v[j] = one_limb(j);
    p.y.v[j] = one_limb(j);
    p.z.v[j] = 0;
  }
}

// p = 2p (dbl-2009-l, a = 0; ops/bls.py point_dbl). Y = 0 gives Z = 0.
__device__ void point_dbl(Point& p) {
  Fe A, B, C, D, E, t;
  mont_mul(t, p.y, p.z);
  dbl_mod(p.z, t);  // Z3 = 2 Y Z
  mont_sqr(A, p.x);
  mont_sqr(B, p.y);
  mont_sqr(C, B);
  add_mod(t, p.x, B);
  mont_sqr(D, t);
  sub_mod(D, D, A);
  sub_mod(D, D, C);
  dbl_mod(D, D);  // D = 2 ((X + B)^2 - A - C)
  dbl_mod(E, A);
  add_mod(E, E, A);  // E = 3 A
  mont_sqr(t, E);
  sub_mod(t, t, D);
  sub_mod(p.x, t, D);  // X3 = E^2 - 2 D
  sub_mod(t, D, p.x);
  mont_mul(t, E, t);
  dbl_mod(C, C);
  dbl_mod(C, C);
  dbl_mod(C, C);
  sub_mod(p.y, t, C);  // Y3 = E (D - X3) - 8 C
}

// acc += (x2, y2), an affine point that is not the identity
// (madd-2007-bl; ops/bls.py point_madd).
__device__ void point_madd(Point& acc, const Fe& x2, const Fe& y2) {
  if (is_zero(acc.z)) {
    acc.x = x2;
    acc.y = y2;
#pragma unroll
    for (int j = 0; j < NL; j++) acc.z.v[j] = one_limb(j);
    return;
  }
  Fe Z1Z1, H, Sd, HH, I, J, V, t;
  mont_sqr(Z1Z1, acc.z);
  mont_mul(H, x2, Z1Z1);
  sub_mod(H, H, acc.x);  // H = U2 - X1
  mont_mul(t, acc.z, Z1Z1);
  mont_mul(Sd, y2, t);
  sub_mod(Sd, Sd, acc.y);  // S2 - Y1
  if (is_zero(H)) {
    if (is_zero(Sd)) {
      point_dbl(acc);
    } else {
      set_identity(acc);
    }
    return;
  }
  mont_sqr(HH, H);
  dbl_mod(I, HH);
  dbl_mod(I, I);  // I = 4 HH
  mont_mul(J, H, I);
  dbl_mod(Sd, Sd);  // r = 2 (S2 - Y1)
  mont_mul(V, acc.x, I);
  add_mod(t, acc.z, H);
  mont_sqr(t, t);
  sub_mod(t, t, Z1Z1);
  sub_mod(acc.z, t, HH);  // Z3 = (Z1 + H)^2 - Z1Z1 - HH
  mont_mul(t, acc.y, J);
  dbl_mod(I, t);  // 2 Y1 J
  mont_sqr(t, Sd);
  sub_mod(t, t, J);
  dbl_mod(HH, V);
  sub_mod(acc.x, t, HH);  // X3 = r^2 - J - 2 V
  sub_mod(t, V, acc.x);
  mont_mul(t, Sd, t);
  sub_mod(acc.y, t, I);  // Y3 = r (V - X3) - 2 Y1 J
}

// acc += q, both Jacobian (add-2007-bl; ops/bls.py point_add).
__device__ void point_add(Point& acc, const Point& q) {
  if (is_zero(q.z)) return;
  if (is_zero(acc.z)) {
    acc = q;
    return;
  }
  Fe Z1Z1, Z2Z2, U1, S1, H, Sd, t;
  mont_sqr(Z1Z1, acc.z);
  mont_sqr(Z2Z2, q.z);
  mont_mul(U1, acc.x, Z2Z2);
  mont_mul(H, q.x, Z1Z1);
  sub_mod(H, H, U1);  // H = U2 - U1
  mont_mul(t, acc.y, q.z);
  mont_mul(S1, t, Z2Z2);
  mont_mul(t, q.y, acc.z);
  mont_mul(Sd, t, Z1Z1);
  sub_mod(Sd, Sd, S1);  // S2 - S1
  if (is_zero(H)) {
    if (is_zero(Sd)) {
      point_dbl(acc);
    } else {
      set_identity(acc);
    }
    return;
  }
  Fe I, J, V;
  mont_mul(t, acc.z, q.z);
  mont_mul(t, t, H);
  dbl_mod(acc.z, t);  // Z3 = 2 Z1 Z2 H
  dbl_mod(t, H);
  mont_sqr(I, t);  // I = (2 H)^2
  mont_mul(J, H, I);
  mont_mul(V, U1, I);
  dbl_mod(Sd, Sd);  // Rr = 2 (S2 - S1)
  mont_sqr(t, Sd);
  sub_mod(t, t, J);
  dbl_mod(I, V);
  sub_mod(acc.x, t, I);  // X3 = Rr^2 - J - 2 V
  mont_mul(t, S1, J);
  dbl_mod(I, t);  // 2 S1 J
  sub_mod(t, V, acc.x);
  mont_mul(t, Sd, t);
  sub_mod(acc.y, t, I);  // Y3 = Rr (V - X3) - 2 S1 J
}

__device__ __forceinline__ void load_fe(Fe& r, const uint32_t* col, int stride) {
#pragma unroll
  for (int j = 0; j < NL; j++) r.v[j] = col[j * stride];
}

// tx, ty: (12, n) limbs; present: (n,) bool; mask: (batch, n) bool;
// out: (3, 12, batch) limbs of each row's Jacobian sum.
__global__ void __launch_bounds__(K6_THREADS)
    g1_aggregate_kernel(const uint32_t* __restrict__ tx, const uint32_t* __restrict__ ty,
                        const uint8_t* __restrict__ present, const uint8_t* __restrict__ mask,
                        uint32_t* __restrict__ out, int n, int batch) {
  __shared__ uint32_t part[K6_THREADS][3 * NL + 1];
  const int row = blockIdx.x;
  const int t = threadIdx.x;
  const uint8_t* bits = mask + (size_t)row * n;

  Point acc;
  set_identity(acc);
  for (int k = t; k < n; k += K6_THREADS) {
    if (bits[k] && present[k]) {
      Fe x2, y2;
      load_fe(x2, tx + k, n);
      load_fe(y2, ty + k, n);
      point_madd(acc, x2, y2);
    }
  }

  uint32_t* mine = part[t];
#pragma unroll
  for (int j = 0; j < NL; j++) {
    mine[j] = acc.x.v[j];
    mine[NL + j] = acc.y.v[j];
    mine[2 * NL + j] = acc.z.v[j];
  }
  __syncthreads();
  for (int s = K6_THREADS / 2; s > 0; s >>= 1) {
    if (t < s) {
      const uint32_t* other = part[t + s];
      Point q;
#pragma unroll
      for (int j = 0; j < NL; j++) {
        q.x.v[j] = other[j];
        q.y.v[j] = other[NL + j];
        q.z.v[j] = other[2 * NL + j];
      }
      point_add(acc, q);
#pragma unroll
      for (int j = 0; j < NL; j++) {
        mine[j] = acc.x.v[j];
        mine[NL + j] = acc.y.v[j];
        mine[2 * NL + j] = acc.z.v[j];
      }
    }
    __syncthreads();
  }
  for (int w = t; w < 3 * NL; w += K6_THREADS) out[(size_t)w * batch + row] = part[0][w];
}

// out = a b / R mod p per column; a, b, out: (12, batch) limbs, a and b < 2p.
__global__ void mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, int batch) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch) return;
  Fe x, y, r;
  load_fe(x, a + i, batch);
  load_fe(y, b + i, batch);
  mont_mul(r, x, y);
#pragma unroll
  for (int j = 0; j < NL; j++) out[j * batch + i] = r.v[j];
}

}  // namespace

extern "C" int hs_g1_aggregate(const void* tx, const void* ty, const void* present, const void* mask,
                               void* out, int n, int batch, void* stream) {
  g1_aggregate_kernel<<<batch, K6_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)tx, (const uint32_t*)ty, (const uint8_t*)present, (const uint8_t*)mask,
      (uint32_t*)out, n, batch);
  return (int)cudaGetLastError();
}

extern "C" int hs_bls_mont_mul(const void* a, const void* b, void* out, int batch, void* stream) {
  mont_mul_kernel<<<(batch + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, batch);
  return (int)cudaGetLastError();
}
