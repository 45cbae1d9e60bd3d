// Kernel K6: BLS12-381 G1 committee-key sums, one per certificate bitmap
// row, in two entries over one kernel body, and `hs_bls_mont_mul`, a test
// entry that runs K6's field product alone.
//
//   hs_g1_aggregate         the fold alone: (3, 12, B) Montgomery Jacobian
//                           limbs of each row's sum. Replaces
//                           hotstuff_tpu/ops/bls.py:masked_tree_aggregate
//                           (:297) with the eff = mask & present of
//                           CommitteeTable.aggregate_masks (:405), and the
//                           jnp field and point functions it runs: mont_mul
//                           (:180), point_dbl (:238), point_add (:253).
//   hs_g1_aggregate_affine  the fold, then each row's affine conversion in
//                           the same launch: (2, 12, B) canonical limbs of
//                           x and y (not Montgomery) and a (B,) byte, 1
//                           where the sum is the identity (its limbs are
//                           then 0). Replaces aggregate_masks' host
//                           conversion too (:389-419).
//
// Arithmetic (ops/bls.py runs the same steps on int64 tensors; the two
// agree limb for limb, as chip_smoke.py checks):
//   * Fp in 12 x 32-bit limbs, Montgomery form with R = 2^384 (the
//     reference's R), every residue fully reduced to [0, p), so zero is the
//     all-zero digit string and each value has one;
//   * the Montgomery product interleaves the operand and the reduction a
//     digit of b at a time (12 digit factors m = t0 * (-p^-1 mod 2^32)),
//     and keeps the sum in two accumulators: `even` takes the products of
//     the even limbs (a_j b_i for even j, lo word at j, hi at j + 1),
//     `odd` those of the odd limbs, one word up. Each accumulator is one
//     carry chain of mad.lo.cc / madc.hi.cc (`carry.cuh`); the two share no
//     registers, but the card runs them one after the other (see Bound).
//     After a digit the two swap roles, which divides by 2^32 without
//     moving a word.
//     p < 2^381 leaves the top word room for every carry the chains drop
//     (the sum stays below 2^416, `odd` below 2^384). With a, b < 2p the
//     result is < 2p and one conditional subtraction of p ends it;
//   * Jacobian points, the identity (mont(1), mont(1), 0). The fold adds
//     an affine table point to a partial sum (madd-2007-bl, Z2 = 1,
//     7M + 4S); the tree adds two partials (add-2007-bl); doubling is
//     dbl-2009-l (a = 0). The special cases are branches: a partial that
//     is the identity takes the other operand, H = 0 doubles (same point)
//     or gives the identity (the inverse pair), in the order of the
//     reference's selects. Every step computes the reference's formula;
//     the steps are ordered so that few temporaries are live at once;
//   * the affine conversion raises Z to p - 2 by a fixed 5-bit sliding
//     window (INV_WINDOWS, ops/bls.py INV_WINDOWS): the odd powers z, z^3,
//     ..., z^31 (1 squaring, 15 products), then 377 squarings and 67
//     products; then zi^2, zi^3, x zi^2, y zi^3 and a product by 1 each to
//     leave Montgomery form: 466 products a row. Z = 0 gives zi = 0, so
//     x = y = 0.
//
// Layout: K6_ROWS rows a block, one warp a row. Lane t of a row folds the
// row's lanes t, t + K6_THREADS, ... (lanes >= N are never read, so
// K6_THREADS need not divide N) into its partial sum, reading the table
// point through __ldg where its two products use it; the K6_THREADS
// partials then reduce in a halving tree through the warp's slice of
// shared memory (partial t += partial t + s, s = 16, 8, 4, 2, 1, the other
// operand read from shared memory where it is used). The affine entry
// then hands each row's sum to lane r of warp 0, which runs row r's
// inversion with its odd powers in shared memory (the window digits are
// the same for every row, so the lanes read neighbouring words): a
// block's K6_ROWS chains run on one warp's issue slot.
//
// Bound: integer operations. A member after a row's first costs one mixed
// add, 7 products and 4 squarings (chip_smoke.py BLS_OPS_PER_MEMBER); a row
// of a 256-member committee's quorum reads 7.3 KB of table; the affine
// entry's least work adds a batch inversion's, far less than the 466
// products a row this layout runs. What holds it back is latency: two
// independent carry chains in one thread do not overlap (on an H100, in
// ladder_ab's mont_chain leg two chains of products take 2.02x one chain's
// time, against 1.01x for multiply-adds without carries), so a product is
// some 400 dependent instructions; a row's partials run theirs side by side,
// but the tree and the inversion's 466 dependent products run on few lanes.
#include <cuda_runtime.h>

#include <cstdint>

#include "carry.cuh"

constexpr int K6_THREADS = 32;  // partial sums per row: ops/bls.py THREADS
constexpr int K6_ROWS = 4;      // rows per block, one warp each
constexpr int INV_STEPS = 68;   // windows of p - 2
constexpr int INV_ODD = 16;     // odd powers z^1 ... z^31

namespace {

using namespace carry;

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

// p - 2, most significant first, as (squarings, odd digit): acc = z^d0,
// then acc = acc^(2^s) z^d per window (ops/bls.py INV_WINDOWS).
__constant__ uint8_t INV_WINDOWS[INV_STEPS][2] = {
    {4, 13}, {13, 17}, {7, 15}, {4, 5}, {6, 7}, {7, 23}, {5, 31}, {5, 25}, {3, 5}, {6, 13}, {6, 9},
    {3, 3}, {8, 27}, {3, 5}, {6, 15}, {6, 27}, {3, 1}, {8, 13}, {7, 23}, {5, 11}, {6, 13}, {6, 29},
    {4, 9}, {8, 29}, {4, 13}, {7, 23}, {9, 19}, {5, 25}, {2, 3}, {7, 5}, {7, 9}, {6, 23}, {5, 29},
    {5, 19}, {5, 19}, {8, 13}, {7, 21}, {9, 15}, {5, 13}, {3, 3}, {8, 15}, {3, 3}, {7, 9}, {9, 15},
    {6, 21}, {6, 31}, {5, 31}, {5, 31}, {4, 13}, {3, 3}, {8, 21}, {7, 31}, {5, 31}, {5, 31},
    {4, 15}, {4, 7}, {7, 31}, {5, 29}, {5, 31}, {5, 31}, {5, 31}, {5, 31}, {5, 31}, {5, 31},
    {4, 13}, {6, 21}, {4, 5}, {3, 1}};

struct Fe {
  uint32_t v[NL];
  __device__ __forceinline__ uint32_t operator[](int j) const { return v[j]; }
};

struct Point {
  Fe x, y, z;
};

// An operand read where it is used: limb j at p[j * stride] (a table
// column through the read-only cache, or a slot of shared memory).
struct Global {
  const uint32_t* p;
  int stride;
  __device__ __forceinline__ uint32_t operator[](int j) const { return __ldg(p + j * stride); }
};

struct Shared {
  const uint32_t* p;
  int stride;
  __device__ __forceinline__ uint32_t operator[](int j) const { return p[j * stride]; }
};

// The integer 1 (not mont(1)): a product by it leaves Montgomery form.
struct PlainOne {
  __device__ __forceinline__ uint32_t operator[](int j) const { return j == 0 ? 1u : 0u; }
};

template <class S>
__device__ __forceinline__ void load(Fe& r, const S& s) {
#pragma unroll
  for (int j = 0; j < NL; j++) r.v[j] = s[j];
}

// r = t - p when t >= p, else t (t < 2^384).
__device__ __forceinline__ void reduce_once(Fe& r, const uint32_t (&t)[NL]) {
  uint32_t d[NL];
  d[0] = sub_cc(t[0], p_limb(0));
#pragma unroll
  for (int j = 1; j < NL; j++) d[j] = subc_cc(t[j], p_limb(j));
  const uint32_t keep = subc(0, 0);  // all ones where t < p
#pragma unroll
  for (int j = 0; j < NL; j++) r.v[j] = (t[j] & keep) | (d[j] & ~keep);
}

// acc += x[off + 2k] * bi at words 2k (lo) and 2k + 1 (hi), k < 6, one
// chain; CF holds the carry out of acc[11].
template <class X>
__device__ __forceinline__ void mad_row(uint32_t (&acc)[NL], const X& x, int off, uint32_t bi) {
  acc[0] = mad_lo_cc(x[off], bi, acc[0]);
  acc[1] = madc_hi_cc(x[off], bi, acc[1]);
#pragma unroll
  for (int k = 2; k < NL; k += 2) {
    acc[k] = madc_lo_cc(x[off + k], bi, acc[k]);
    acc[k + 1] = madc_hi_cc(x[off + k], bi, acc[k + 1]);
  }
}

struct PLimbs {
  __device__ __forceinline__ uint32_t operator[](int j) const { return p_limb(j); }
};

// One digit bi of b: (even + odd 2^32) += a bi, then += m p with m making
// the low word 0. Afterwards even[0] = 0, and the sum divided by 2^32 is
// odd + (even >> 32): the next digit's call passes them swapped.
__device__ __forceinline__ void mont_step(uint32_t (&even)[NL], uint32_t (&odd)[NL], const Fe& a, uint32_t bi,
                                          bool first) {
  if (first) {
#pragma unroll
    for (int k = 0; k < NL; k += 2) {
      odd[k] = a[k + 1] * bi;
      odd[k + 1] = __umulhi(a[k + 1], bi);
      even[k] = a[k] * bi;
      even[k + 1] = __umulhi(a[k], bi);
    }
  } else {
    // even + odd 2^32 is the last step's (odd + (even >> 32)): fold
    // even[1] into odd[0] and shift even down two words as odd's products
    // are added (the arrays are the caller's, swapped).
    even[0] = add_cc(even[0], odd[1]);
#pragma unroll
    for (int k = 0; k < NL - 2; k += 2) {
      odd[k] = madc_lo_cc(a[k + 1], bi, odd[k + 2]);
      odd[k + 1] = madc_hi_cc(a[k + 1], bi, odd[k + 3]);
    }
    odd[NL - 2] = madc_lo_cc(a[NL - 1], bi, 0);
    odd[NL - 1] = madc_hi(a[NL - 1], bi, 0);
    mad_row(even, a, 0, bi);
    odd[NL - 1] = addc(odd[NL - 1], 0);
  }
  const uint32_t m = even[0] * PINV;
  mad_row(odd, PLimbs{}, 1, m);
  mad_row(even, PLimbs{}, 0, m);
  odd[NL - 1] = addc(odd[NL - 1], 0);
}

// Montgomery product a b / R mod p in [0, p), a and b in [0, 2p); r may
// be a or b. `b` is any operand with limbs b[j].
template <class B>
__device__ __forceinline__ void mont_mul(Fe& r, const Fe& a, const B& b) {
  uint32_t even[NL], odd[NL];
#pragma unroll
  for (int i = 0; i < NL; i += 2) {
    mont_step(even, odd, a, b[i], i == 0);
    mont_step(odd, even, a, b[i + 1], false);
  }
  // The sum over 2^32 is even + (odd >> 32); it is below 2p.
  even[0] = add_cc(even[0], odd[1]);
#pragma unroll
  for (int j = 1; j < NL - 1; j++) even[j] = addc_cc(even[j], odd[j + 1]);
  even[NL - 1] = addc(even[NL - 1], 0);
  reduce_once(r, even);
}

__device__ __forceinline__ void mont_sqr(Fe& r, const Fe& a) { mont_mul(r, a, a); }

// a + b mod p, a and b in [0, p): the sum is < 2p < 2^384.
__device__ __forceinline__ void add_mod(Fe& r, const Fe& a, const Fe& b) {
  uint32_t t[NL];
  t[0] = add_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int j = 1; j < NL - 1; j++) t[j] = addc_cc(a.v[j], b.v[j]);
  t[NL - 1] = addc(a.v[NL - 1], b.v[NL - 1]);
  reduce_once(r, t);
}

// a - b mod p, a and b in [0, p): p is added back where a < b.
__device__ __forceinline__ void sub_mod(Fe& r, const Fe& a, const Fe& b) {
  uint32_t d[NL];
  d[0] = sub_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int j = 1; j < NL; j++) d[j] = subc_cc(a.v[j], b.v[j]);
  const uint32_t keep = subc(0, 0);  // all ones where a < b
  r.v[0] = add_cc(d[0], p_limb(0) & keep);
#pragma unroll
  for (int j = 1; j < NL - 1; j++) r.v[j] = addc_cc(d[j], p_limb(j) & keep);
  r.v[NL - 1] = addc(d[NL - 1], p_limb(NL - 1) & keep);
}

__device__ __forceinline__ void dbl_mod(Fe& r, const Fe& a) { add_mod(r, a, a); }

__device__ __forceinline__ bool is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < NL; j++) acc |= a.v[j];
  return acc == 0;
}

__device__ __forceinline__ void set_one(Fe& a) {
#pragma unroll
  for (int j = 0; j < NL; j++) a.v[j] = one_limb(j);
}

__device__ __forceinline__ void set_identity(Point& p) {
  set_one(p.x);
  set_one(p.y);
#pragma unroll
  for (int j = 0; j < NL; j++) p.z.v[j] = 0;
}

// p = 2p (dbl-2009-l, a = 0; ops/bls.py point_dbl). Y = 0 gives Z = 0.
__device__ __forceinline__ void point_dbl(Point& p) {
  Fe A, B, C, t;
  mont_mul(t, p.y, p.z);
  dbl_mod(p.z, t);  // Z3 = 2 Y Z
  mont_sqr(A, p.x);
  mont_sqr(B, p.y);
  mont_sqr(C, B);
  add_mod(t, p.x, B);
  mont_sqr(t, t);
  sub_mod(t, t, A);
  sub_mod(t, t, C);
  dbl_mod(t, t);  // D = 2 ((X + B)^2 - A - C)
  dbl_mod(B, A);
  add_mod(B, B, A);  // E = 3 A
  mont_sqr(A, B);
  sub_mod(A, A, t);
  sub_mod(p.x, A, t);  // X3 = E^2 - 2 D
  sub_mod(A, t, p.x);
  mont_mul(A, B, A);
  dbl_mod(C, C);
  dbl_mod(C, C);
  dbl_mod(C, C);
  sub_mod(p.y, A, C);  // Y3 = E (D - X3) - 8 C
}

// acc += (x2, y2), an affine point that is not the identity, read where it
// is used (madd-2007-bl; ops/bls.py point_madd).
template <class G>
__device__ __forceinline__ void point_madd(Point& acc, const G& x2, const G& y2) {
  if (is_zero(acc.z)) {
    load(acc.x, x2);
    load(acc.y, y2);
    set_one(acc.z);
    return;
  }
  Fe Z1Z1, H, Sd;
  mont_sqr(Z1Z1, acc.z);
  mont_mul(H, Z1Z1, x2);
  sub_mod(H, H, acc.x);  // H = U2 - X1
  mont_mul(Sd, acc.z, Z1Z1);
  mont_mul(Sd, Sd, y2);
  sub_mod(Sd, Sd, acc.y);  // S2 - Y1
  if (is_zero(H)) {
    if (is_zero(Sd)) {
      point_dbl(acc);
    } else {
      set_identity(acc);
    }
    return;
  }
  Fe HH, t;
  mont_sqr(HH, H);
  add_mod(t, acc.z, H);
  mont_sqr(t, t);
  sub_mod(t, t, Z1Z1);
  sub_mod(acc.z, t, HH);  // Z3 = (Z1 + H)^2 - Z1Z1 - HH
  dbl_mod(HH, HH);
  dbl_mod(HH, HH);  // I = 4 HH
  Fe J;
  mont_mul(J, H, HH);       // J = H I
  mont_mul(HH, acc.x, HH);  // V = X1 I
  dbl_mod(Sd, Sd);          // r = 2 (S2 - Y1)
  mont_sqr(t, Sd);
  sub_mod(t, t, J);
  mont_mul(J, acc.y, J);
  dbl_mod(acc.y, J);  // 2 Y1 J
  dbl_mod(H, HH);
  sub_mod(acc.x, t, H);  // X3 = r^2 - J - 2 V
  sub_mod(t, HH, acc.x);
  mont_mul(t, Sd, t);
  sub_mod(acc.y, t, acc.y);  // Y3 = r (V - X3) - 2 Y1 J
}

// acc += q, both Jacobian, q's coordinates read where they are used
// (add-2007-bl; ops/bls.py point_add).
template <class S>
__device__ __forceinline__ void point_add(Point& acc, const S& qx, const S& qy, const S& qz) {
  Fe Z2;
  load(Z2, qz);
  if (is_zero(Z2)) return;
  if (is_zero(acc.z)) {
    load(acc.x, qx);
    load(acc.y, qy);
    acc.z = Z2;
    return;
  }
  Fe Z1Z1, Z2Z2, U1, S1, H, Sd, t;
  mont_sqr(Z1Z1, acc.z);
  mont_sqr(Z2Z2, Z2);
  mont_mul(U1, acc.x, Z2Z2);
  mont_mul(H, Z1Z1, qx);
  sub_mod(H, H, U1);  // H = U2 - U1
  mont_mul(t, acc.y, Z2);
  mont_mul(S1, t, Z2Z2);
  mont_mul(t, acc.z, qy);
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
  mont_mul(t, acc.z, Z2);
  mont_mul(t, t, H);
  dbl_mod(acc.z, t);  // Z3 = 2 Z1 Z2 H
  dbl_mod(t, H);
  mont_sqr(t, t);     // I = (2 H)^2
  mont_mul(H, H, t);  // J = H I
  mont_mul(U1, U1, t);  // V = U1 I
  dbl_mod(Sd, Sd);      // Rr = 2 (S2 - S1)
  mont_sqr(t, Sd);
  sub_mod(t, t, H);
  mont_mul(S1, S1, H);
  dbl_mod(S1, S1);  // 2 S1 J
  dbl_mod(H, U1);
  sub_mod(acc.x, t, H);  // X3 = Rr^2 - J - 2 V
  sub_mod(t, U1, acc.x);
  mont_mul(t, Sd, t);
  sub_mod(acc.y, t, S1);  // Y3 = Rr (V - X3) - 2 S1 J
}

// r = z^(p - 2) (Montgomery in, Montgomery out; 0 for 0) by INV_WINDOWS;
// powers: this lane's (INV_ODD, 12) table of z^(2k + 1), limb j of entry k
// at powers[(k * NL + j) * K6_ROWS].
__device__ __forceinline__ void invert(Fe& r, const Fe& z, uint32_t* powers) {
  Fe z2;
  mont_sqr(z2, z);
  r = z;
#pragma unroll 1
  for (int k = 0;; k++) {
#pragma unroll
    for (int j = 0; j < NL; j++) powers[(k * NL + j) * K6_ROWS] = r.v[j];
    if (k == INV_ODD - 1) break;
    mont_mul(r, r, z2);  // z^(2k + 3)
  }
  load(r, Shared{powers + (INV_WINDOWS[0][1] >> 1) * NL * K6_ROWS, K6_ROWS});
#pragma unroll 1
  for (int s = 1; s < INV_STEPS; s++) {
#pragma unroll 1
    for (int q = INV_WINDOWS[s][0]; q > 0; q--) mont_sqr(r, r);
    mont_mul(r, r, Shared{powers + (INV_WINDOWS[s][1] >> 1) * NL * K6_ROWS, K6_ROWS});
  }
}

// tx, ty: (12, n) limbs; present: (n,) bool; mask: (batch, n) bool.
// AFFINE = false: out (3, 12, batch) limbs of each row's Jacobian sum;
// AFFINE = true: out (2, 12, batch) canonical limbs of x and y, identity
// (batch,) 1 where the sum is the identity.
template <bool AFFINE>
__global__ void __launch_bounds__(K6_ROWS * K6_THREADS)
    g1_aggregate_kernel(const uint32_t* __restrict__ tx, const uint32_t* __restrict__ ty,
                        const uint8_t* __restrict__ present, const uint8_t* __restrict__ mask,
                        uint32_t* __restrict__ out, uint8_t* __restrict__ identity, int n, int batch) {
  __shared__ uint32_t part[K6_ROWS][K6_THREADS][3 * NL + 1];
  __shared__ uint32_t powers[INV_ODD * NL * K6_ROWS];
  const int w = threadIdx.x / K6_THREADS;
  const int t = threadIdx.x % K6_THREADS;
  const int row = blockIdx.x * K6_ROWS + w;

  Point acc;
  set_identity(acc);
  if (row < batch) {
    const uint8_t* bits = mask + (size_t)row * n;
    for (int k = t; k < n; k += K6_THREADS) {
      if (bits[k] && present[k]) point_madd(acc, Global{tx + k, n}, Global{ty + k, n});
    }
  }

  uint32_t* mine = part[w][t];
#pragma unroll
  for (int j = 0; j < NL; j++) {
    mine[j] = acc.x.v[j];
    mine[NL + j] = acc.y.v[j];
    mine[2 * NL + j] = acc.z.v[j];
  }
  __syncwarp();
  for (int s = K6_THREADS / 2; s > 0; s >>= 1) {
    if (t < s) {
      const uint32_t* other = part[w][t + s];
      point_add(acc, Shared{other, 1}, Shared{other + NL, 1}, Shared{other + 2 * NL, 1});
#pragma unroll
      for (int j = 0; j < NL; j++) {
        mine[j] = acc.x.v[j];
        mine[NL + j] = acc.y.v[j];
        mine[2 * NL + j] = acc.z.v[j];
      }
    }
    __syncwarp();
  }
  if (!AFFINE) {
    if (row < batch) {
      for (int j = t; j < 3 * NL; j += K6_THREADS) out[(size_t)j * batch + row] = part[w][0][j];
    }
    return;
  }

  __syncthreads();
  const int r = t;  // warp 0's lane r converts the block's row r
  const int mine_row = blockIdx.x * K6_ROWS + r;
  if (w != 0 || r >= K6_ROWS || mine_row >= batch) return;
  const uint32_t* sum = part[r][0];
  Fe z, zi, v;
  load(z, Shared{sum + 2 * NL, 1});
  identity[mine_row] = is_zero(z);
  invert(zi, z, powers + r);
  mont_sqr(z, zi);  // zi^2
  mont_mul(v, z, Shared{sum, 1});
  mont_mul(v, v, PlainOne{});
#pragma unroll
  for (int j = 0; j < NL; j++) out[(size_t)j * batch + mine_row] = v.v[j];
  mont_mul(z, z, zi);  // zi^3
  mont_mul(v, z, Shared{sum + NL, 1});
  mont_mul(v, v, PlainOne{});
#pragma unroll
  for (int j = 0; j < NL; j++) out[(size_t)(NL + j) * batch + mine_row] = v.v[j];
}

// out = a b / R mod p per column; a, b, out: (12, batch) limbs, a and b < 2p.
__global__ void mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, int batch) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch) return;
  Fe x, y, r;
  load(x, Global{a + i, batch});
  load(y, Global{b + i, batch});
  mont_mul(r, x, y);
#pragma unroll
  for (int j = 0; j < NL; j++) out[j * batch + i] = r.v[j];
}

}  // namespace

extern "C" int hs_g1_aggregate(const void* tx, const void* ty, const void* present, const void* mask,
                               void* out, int n, int batch, void* stream) {
  g1_aggregate_kernel<false><<<(batch + K6_ROWS - 1) / K6_ROWS, K6_ROWS * K6_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)tx, (const uint32_t*)ty, (const uint8_t*)present, (const uint8_t*)mask,
      (uint32_t*)out, nullptr, n, batch);
  return (int)cudaGetLastError();
}

extern "C" int hs_g1_aggregate_affine(const void* tx, const void* ty, const void* present, const void* mask,
                                      void* out, void* identity, int n, int batch, void* stream) {
  g1_aggregate_kernel<true><<<(batch + K6_ROWS - 1) / K6_ROWS, K6_ROWS * K6_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)tx, (const uint32_t*)ty, (const uint8_t*)present, (const uint8_t*)mask,
      (uint32_t*)out, (uint8_t*)identity, n, batch);
  return (int)cudaGetLastError();
}

extern "C" int hs_bls_mont_mul(const void* a, const void* b, void* out, int batch, void* stream) {
  mont_mul_kernel<<<(batch + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, batch);
  return (int)cudaGetLastError();
}
