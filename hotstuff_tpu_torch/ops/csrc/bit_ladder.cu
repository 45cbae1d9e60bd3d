// Kernel K7: the 253-step bit ladder [s]B + [h](-A).
//
// Replaces the ladder of hotstuff_tpu/ops/ed25519.py:_verify_kernel
// (lax.fori_loop at :612-624, jitted as _verify_jit), the legacy kernel
// behind the verifier's kernel="bits". From the identity, for bit i = 252
// down to 0: double (dbl-2008-hwcd, with T), then a mixed add of B when
// bit i of s is set and a mixed add of -A when bit i of h is set
// (madd-2008-hwcd-3). The TPU kernel computes both adds on every lane and
// selects; a mixed add under a clear bit would leave the accumulator as it
// was, so this kernel branches on the bit and gives the same limbs as the
// plain version's select (ops/bit_ladder.py bit_ladder_plain).
//
// One thread per signature, on field.cuh's fe_mul / fe_sq (the simple
// first design; quad.cuh's four-thread layout is K1's):
//   * the accumulator (X, Y, Z, T) stays in registers for the whole loop;
//   * both adds run through ONE copy of the mixed add, a two-pass inner
//     loop over (s, B) and (h, -A) that reads its operand from memory
//     under the bit's branch: holding -A's 30 limbs in registers, or
//     inlining a second mixed add, took ptxas to 255 registers with
//     spills and ran slower on the H100;
//   * -A's precomp is entry 1 of K3's cached table (Z = 1): components 0,
//     1 and 3 of the (4, 16, 10, B) lane-fastest table, neighbouring lanes
//     on neighbouring words; B's is entry 1 of the shared k*B table, the
//     same address on every lane;
//   * s and h bits are (253, B) uint8, row i = bit i, read one byte a lane
//     a step (neighbouring lanes, neighbouring bytes).
// Bound: integer multiplies. A doubling is 4 squares (55 products) and 4
// products (100); a mixed add 7 products (700). The data needs a mixed add
// only for a set bit; a warp issues one whenever any of its 32 lanes has
// the bit set, which for random scalars is every step, ~2,020 products a
// lane a bit. Bytes: ~0.6 KB a lane.
#include <cuda_runtime.h>

#include "field.cuh"

#define BL_THREADS 128
#define BL_BITS 253

namespace {

// One element read through the read-only path: limb i at p[i * stride].
__device__ __forceinline__ fe load_fe_ldg(const int32_t* p, int stride) {
  fe r;
#pragma unroll
  for (int i = 0; i < HS_NL; i++) r.v[i] = __ldg(p + (size_t)i * stride);
  return r;
}

struct ext_point {
  fe X, Y, Z, T;
};

// dbl-2008-hwcd for a = -1, producing T (ops/ed25519.py point_dbl).
__device__ __forceinline__ void bl_dbl(ext_point& p) {
  const fe xx = fe_sq(p.X);
  const fe yy = fe_sq(p.Y);
  const fe zz = fe_sq(p.Z);
  const fe zz2 = fe_add(zz, zz);
  const fe aa = fe_sq(fe_add(p.X, p.Y));
  const fe yp = fe_add(yy, xx);
  const fe zp = fe_sub(yy, xx);
  const fe xp = fe_sub(aa, yp);
  const fe tp = fe_sub(zz2, zp);
  p.X = fe_mul(xp, tp);
  p.Y = fe_mul(yp, zp);
  p.Z = fe_mul(zp, tp);
  p.T = fe_mul(xp, yp);
}

// madd-2008-hwcd-3: P + affine precomp Q, producing T (point_madd).
__device__ __forceinline__ void bl_madd(ext_point& p, const fe& ypx, const fe& ymx, const fe& xy2d) {
  const fe a = fe_mul(fe_add(p.Y, p.X), ypx);
  const fe b = fe_mul(fe_sub(p.Y, p.X), ymx);
  const fe c = fe_mul(p.T, xy2d);
  const fe d2z = fe_add(p.Z, p.Z);
  const fe x3 = fe_sub(a, b);
  const fe y3 = fe_add(a, b);
  const fe z3 = fe_add(d2z, c);
  const fe t3 = fe_sub(d2z, c);
  p.X = fe_mul(x3, t3);
  p.Y = fe_mul(y3, z3);
  p.Z = fe_mul(z3, t3);
  p.T = fe_mul(x3, y3);
}

// s_bits, h_bits: (253, B) uint8. base: (3, 16, 10) int32 affine precomp of
// k*B (entry 1 is B). table: (4, 16, 10, B) int32 cached k*(-A) from K3.
// out: (4, 10, B) int32 extended (X, Y, Z, T).
__global__ void __launch_bounds__(BL_THREADS)
bit_ladder_kernel(const uint8_t* __restrict__ s_bits, const uint8_t* __restrict__ h_bits,
                  const int32_t* __restrict__ base, const int32_t* __restrict__ table,
                  int32_t* __restrict__ out, int batch) {
  const int lane = blockIdx.x * BL_THREADS + threadIdx.x;
  if (lane >= batch) return;  // no block-wide exchange: a tail thread may leave
  const size_t entry = (size_t)HS_NL * batch;  // stride between table entries
  const int32_t* na = table + entry + lane;    // -A: component 0, entry 1

  ext_point acc{fe_zero(), fe_one(), fe_one(), fe_zero()};
#pragma unroll 1
  for (int i = BL_BITS - 1; i >= 0; i--) {
    bl_dbl(acc);
    const size_t at = (size_t)i * batch + lane;
#pragma unroll 1
    for (int j = 0; j < 2; j++) {  // j = 0: bit i of s adds B; j = 1: bit i of h adds -A
      if ((j ? h_bits : s_bits)[at]) {
        const int32_t* q = j ? na : base + HS_NL;           // entry 1, component 0
        const int limb = j ? batch : 1;                     // limb stride
        const size_t comp = j ? 16 * entry : 16 * HS_NL;    // component stride
        bl_madd(acc, load_fe_ldg(q, limb), load_fe_ldg(q + comp, limb), load_fe_ldg(q + (j ? 3 : 2) * comp, limb));
      }
    }
  }
  store_fe(out + lane, batch, acc.X);
  store_fe(out + entry + lane, batch, acc.Y);
  store_fe(out + 2 * entry + lane, batch, acc.Z);
  store_fe(out + 3 * entry + lane, batch, acc.T);
}

}  // namespace

extern "C" int hs_bit_ladder(const void* s_bits, const void* h_bits, const void* base, const void* table,
                             void* out, int batch, void* stream) {
  const int blocks = (batch + BL_THREADS - 1) / BL_THREADS;
  bit_ladder_kernel<<<blocks, BL_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)s_bits, (const uint8_t*)h_bits, (const int32_t*)base, (const int32_t*)table,
      (int32_t*)out, batch);
  return (int)cudaGetLastError();
}
