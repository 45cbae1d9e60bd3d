// Kernel K7: the 253-step bit ladder [s]B + [h](-A).
//
// Replaces the ladder of hotstuff_tpu/ops/ed25519.py:_verify_kernel
// (lax.fori_loop at :612-624, jitted as _verify_jit), the legacy kernel
// behind the verifier's kernel="bits". From the identity, for bit i = 252
// down to 0: double (dbl-2008-hwcd, with T), then a mixed add of B when
// bit i of s is set and a mixed add of -A when bit i of h is set
// (madd-2008-hwcd-3). Both adds compute T, which the next add reads.
//
// Four threads a signature, on quad.cuh (K1's layout): thread k of a quad
// keeps coordinate k (X, Y, Z, T) of the accumulator, and each point op is
// two stages of four independent field products, exchanged through shared
// memory (quad_xchg). A step is quad_dbl, then quad_add<false> with B's
// affine precomp, then quad_add<false> with -A's: 6 multiply stages a
// thread.
//   * No branch on a lane's bit around an exchange: every put() runs
//     __syncwarp on the full warp, so a quad that skipped an add while the
//     others of its warp ran it would deadlock. Every quad runs both adds
//     on every step and keeps fe_select(bit, added, acc), the reference's
//     own per-lane select (_select_point), so the limbs equal the plain
//     version's (ops/bit_ladder.py bit_ladder_plain).
//   * The operands sit in registers for all 253 steps: thread k loads its
//     one coordinate of each precomp before the loop, 10 + 10 limbs. B's
//     is entry 1 of the shared k*B table, coordinate quad_affine_coord
//     (y+x, y-x, 2d*x*y; thread 3's product is discarded); -A's is entry 1
//     of K3's cached table (Z = 1), components 0, 1 and 3 (y+x, y-x,
//     2d*t) on threads 0, 1 and 2, the words bit_ladder_plain reads as
//     na[0], na[1], na[3].
//   * s and h bits are (253, B) uint8, row i = bit i: the four threads of
//     a quad read their lane's byte, a row ahead of its use.
//   * The result keeps T as computed (the plain version returns T = XY/Z
//     from the last op): each thread stores its own coordinate.
//   * A quad whose lane is past the batch computes on the last lane (every
//     exchange needs all 32 threads) and stores nothing.
// Bound: integer multiplies. A doubling is 4 squares (55 products) and 4
// products (100); a mixed add 7 products (700). The function needs 620
// products a lane a bit and 700 a set bit; the warp issues both adds on
// every step, all 2 x 700 products and thread 3's discarded stage-1
// product of each (2 x 100), 2,220 a lane a bit. Bytes: ~0.6 KB a lane.
#include <cuda_runtime.h>

#include "quad.cuh"

#define BL_BITS 253

namespace {

// s_bits, h_bits: (253, B) uint8. base: (3, 16, 10) int32 affine precomp of
// k*B (entry 1 is B). table: (4, 16, 10, B) int32 cached k*(-A) from K3.
// out: (4, 10, B) int32 extended (X, Y, Z, T).
// At least 16 blocks per SM, at most 128 registers a thread (as K1; 122
// used, no spills). A cap of 12 blocks let ptxas take 168 and ran 1-2.4%
// faster on an H100 (PERF.md, section 6): left for a later tuning.
__global__ void __launch_bounds__(HS_QUAD_THREADS, 16)
bit_ladder_kernel(const uint8_t* __restrict__ s_bits, const uint8_t* __restrict__ h_bits,
                  const int32_t* __restrict__ base, const int32_t* __restrict__ table,
                  int32_t* __restrict__ out, int batch) {
  __shared__ __align__(16) int32_t xslots[HS_QUAD_THREADS * HS_SLOT];
  const quad_pos q = quad_here();
  const int want = blockIdx.x * HS_QUAD_LANES + threadIdx.x / 4;
  const int lane = want < batch ? want : batch - 1;  // a tail quad computes, stores nothing
  quad_xchg x(xslots, q);

  const size_t entry = (size_t)HS_NL * batch;  // stride between table entries
  const fe eb = load_fe(base + (quad_affine_coord(q) * 16 + 1) * HS_NL, 1);
  const fe ea = load_fe(table + ((q.k < 2 ? q.k : 3) * 16 + 1) * entry + lane, batch);

  fe c = (q.k == 1 || q.k == 2) ? fe_one() : fe_zero();
  int s = __ldg(s_bits + (size_t)(BL_BITS - 1) * batch + lane);
  int h = __ldg(h_bits + (size_t)(BL_BITS - 1) * batch + lane);
#pragma unroll 1
  for (int i = BL_BITS - 1; i >= 0; i--) {
    const size_t next = (size_t)(i > 0 ? i - 1 : 0) * batch + lane;
    const int s1 = __ldg(s_bits + next), h1 = __ldg(h_bits + next);
    c = quad_dbl(q, x, c);
    c = fe_select(s != 0, quad_add<false>(q, x, c, eb), c);
    c = fe_select(h != 0, quad_add<false>(q, x, c, ea), c);
    s = s1, h = h1;
  }
  if (want < batch) store_fe(out + (size_t)q.k * entry + lane, batch, c);
}

}  // namespace

extern "C" int hs_bit_ladder(const void* s_bits, const void* h_bits, const void* base, const void* table,
                             void* out, int batch, void* stream) {
  const int blocks = (batch + HS_QUAD_LANES - 1) / HS_QUAD_LANES;
  bit_ladder_kernel<<<blocks, HS_QUAD_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)s_bits, (const uint8_t*)h_bits, (const int32_t*)base, (const int32_t*)table,
      (int32_t*)out, batch);
  return (int)cudaGetLastError();
}
