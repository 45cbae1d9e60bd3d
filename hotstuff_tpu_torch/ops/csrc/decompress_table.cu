// Kernel K3: key decompression and the 16-entry cached k*(-A) table.
//
// Replaces hotstuff_tpu/ops/ed25519.py:decompress (:561-588) and
// _build_neg_a_table (:242-264), jnp code that XLA runs around the Pallas
// ladder. Per lane: the ref10 square root (274 field ops in one serial
// chain, 262 of them the pow2523 power), then 14 mixed additions and the
// 16 entries of the table.
// Bound: integer multiplies — 32 bytes in and 2.5 KB of table out per lane
// against ~28k limb products (one IMAD.WIDE each) per lane.
//
// Both parts are serial chains, so the latency of one field op sets the
// time. Each block of four warps takes 32 lanes, in two phases:
//   1. The square root on the split field (split_field.cuh), as K4 runs its
//      inversion: warp g computes column group g of every product of the
//      decompression for the block's 32 lanes, one lane per thread. u, v
//      and u v^3 wait out the pow2523 chain in shared memory, so the chain
//      runs in K4's registers. The split limbs differ from the ref10
//      chain's, but phase 1's outputs (x and -x canonical, valid decided on
//      canonical values) are `decompress`'s exactly; ops/ed25519.py
//      `decompress_split` runs its integer steps. Warp 0 writes valid and
//      hands each lane's canonical -x and RAW y limbs (fe_frombytes, as the
//      plain table build reads them) to shared memory.
//   2. The table, four threads per lane (quad.cuh): quad j of the block
//      builds lane j's table, thread k owning coordinate k of (X, Y, Z, T)
//      and calling fe_mul on the operands of the plain version
//      (ops/ed25519.py build_neg_a_table), so the table equals
//      decompress_table_plain's limb for limb. Thread k stores component k
//      of every entry: Y+X and Y-X are the operands that the pair exchange
//      opening the next addition gives threads 0 and 1, Z is thread 2's own
//      coordinate, and 2d*T is the stage-1 multiply of thread 3, whose Z
//      passes into a mixed addition unmultiplied.
//
// Tail lanes: every warp must reach every __syncthreads and every quad
// every __syncwarp, so a lane past the batch computes on the last lane and
// skips only its stores.
#include <cuda_runtime.h>

#include "quad.cuh"
#include "split_field.cuh"

#define HS_K3_MIN_BLOCKS 4  // <= 128 registers a thread

// A block's shared memory; no two parts alias.
struct k3_shared {
  split_area split;            // phase 1's exchange (7,680 B)
  int32_t hold[3][HS_NL][32];  // u, v, u v^3 across the chain (3,840 B)
  int32_t hand[2][HS_NL][32];  // raw y and canonical -x, phase 1 -> 2 (2,560 B)
  __align__(16) int32_t slots[HS_SPLIT_THREADS / 32][HS_QUAD_THREADS * HS_SLOT];  // phase 2, per warp (6,144 B)
};

// Element `l` of a structure-of-arrays area of 32 elements.
__device__ __forceinline__ void put_soa(int32_t (*area)[32], int l, const fe& a) {
#pragma unroll
  for (int i = 0; i < HS_NL; i++) area[i][l] = a.v[i];
}

__device__ __forceinline__ fe get_soa(const int32_t (*area)[32], int l) {
  fe r;
#pragma unroll
  for (int i = 0; i < HS_NL; i++) r.v[i] = area[i][l];
  return r;
}

// Phase 1, warp G: ops/ed25519.py decompress on the split ops.
template <int G>
__device__ __forceinline__ void sqrt_body(k3_shared& sh, const uint8_t* __restrict__ a,
                                          bool* __restrict__ valid, int lane, bool store,
                                          int batch) {
  split_xchg x(sh.split);
  const int l = threadIdx.x & 31;
  uint8_t key[32];
#pragma unroll
  for (int j = 0; j < 32; j++) key[j] = a[(size_t)j * batch + lane];
  const int sign = key[31] >> 7;
  fe z;
  {
    const fe y = fe_frombytes(key);
    const fe yy = split_sq<G>(x, y);
    const fe u = fe_sub(yy, fe_one());
    const fe v = fe_add(split_mul<G>(x, fe_d(), yy), fe_one());
    const fe v3 = split_mul<G>(x, split_sq<G>(x, v), v);
    const fe v7 = split_mul<G>(x, split_sq<G>(x, v3), v);
    const fe uv3 = split_mul<G>(x, u, v3);
    z = split_mul<G>(x, u, v7);
    if (G == 0) {
      put_soa(sh.hand[0], l, y);
      put_soa(sh.hold[0], l, u);
      put_soa(sh.hold[1], l, v);
      put_soa(sh.hold[2], l, uv3);
    }
  }
  const fe w = split_pow2523<G>(x, z);  // its barriers publish `hold`
  const fe u = get_soa(sh.hold[0], l);
  const fe r = split_mul<G>(x, get_soa(sh.hold[2], l), w);
  const fe chk = fe_canonical(split_mul<G>(x, get_soa(sh.hold[1], l), split_sq<G>(x, r)));
  const fe r_i = split_mul<G>(x, r, fe_sqrtm1());
  if (G != 0) return;
  const bool is_pos = fe_eq(chk, fe_canonical(u));
  const bool is_neg = fe_eq(chk, fe_canonical(fe_sub(fe_zero(), u))) && !is_pos;
  const fe x_c = fe_canonical(fe_select(is_neg, r_i, r));
  const fe xneg_c = fe_canonical(fe_sub(fe_zero(), x_c));
  put_soa(sh.hand[1], l, fe_select(fe_parity(x_c) != sign, x_c, xneg_c));
  if (store) valid[lane] = is_pos || is_neg;
}

// Phase 2, quad j of the block: lane j's table (ops/ed25519.py
// build_neg_a_table), entry n + 1 = entry n + (-A) by madd-2008-hwcd-3.
__device__ __forceinline__ void table_quad(k3_shared& sh, int32_t* __restrict__ table,
                                           int batch) {
  const quad_pos q = quad_here();
  quad_xchg x(sh.slots[threadIdx.x >> 5], q);
  const int j = threadIdx.x >> 2;
  const int lane = blockIdx.x * 32 + j;
  const bool store = lane < batch;
  const fe y = get_soa(sh.hand[0], j), xneg = get_soa(sh.hand[1], j);
  const fe t1 = fe_mul(xneg, y);
  // This thread's coordinate of -A = (-x, y, 1, -x*y), and the factor of
  // its stage-1 multiply: -A's madd precomp (y+x, y-x, 2d*x*y) on threads
  // 0-2, 2d on thread 3.
  fe c = fe_select(q.k == 0, xneg, fe_select(q.k == 1, y, fe_select(q.k == 2, fe_one(), t1)));
  const fe e = fe_select(q.k == 0, fe_add(y, xneg),
                         fe_select(q.k == 1, fe_sub(y, xneg),
                                   fe_select(q.k == 2, fe_mul(fe_d2(), t1), fe_d2())));
  const size_t entry = (size_t)HS_NL * batch;
  int32_t* out = table + (size_t)q.k * 16 * entry + lane;  // component k: y+x, y-x, z, 2d*t
  if (store) store_fe(out, batch, fe_select(q.k == 3, fe_zero(), fe_one()));  // entry 0: identity
#pragma unroll 1
  for (int n = 1; n < 16; n++) {
    const fe u = quad_add_operand(q, x, c);             // Y+X, Y-X, T, Z
    const fe m = fe_mul(fe_select(q.k == 3, c, u), e);  // (Y+X)ypx, (Y-X)ymx, T*xy2d, 2d*T
    if (store) store_fe(out + n * entry, batch, fe_select(q.k < 2, u, fe_select(q.k == 2, c, m)));
    if (n < 15) c = quad_add_finish(q, x, fe_select(q.k == 3, u, m));
  }
}

// a: (32, B) uint8 key bytes (bit 255 = sign of x). table: (4, 16, 10, B)
// int32 (y+x, y-x, z, 2d*t) of k*(-A), k = 0..15. valid: (B,) bool.
__global__ void __launch_bounds__(HS_SPLIT_THREADS, HS_K3_MIN_BLOCKS)
decompress_table_kernel(const uint8_t* __restrict__ a, int32_t* __restrict__ table,
                        bool* __restrict__ valid, int batch) {
  __shared__ k3_shared sh;
  const int want = blockIdx.x * 32 + (threadIdx.x & 31);
  const int lane = min(want, batch - 1);  // a tail lane computes on the last lane
  const bool store = want < batch;
  switch (threadIdx.x >> 5) {
    case 0: sqrt_body<0>(sh, a, valid, lane, store, batch); break;
    case 1: sqrt_body<1>(sh, a, valid, lane, store, batch); break;
    case 2: sqrt_body<2>(sh, a, valid, lane, store, batch); break;
    default: sqrt_body<3>(sh, a, valid, lane, store, batch); break;
  }
  __syncthreads();  // the hand-off is written
  table_quad(sh, table, batch);
}

extern "C" int hs_decompress_table(const void* a, void* table, void* valid, int batch,
                                   void* stream) {
  const int blocks = (batch + 31) / 32;
  decompress_table_kernel<<<blocks, HS_SPLIT_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a, (int32_t*)table, (bool*)valid, batch);
  return (int)cudaGetLastError();
}
