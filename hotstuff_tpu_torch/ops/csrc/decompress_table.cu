// Kernel K3: key decompression and the 16-entry cached k*(-A) table.
//
// Replaces hotstuff_tpu/ops/ed25519.py:decompress (:561-588) and
// _build_neg_a_table (:242-264), jnp code that XLA runs around the Pallas
// ladder. One thread per key: the ref10 square root (one pow2523 chain,
// ~265 field multiplies) and 14 mixed additions for the table.
// Bound: integer multiplies — 32 bytes in and 2.5 KB of table out per lane
// against ~400 field multiplies (~33k IMAD.WIDE products) per lane.
#include <cuda_runtime.h>

#include "curve.cuh"

#define HS_THREADS 32  // one warp per block: spreads a 4,096-lane chunk over 128 SMs

__device__ __forceinline__ void store_entry(int32_t* table, size_t entry, int k, int batch,
                                            const ge& p) {
  store_fe(table + (0 * 16 + k) * entry, batch, fe_add(p.Y, p.X));
  store_fe(table + (1 * 16 + k) * entry, batch, fe_sub(p.Y, p.X));
  store_fe(table + (2 * 16 + k) * entry, batch, p.Z);
  store_fe(table + (3 * 16 + k) * entry, batch, fe_mul(fe_d2(), p.T));
}

// a: (32, B) uint8 key bytes (bit 255 = sign of x). table: (4, 16, 10, B)
// int32 (y+x, y-x, z, 2d*t) of k*(-A), k = 0..15. valid: (B,) bool.
__global__ void __launch_bounds__(HS_THREADS)
decompress_table_kernel(const uint8_t* __restrict__ a, int32_t* __restrict__ table,
                        bool* __restrict__ valid, int batch) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  uint8_t key[32];
#pragma unroll
  for (int j = 0; j < 32; j++) key[j] = a[(size_t)j * batch + lane];
  const fe y = fe_frombytes(key);
  fe x, xneg;
  bool ok;
  ge_decompress(y, key[31] >> 7, x, xneg, ok);
  valid[lane] = ok;

  const fe na_ypx = fe_add(y, xneg);
  const fe na_ymx = fe_sub(y, xneg);
  const fe na_xy2d = fe_mul(fe_d2(), fe_mul(xneg, y));
  const size_t entry = (size_t)HS_NL * batch;
  int32_t* t = table + lane;
  store_entry(t, entry, 0, batch, ge_identity());
  ge cur = ge{xneg, y, fe_one(), fe_mul(xneg, y)};
  store_entry(t, entry, 1, batch, cur);
#pragma unroll 1
  for (int k = 2; k < 16; k++) {
    cur = ge_madd<true>(cur, na_ypx, na_ymx, na_xy2d);
    store_entry(t, entry, k, batch, cur);
  }
}

extern "C" int hs_decompress_table(const void* a, void* table, void* valid, int batch,
                                   void* stream) {
  const int blocks = (batch + HS_THREADS - 1) / HS_THREADS;
  decompress_table_kernel<<<blocks, HS_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a, (int32_t*)table, (bool*)valid, batch);
  return (int)cudaGetLastError();
}
