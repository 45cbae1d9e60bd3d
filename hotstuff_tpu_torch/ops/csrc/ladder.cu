// Kernel K1: the 4-bit-window Straus ladder [s]B + [h](-A).
//
// Replaces hotstuff_tpu/ops/pallas_ladder.py:_ladder_kernel (ladder_pallas,
// pl.pallas_call at :144). The TPU kernel holds 256 lanes VMEM-resident per
// grid program and selects table entries with masked sums over all 16
// (TPUs gather poorly). Here one thread verifies one signature:
//   * the accumulator point (4 x 10 limbs) lives in registers;
//   * the shared k*B table (3 x 16 x 10 int32, 1.9 KB) is copied into shared
//     memory per block — threads index it by different digits, which
//     constant memory would serialize;
//   * the per-item k*(-A) table (4 x 16 x 10 int32 = 2.5 KB per lane) stays
//     in device memory, lane-fastest, and is read by digit: one 4-byte load
//     per limb, neighbouring lanes on neighbouring addresses when digits agree.
// Bound: integer multiplies, not bytes — ~2.7 KB read per lane against
// ~2,200 field multiplies (~150k IMAD.WIDE products) per lane.
#include <cuda_runtime.h>

#include "curve.cuh"

#define HS_LADDER_THREADS 32  // one warp per block: 4,096 lanes spread over 128 SMs

// sd, hd: (64, B) uint8 digits, row d of significance 16^d.
// base: (3, 16, 10) int32 affine precomp of k*B. table: (4, 16, 10, B) int32
// cached k*(-A). out: (4, 10, B) int32 extended (X, Y, Z, T); T is zeros.
__global__ void __launch_bounds__(HS_LADDER_THREADS)
ladder_kernel(const uint8_t* __restrict__ sd, const uint8_t* __restrict__ hd,
              const int32_t* __restrict__ base, const int32_t* __restrict__ table,
              int32_t* __restrict__ out, int batch) {
  __shared__ int32_t sbase[3 * 16 * HS_NL];
  for (int i = threadIdx.x; i < 3 * 16 * HS_NL; i += blockDim.x) sbase[i] = base[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;

  const size_t entry = (size_t)HS_NL * batch;  // stride between table entries
  ge acc = ge_identity();
#pragma unroll 1
  for (int g = 0; g < 64; g++) {
    const int row = 63 - g;
    acc = ge_dbl<false>(acc);
    acc = ge_dbl<false>(acc);
    acc = ge_dbl<false>(acc);
    acc = ge_dbl<true>(acc);
    const int s = sd[(size_t)row * batch + lane];
    const int h = hd[(size_t)row * batch + lane];
    acc = ge_madd<true>(acc, load_fe(sbase + (0 * 16 + s) * HS_NL, 1),
                        load_fe(sbase + (1 * 16 + s) * HS_NL, 1),
                        load_fe(sbase + (2 * 16 + s) * HS_NL, 1));
    const int32_t* t = table + lane;
    acc = ge_add_cached<false>(acc, load_fe(t + (0 * 16 + h) * entry, batch),
                               load_fe(t + (1 * 16 + h) * entry, batch),
                               load_fe(t + (2 * 16 + h) * entry, batch),
                               load_fe(t + (3 * 16 + h) * entry, batch));
  }
  store_fe(out + 0 * (size_t)HS_NL * batch + lane, batch, acc.X);
  store_fe(out + 1 * (size_t)HS_NL * batch + lane, batch, acc.Y);
  store_fe(out + 2 * (size_t)HS_NL * batch + lane, batch, acc.Z);
  store_fe(out + 3 * (size_t)HS_NL * batch + lane, batch, acc.T);
}

extern "C" int hs_ladder(const void* sd, const void* hd, const void* base, const void* table,
                         void* out, int batch, void* stream) {
  const int blocks = (batch + HS_LADDER_THREADS - 1) / HS_LADDER_THREADS;
  ladder_kernel<<<blocks, HS_LADDER_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)sd, (const uint8_t*)hd, (const int32_t*)base, (const int32_t*)table,
      (int32_t*)out, batch);
  return (int)cudaGetLastError();
}
