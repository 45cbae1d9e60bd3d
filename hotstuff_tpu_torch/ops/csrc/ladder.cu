// Kernel K1: the 4-bit-window Straus ladder [s]B + [h](-A).
//
// Replaces hotstuff_tpu/ops/pallas_ladder.py:_ladder_kernel (ladder_pallas,
// pl.pallas_call at :144). The TPU kernel holds 256 lanes VMEM-resident per
// grid program and selects table entries with masked sums over all 16
// (TPUs gather poorly). Here four threads verify one signature (quad.cuh):
//   * thread k of the quad keeps coordinate k of the accumulator in
//     registers; the quad exchanges products through shared memory between
//     multiply stages;
//   * the shared k*B table (3 x 16 x 10 int32, 1.9 KB) is copied into shared
//     memory per block — threads index it by different digits, which
//     constant memory would serialize;
//   * the per-item k*(-A) table (4 x 16 x 10 int32 = 2.5 KB per lane) stays
//     in device memory, lane-fastest; each thread reads only the coordinate
//     its stage-1 product uses (10 limbs per group), one group ahead.
// Bound: integer multiplies, not bytes — ~2.7 KB read per lane against
// ~2,300 field multiplies (~229k limb products) per lane. One-warp blocks
// of 8 signatures: a 4,096-lane chunk is 512 warps, about 4 per SM, one
// per warp scheduler.
#include <cuda_runtime.h>

#include "quad.cuh"

// The per-lane cached table: coordinate (y+x, y-x, z, 2d*t) of each digit.
struct cached_item {
  static constexpr bool CACHED = true;
  const int32_t* t;  // table + coordinate * 16 * entry + lane
  size_t entry;      // stride between table entries (HS_NL * batch)
  int batch;
  __device__ __forceinline__ fe load(int h) const {
    fe r;
    const int32_t* p = t + h * entry;
#pragma unroll
    for (int i = 0; i < HS_NL; i++) r.v[i] = __ldg(p + (size_t)i * batch);
    return r;
  }
};

// sd, hd: (64, B) uint8 digits, row d of significance 16^d.
// base: (3, 16, 10) int32 affine precomp of k*B. table: (4, 16, 10, B) int32
// cached k*(-A). out: (4, 10, B) int32 extended (X, Y, Z, T); T is zeros.
// At least 16 blocks per SM: 65,536 / (16 x 32), at most 128 registers per
// thread (K5's tighter cap cost this kernel time, PERF.md section 6).
__global__ void __launch_bounds__(HS_QUAD_THREADS, 16)
ladder_kernel(const uint8_t* __restrict__ sd, const uint8_t* __restrict__ hd,
              const int32_t* __restrict__ base, const int32_t* __restrict__ table,
              int32_t* __restrict__ out, int batch) {
  __shared__ int32_t sbase[3 * 16 * HS_NL];
  __shared__ __align__(16) int32_t xslots[HS_QUAD_THREADS * HS_SLOT];
  for (int i = threadIdx.x; i < 3 * 16 * HS_NL; i += blockDim.x) sbase[i] = base[i];
  __syncthreads();
  const quad_pos q = quad_here();
  const int want = blockIdx.x * HS_QUAD_LANES + threadIdx.x / 4;
  const int lane = want < batch ? want : batch - 1;  // a tail quad computes, stores nothing

  const size_t entry = (size_t)HS_NL * batch;
  const cached_item item{table + quad_cached_coord(q) * 16 * entry + lane, entry, batch};
  const fe c = quad_ladder(q, xslots, sbase, sd, hd, lane, batch, item);
  if (want < batch) quad_store(q, out, lane, batch, c);
}

extern "C" int hs_ladder(const void* sd, const void* hd, const void* base, const void* table,
                         void* out, int batch, void* stream) {
  const int blocks = (batch + HS_QUAD_LANES - 1) / HS_QUAD_LANES;
  ladder_kernel<<<blocks, HS_QUAD_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)sd, (const uint8_t*)hd, (const int32_t*)base, (const int32_t*)table,
      (int32_t*)out, batch);
  return (int)cudaGetLastError();
}
