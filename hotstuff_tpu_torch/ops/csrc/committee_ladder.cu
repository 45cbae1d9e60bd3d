// Kernel K5: the committee ladder [s]B + [h](-A_v), A_v read by validator index.
//
// Replaces hotstuff_tpu/ops/ed25519.py:_verify_kernel_w4_committee (:412-451,
// jitted with its _packed96 / _packed96_dh wrappers at :634-636) up to the
// compress, which K4 does. The jnp kernel gathers each lane's affine -A
// window table out of the device-resident committee tables (`jnp.take`),
// then runs the 4-bit Straus ladder with one-hot masked sums. Here four
// threads verify one signature, as in K1 (quad.cuh):
//   * thread k of the quad keeps coordinate k of the accumulator in
//     registers; the quad exchanges products through shared memory between
//     multiply stages;
//   * the shared k*B table (3 x 16 x 10 int32, 1.9 KB) is copied into shared
//     memory per block;
//   * the committee table stays in device memory, validator-major
//     ((N, 16, 3, 10) int32, built once per registration): threads 0-2 of a
//     quad each read one coordinate of the validator's entry for the h digit
//     (40 contiguous bytes, through the read-only path), one group ahead. At
//     64 validators the table is 123 KB, which L1 and L2 hold; no per-lane
//     table is built and no key is decompressed.
// Per group: four doublings, a mixed add of the k*B entry for the s digit,
// then a second MIXED add (the committee entries are affine) of the
// k*(-A_v) entry for the h digit. Digit 0 picks row 0, the identity
// (1, 1, 0), which the unified formula absorbs: no data-dependent branch.
// A lane whose index is outside [0, N) reads the clamped validator's table
// (nothing outside it) and gets lane_valid = false; ops/committee.py:
// committee_ladder_plain clamps and masks the same way.
// Bound: integer multiplies, as for K1 — per lane one field multiply fewer
// per group than K1's cached add, and no K3 before it; ~1.7 KB read per
// lane against ~2,200 field multiplies. Staging the table in shared memory
// (1,920 B per validator, so ~110 validators fit in 227 KB) is later work.
#include <cuda_runtime.h>

#include "quad.cuh"

#define HS_ENTRY (3 * HS_NL)  // int32 per committee table entry (y+x, y-x, 2d*x*y)

// One validator's affine entries; thread 3 reads coordinate 2 and
// discards its product.
struct affine_item {
  static constexpr bool CACHED = false;
  const int32_t* e;  // the validator's table + this thread's coordinate
  __device__ __forceinline__ fe load(int h) const { return load_fe_ro(e + h * HS_ENTRY); }
};

// sd, hd: (64, B) uint8 digits, row d of significance 16^d.
// base: (3, 16, 10) int32 affine precomp of k*B.
// entries: (N, 16, 3, 10) int32 affine precomp of k*(-A_v); valid: (N,) bool.
// idx: (B,) int32 validator index per lane.
// out: (4, 10, B) int32 extended (X, Y, Z, T), T zeros. lane_valid: (B,) bool.
// At least 21 blocks per SM: 65,536 / (21 x 32), at most 96 registers per
// thread (K1's looser cap cost this kernel time, PERF.md section 6).
__global__ void __launch_bounds__(HS_QUAD_THREADS, 21)
committee_ladder_kernel(const uint8_t* __restrict__ sd, const uint8_t* __restrict__ hd,
                        const int32_t* __restrict__ base, const int32_t* __restrict__ entries,
                        const bool* __restrict__ valid, const int32_t* __restrict__ idx,
                        int n_keys, int32_t* __restrict__ out, bool* __restrict__ lane_valid,
                        int batch) {
  __shared__ int32_t sbase[3 * 16 * HS_NL];
  __shared__ __align__(16) int32_t xslots[HS_QUAD_THREADS * HS_SLOT];
  for (int i = threadIdx.x; i < 3 * 16 * HS_NL; i += blockDim.x) sbase[i] = base[i];
  __syncthreads();
  const quad_pos q = quad_here();
  const int want = blockIdx.x * HS_QUAD_LANES + threadIdx.x / 4;
  const int lane = want < batch ? want : batch - 1;  // a tail quad computes, stores nothing

  const int v = idx[lane];
  const int vc = v < 0 ? 0 : (v >= n_keys ? n_keys - 1 : v);
  if (want < batch && q.k == 0) lane_valid[lane] = v == vc && valid[vc];
  const affine_item item{entries + (size_t)vc * 16 * HS_ENTRY + quad_affine_coord(q) * HS_NL};
  const fe c = quad_ladder(q, xslots, sbase, sd, hd, lane, batch, item);
  if (want < batch) quad_store(q, out, lane, batch, c);
}

extern "C" int hs_committee_ladder(const void* sd, const void* hd, const void* base,
                                   const void* entries, const void* valid, const void* idx,
                                   void* out, void* lane_valid, int n_keys, int batch,
                                   void* stream) {
  const int blocks = (batch + HS_QUAD_LANES - 1) / HS_QUAD_LANES;
  committee_ladder_kernel<<<blocks, HS_QUAD_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)sd, (const uint8_t*)hd, (const int32_t*)base, (const int32_t*)entries,
      (const bool*)valid, (const int32_t*)idx, n_keys, (int32_t*)out, (bool*)lane_valid, batch);
  return (int)cudaGetLastError();
}
