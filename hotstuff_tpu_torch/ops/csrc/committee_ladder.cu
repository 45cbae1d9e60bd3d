// Kernel K5: the committee ladder [s]B + [h](-A_v), A_v read by validator index.
//
// Replaces hotstuff_tpu/ops/ed25519.py:_verify_kernel_w4_committee (:412-451,
// jitted with its _packed96 / _packed96_dh wrappers at :634-636) up to the
// compress, which K4 does. The jnp kernel gathers each lane's affine -A
// window table out of the device-resident committee tables (`jnp.take`),
// then runs the 4-bit Straus ladder with one-hot masked sums. Here one
// thread verifies one signature, as in K1:
//   * the accumulator point (4 x 10 limbs) lives in registers;
//   * the shared k*B table (3 x 16 x 10 int32, 1.9 KB) is copied into shared
//     memory per block;
//   * the committee table stays in device memory, validator-major
//     ((N, 16, 3, 10) int32, built once per registration): a lane reads its
//     validator's entry for the h digit as 120 contiguous bytes, through the
//     read-only path. At 64 validators the table is 123 KB, which L1 and L2
//     hold; no per-lane table is built and no key is decompressed.
// Per group: four doublings (T only on the last), a mixed add of the k*B
// entry for the s digit, then a second MIXED add (the committee entries are
// affine) of the k*(-A_v) entry for the h digit, without T. Digit 0 picks row
// 0, the identity (1, 1, 0), which the unified formula absorbs: no
// data-dependent branch.
// A lane whose index is outside [0, N) reads the clamped validator's table
// (nothing outside it) and gets lane_valid = false; ops/committee.py:
// committee_ladder_plain clamps and masks the same way.
// Bound: integer multiplies, as for K1 — per lane one field multiply fewer
// per group than K1's cached add (6 against 7 without T), and no K3 before
// it; ~1.7 KB read per lane against ~2,100 field multiplies. Staging the
// table in shared memory (1,920 B per validator, so ~120 validators fit in
// 227 KB) and more than one warp per SM are later work.
#include <cuda_runtime.h>

#include "curve.cuh"

#define HS_LADDER_THREADS 32  // one warp per block: 4,096 lanes spread over 128 SMs
#define HS_ENTRY (3 * HS_NL)  // int32 per committee table entry (y+x, y-x, 2d*x*y)

// sd, hd: (64, B) uint8 digits, row d of significance 16^d.
// base: (3, 16, 10) int32 affine precomp of k*B.
// entries: (N, 16, 3, 10) int32 affine precomp of k*(-A_v); valid: (N,) bool.
// idx: (B,) int32 validator index per lane.
// out: (4, 10, B) int32 extended (X, Y, Z, T), T zeros. lane_valid: (B,) bool.
__global__ void __launch_bounds__(HS_LADDER_THREADS)
committee_ladder_kernel(const uint8_t* __restrict__ sd, const uint8_t* __restrict__ hd,
                        const int32_t* __restrict__ base, const int32_t* __restrict__ entries,
                        const bool* __restrict__ valid, const int32_t* __restrict__ idx,
                        int n_keys, int32_t* __restrict__ out, bool* __restrict__ lane_valid,
                        int batch) {
  __shared__ int32_t sbase[3 * 16 * HS_NL];
  for (int i = threadIdx.x; i < 3 * 16 * HS_NL; i += blockDim.x) sbase[i] = base[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;

  const int v = idx[lane];
  const int vc = v < 0 ? 0 : (v >= n_keys ? n_keys - 1 : v);
  lane_valid[lane] = v == vc && valid[vc];
  const int32_t* table = entries + (size_t)vc * 16 * HS_ENTRY;

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
    const int32_t* e = table + h * HS_ENTRY;
    acc = ge_madd<false>(acc, load_fe_ro(e), load_fe_ro(e + HS_NL), load_fe_ro(e + 2 * HS_NL));
  }
  store_fe(out + 0 * (size_t)HS_NL * batch + lane, batch, acc.X);
  store_fe(out + 1 * (size_t)HS_NL * batch + lane, batch, acc.Y);
  store_fe(out + 2 * (size_t)HS_NL * batch + lane, batch, acc.Z);
  store_fe(out + 3 * (size_t)HS_NL * batch + lane, batch, acc.T);
}

extern "C" int hs_committee_ladder(const void* sd, const void* hd, const void* base,
                                   const void* entries, const void* valid, const void* idx,
                                   void* out, void* lane_valid, int n_keys, int batch,
                                   void* stream) {
  const int blocks = (batch + HS_LADDER_THREADS - 1) / HS_LADDER_THREADS;
  committee_ladder_kernel<<<blocks, HS_LADDER_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)sd, (const uint8_t*)hd, (const int32_t*)base, (const int32_t*)entries,
      (const bool*)valid, (const int32_t*)idx, n_keys, (int32_t*)out, (bool*)lane_valid, batch);
  return (int)cudaGetLastError();
}
