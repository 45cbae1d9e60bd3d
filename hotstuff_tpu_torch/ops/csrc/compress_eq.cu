// Kernel K4: compress the ladder's point and compare with R byte for byte.
//
// Replaces hotstuff_tpu/ops/ed25519.py:compress (:591-596) and the R
// compare of pallas_ladder.py:_verify_kernel_pallas (:160-161), jnp code
// that XLA runs after the Pallas ladder. One thread per lane: one field
// inversion (~265 multiplies), two canonical reductions, 32 byte compares.
// Byte equality with a canonical re-encoding also rejects non-canonical R
// (the strict, cofactorless equation).
// Bound: integer multiplies — 153 bytes in and 1 out per lane against
// ~270 field multiplies (~15k IMAD.WIDE products) per lane.
#include <cuda_runtime.h>

#include "curve.cuh"

#define HS_THREADS 32  // one warp per block: spreads a 4,096-lane chunk over 128 SMs

// xyzt: (4, 10, B) int32 extended point (T unused). r: (32, B) uint8 R bytes.
// valid: (B,) bool from K3. out: (B,) bool = valid && enc(point) == R.
__global__ void __launch_bounds__(HS_THREADS)
compress_eq_kernel(const int32_t* __restrict__ xyzt, const uint8_t* __restrict__ r,
                   const bool* __restrict__ valid, bool* __restrict__ out, int batch) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  const size_t coord = (size_t)HS_NL * batch;
  const fe X = load_fe(xyzt + 0 * coord + lane, batch);
  const fe Y = load_fe(xyzt + 1 * coord + lane, batch);
  const fe Z = load_fe(xyzt + 2 * coord + lane, batch);
  const fe zinv = fe_invert(Z);
  const fe x_c = fe_canonical(fe_mul(X, zinv));
  const fe y_c = fe_canonical(fe_mul(Y, zinv));
  uint8_t enc[32];
  fe_tobytes(y_c, enc);
  enc[31] |= (uint8_t)(fe_parity(x_c) << 7);
  bool eq = true;
#pragma unroll
  for (int j = 0; j < 32; j++) eq = eq && (enc[j] == r[(size_t)j * batch + lane]);
  out[lane] = valid[lane] && eq;
}

extern "C" int hs_compress_eq(const void* xyzt, const void* r, const void* valid, void* out,
                              int batch, void* stream) {
  const int blocks = (batch + HS_THREADS - 1) / HS_THREADS;
  compress_eq_kernel<<<blocks, HS_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)xyzt, (const uint8_t*)r, (const bool*)valid, (bool*)out, batch);
  return (int)cudaGetLastError();
}
