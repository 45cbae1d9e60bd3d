// Kernel K4: compress the ladder's point and compare with R byte for byte.
//
// Replaces hotstuff_tpu/ops/ed25519.py:compress (:591-596) and the R
// compare of pallas_ladder.py:_verify_kernel_pallas (:160-161), jnp code
// that XLA runs after the Pallas ladder. Per lane: one field inversion (254
// squarings, 11 multiplies), X/Z and Y/Z, two canonical reductions, 32 byte
// compares. Byte equality with a canonical re-encoding also rejects
// non-canonical R (the strict, cofactorless equation).
// Bound: integer multiplies — 153 bytes in and 1 out per lane against
// ~270 field multiplies (~15k IMAD.WIDE products) per lane.
//
// The inversion is one serial chain of ~265 field ops per lane, so the
// latency of one op sets the time. Each block of four warps takes 32
// lanes, and every field op is split over its four warps by product column
// (split_field.cuh): warp g computes column group g for the block's 32
// lanes, so each warp's chain holds 11-17 of a squaring's 55 products, and
// a 4,096-lane chunk puts four warps on each SM, one per scheduler. After
// the last multiply warp 0 alone reduces, encodes, compares and stores.
// The mask equals compress_eq_plain's at every lane; the limbs between
// differ from the ref10 chain's, their values mod p do not.
#include <cuda_runtime.h>

#include "split_field.cuh"

#define HS_K4_MIN_BLOCKS 4  // <= 128 registers a thread

template <int G>
__device__ __forceinline__ void compress_eq_body(split_area& area, const int32_t* __restrict__ xyzt,
                                                 const uint8_t* __restrict__ r,
                                                 const bool* __restrict__ valid,
                                                 bool* __restrict__ out, int lane, bool store,
                                                 int batch) {
  split_xchg x(area);
  const size_t coord = (size_t)HS_NL * batch;
  const fe zinv = split_invert<G>(x, load_fe(xyzt + 2 * coord + lane, batch));
  const fe xz = split_mul<G>(x, load_fe(xyzt + 0 * coord + lane, batch), zinv);
  const fe yz = split_mul<G>(x, load_fe(xyzt + 1 * coord + lane, batch), zinv);
  if (G != 0 || !store) return;
  const fe x_c = fe_canonical(xz);
  const fe y_c = fe_canonical(yz);
  uint8_t enc[32];
  fe_tobytes(y_c, enc);
  enc[31] |= (uint8_t)(fe_parity(x_c) << 7);
  bool eq = true;
#pragma unroll
  for (int j = 0; j < 32; j++) eq = eq && (enc[j] == r[(size_t)j * batch + lane]);
  out[lane] = valid[lane] && eq;
}

// xyzt: (4, 10, B) int32 extended point (T unused). r: (32, B) uint8 R bytes.
// valid: (B,) bool from K3. out: (B,) bool = valid && enc(point) == R.
__global__ void __launch_bounds__(HS_SPLIT_THREADS, HS_K4_MIN_BLOCKS)
compress_eq_kernel(const int32_t* __restrict__ xyzt, const uint8_t* __restrict__ r,
                   const bool* __restrict__ valid, bool* __restrict__ out, int batch) {
  __shared__ split_area area;
  const int want = blockIdx.x * 32 + (threadIdx.x & 31);
  const int lane = min(want, batch - 1);  // a tail lane computes on the last lane
  const bool store = want < batch;
  switch (threadIdx.x >> 5) {
    case 0: compress_eq_body<0>(area, xyzt, r, valid, out, lane, store, batch); break;
    case 1: compress_eq_body<1>(area, xyzt, r, valid, out, lane, store, batch); break;
    case 2: compress_eq_body<2>(area, xyzt, r, valid, out, lane, store, batch); break;
    default: compress_eq_body<3>(area, xyzt, r, valid, out, lane, store, batch); break;
  }
}

extern "C" int hs_compress_eq(const void* xyzt, const void* r, const void* valid, void* out,
                              int batch, void* stream) {
  const int blocks = (batch + 31) / 32;
  compress_eq_kernel<<<blocks, HS_SPLIT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)xyzt, (const uint8_t*)r, (const bool*)valid, (bool*)out, batch);
  return (int)cudaGetLastError();
}
