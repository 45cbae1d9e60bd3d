// Kernels K2 and K2g: h = SHA-512(R || A || M) mod L as 64 ladder digits.
//
// K2 replaces hotstuff_tpu/ops/sha512.py:h_digits_on_device (:448-450), jnp
// code that emulates 64-bit words as (hi, lo) uint32 pairs and reduces
// mod L with f32 limb folds. K2g replaces the committee path's
// `jnp.take(keys_u8, idx, axis=1)` + h_digits_on_device
// (hotstuff_tpu/ops/ed25519.py:480-489): each lane reads its key column from
// the committee's (32, N) key table by validator index, so no gathered
// (32, B) copy is made. One thread per lane, native uint64_t words:
//   * one padded SHA-512 block (the 96-byte message of a 32-byte digest),
//     the message schedule in a 16-word ring held in registers;
//   * TweetNaCl's modL on 64 signed byte limbs, exact for any 512-bit value
//     (the algorithm of ops/sha512.py:reduce_mod_l);
//   * 4-bit digits out, row 2k = low nibble of byte k.
// Bound: integer operations — 96 bytes in and 64 out per lane against ~80
// rounds x ~60 64-bit ops and 32 x 20 multiply-adds for the reduction.
#include <cuda_runtime.h>

#include <cstdint>

#define HS_THREADS 128

__constant__ uint64_t K512[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL, 0xe9b5dba58189dbbcULL,
    0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL, 0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL,
    0xd807aa98a3030242ULL, 0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL, 0xc19bf174cf692694ULL,
    0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL, 0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL,
    0x2de92c6f592b0275ULL, 0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL, 0xbf597fc7beef0ee4ULL,
    0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL, 0x06ca6351e003826fULL, 0x142929670a0e6e70ULL,
    0x27b70a8546d22ffcULL, 0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL, 0x92722c851482353bULL,
    0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL, 0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL,
    0xd192e819d6ef5218ULL, 0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL, 0x34b0bcb5e19b48a8ULL,
    0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL, 0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL,
    0x748f82ee5defb2fcULL, 0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL, 0xc67178f2e372532bULL,
    0xca273eceea26619cULL, 0xd186b8c721c0c207ULL, 0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL,
    0x06f067aa72176fbaULL, 0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL, 0x431d67c49c100d4cULL,
    0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL, 0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL};

// Little-endian bytes of L = 2^252 + 27742317777372353535851937790883648493.
__constant__ int64_t L_BYTES[32] = {0xed, 0xd3, 0xf5, 0x5c, 0x1a, 0x63, 0x12, 0x58,
                                    0xd6, 0x9c, 0xf7, 0xa2, 0xde, 0xf9, 0xde, 0x14,
                                    0,    0,    0,    0,    0,    0,    0,    0,
                                    0,    0,    0,    0,    0,    0,    0,    0x10};

__device__ __forceinline__ uint64_t rotr(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

// One lane: r, m and out point at the lane's column of (rows, B) arrays
// (row stride `batch`); a points at the key's column of a (32, cols) array
// (row stride `a_stride`: B for the per-lane key rows of K2, N for the
// committee's key table of K2g).
__device__ __forceinline__ void h_digits_lane(const uint8_t* __restrict__ r,
                                              const uint8_t* __restrict__ a, int a_stride,
                                              const uint8_t* __restrict__ m,
                                              uint8_t* __restrict__ out, int batch) {
  uint64_t w[16];
#pragma unroll
  for (int j = 0; j < 12; j++) {
    const uint8_t* src = j < 4 ? r : (j < 8 ? a : m);
    const size_t stride = j < 4 || j >= 8 ? batch : a_stride;
    const int base = 8 * (j % 4);
    uint64_t word = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) word = (word << 8) | src[(base + k) * stride];
    w[j] = word;
  }
  w[12] = 0x8000000000000000ULL;  // padding: 0x80 then zeros
  w[13] = 0;
  w[14] = 0;
  w[15] = 96 * 8;  // message length in bits

  const uint64_t h0[8] = {0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
                          0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
                          0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
  uint64_t s[8];
#pragma unroll
  for (int i = 0; i < 8; i++) s[i] = h0[i];
#pragma unroll
  for (int t = 0; t < 80; t++) {
    if (t >= 16) {
      const uint64_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint64_t s0 = rotr(w15, 1) ^ rotr(w15, 8) ^ (w15 >> 7);
      const uint64_t s1 = rotr(w2, 19) ^ rotr(w2, 61) ^ (w2 >> 6);
      w[t & 15] += s0 + w[(t - 7) & 15] + s1;
    }
    const uint64_t e = s[4], a_ = s[0];
    const uint64_t S1 = rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41);
    const uint64_t ch = (e & s[5]) ^ (~e & s[6]);
    const uint64_t t1 = s[7] + S1 + ch + K512[t] + w[t & 15];
    const uint64_t S0 = rotr(a_, 28) ^ rotr(a_, 34) ^ rotr(a_, 39);
    const uint64_t maj = (a_ & s[1]) ^ (a_ & s[2]) ^ (s[1] & s[2]);
    s[7] = s[6];
    s[6] = s[5];
    s[5] = s[4];
    s[4] = s[3] + t1;
    s[3] = s[2];
    s[2] = s[1];
    s[1] = s[0];
    s[0] = t1 + S0 + maj;
  }

  // Digest bytes, big-endian per word, as a little-endian 512-bit integer.
  int64_t x[64];
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint64_t d = s[i] + h0[i];
#pragma unroll
    for (int k = 0; k < 8; k++) x[8 * i + k] = (int64_t)((d >> (56 - 8 * k)) & 0xFF);
  }

  // TweetNaCl modL: fold bytes 63..32 down with 2^256 = -16C (mod L).
#pragma unroll
  for (int i = 63; i >= 32; i--) {
    int64_t carry = 0;
#pragma unroll
    for (int j = i - 32; j < i - 12; j++) {
      x[j] += carry - 16 * x[i] * L_BYTES[j - (i - 32)];
      carry = (x[j] + 128) >> 8;
      x[j] -= carry * 256;
    }
    x[i - 12] += carry;
    x[i] = 0;
  }
  int64_t carry = 0;
#pragma unroll
  for (int j = 0; j < 32; j++) {
    x[j] += carry - (x[31] >> 4) * L_BYTES[j];
    carry = x[j] >> 8;
    x[j] &= 255;
  }
#pragma unroll
  for (int j = 0; j < 32; j++) x[j] -= carry * L_BYTES[j];
#pragma unroll
  for (int i = 0; i < 32; i++) {
    x[i + 1] += x[i] >> 8;
    const int byte = (int)(x[i] & 255);
    out[(size_t)(2 * i) * batch] = (uint8_t)(byte & 15);
    out[(size_t)(2 * i + 1) * batch] = (uint8_t)(byte >> 4);
  }
}

// K2. r, a, m: (32, B) uint8 rows. out: (64, B) uint8 digits of h mod L.
__global__ void __launch_bounds__(HS_THREADS)
h_digits_kernel(const uint8_t* __restrict__ r, const uint8_t* __restrict__ a,
                const uint8_t* __restrict__ m, uint8_t* __restrict__ out, int batch) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  h_digits_lane(r + lane, a + lane, batch, m + lane, out + lane, batch);
}

// K2g. keys: (32, N) uint8 committee keys; idx: (B,) int32 validator index
// per lane. A lane whose index is outside [0, N) reads no key and gets
// all-zero digits (ops/sha512.py:h_digits_gather_plain masks it the same way).
__global__ void __launch_bounds__(HS_THREADS)
h_digits_idx_kernel(const uint8_t* __restrict__ r, const uint8_t* __restrict__ keys,
                    const int32_t* __restrict__ idx, const uint8_t* __restrict__ m,
                    uint8_t* __restrict__ out, int n_keys, int batch) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  const int v = idx[lane];
  if (v < 0 || v >= n_keys) {
#pragma unroll
    for (int i = 0; i < 64; i++) out[(size_t)i * batch + lane] = 0;
    return;
  }
  h_digits_lane(r + lane, keys + v, n_keys, m + lane, out + lane, batch);
}

extern "C" int hs_h_digits(const void* r, const void* a, const void* m, void* out, int batch,
                           void* stream) {
  const int blocks = (batch + HS_THREADS - 1) / HS_THREADS;
  h_digits_kernel<<<blocks, HS_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)r, (const uint8_t*)a, (const uint8_t*)m, (uint8_t*)out, batch);
  return (int)cudaGetLastError();
}

extern "C" int hs_h_digits_idx(const void* r, const void* keys, const void* idx, const void* m,
                               void* out, int n_keys, int batch, void* stream) {
  const int blocks = (batch + HS_THREADS - 1) / HS_THREADS;
  h_digits_idx_kernel<<<blocks, HS_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)r, (const uint8_t*)keys, (const int32_t*)idx, (const uint8_t*)m,
      (uint8_t*)out, n_keys, batch);
  return (int)cudaGetLastError();
}
