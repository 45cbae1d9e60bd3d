// Kernels K2 and K2g: h = SHA-512(R || A || M) mod L as 64 ladder digits,
// and `hs_reduce_mod_l`, a test entry that runs K2's reduction alone.
//
// K2 replaces hotstuff_tpu/ops/sha512.py:h_digits_on_device (:448-450), jnp
// code that emulates 64-bit words as (hi, lo) uint32 pairs and reduces
// mod L with f32 limb folds. K2g replaces the committee path's
// `jnp.take(keys_u8, idx, axis=1)` + h_digits_on_device
// (hotstuff_tpu/ops/ed25519.py:480-489): each lane reads its key column from
// the committee's (32, N) key table by validator index, so no gathered
// (32, B) copy is made.
//
// Bound: integer operations. A lane moves 160 bytes and issues about 5 k
// instructions, nearly all of them on the serial chain of the hash. The
// design keeps that chain lean and takes everything else off it:
//   * bytes through shared memory: a block of HS_THREADS lanes loads its
//     (96, HS_THREADS) R, M, A tile with 16-byte loads (K2g: R and M only)
//     and each thread reads its own column from there; digits go to a
//     (64, HS_THREADS) tile and out with 16-byte stores. The vector path
//     needs every row start 16-byte aligned: B a multiple of 16 (the
//     bucketed widths) and aligned row pointers. Any other width takes a
//     byte-wide path into the same tiles, exact as well;
//   * K2g reads its key bytes by index through the read-only path
//     (`__ldg`): a committee table is 32 x N bytes (2 KB at 64 validators)
//     and stays in L1;
//   * the hash, one thread per lane (its 80 rounds are serial): one padded
//     SHA-512 block (the 96-byte message of a 32-byte digest), state and a
//     16-word schedule ring in registers, round constants as constexpr
//     literals so that K[t] + W[t] folds where W[t] is a padding constant;
//   * h mod L on radix-2^28 limbs held in 32-bit registers, each product
//     one 32x32->64 IMAD.WIDE with a literal constant: 2^252 = 2^(9 * 28)
//     is the start of limb 9 and 2^252 = -C (mod L), C = L - 2^252 < 2^125
//     (5 limbs), so three limb-aligned folds x_lo - x_hi * C (50, 25 and 5
//     products) and one conditional add of L give the canonical value.
//     ops/sha512.py:_reduce_stages runs the same steps on int64 tensors.
#include <cuda_runtime.h>

#include <cstdint>

constexpr int HS_THREADS = 128;  // lanes per block; 32 and 64 time no faster (PERF.md)
static_assert(HS_THREADS % 32 == 0 && HS_THREADS <= 256, "HS_THREADS: whole warps, 16-byte rows");

namespace {

constexpr int RADIX = 28;
constexpr int64_t MASK28 = (1 << RADIX) - 1;

// C = L - 2^252 in radix-2^28 limbs (ops/sha512.py C_LIMBS).
__device__ __forceinline__ constexpr int32_t c_limb(int j) {
  return j == 0 ? 0x0cf5d3ed : j == 1 ? 0x012631a5 : j == 2 ? 0x079cd658 : j == 3 ? 0x0f9dea2f : 0x14de;
}

// Columns -> limbs: limbs 0..N-2 into [0, 2^28), the top limb takes the
// signed rest (`>>` on int64 is arithmetic).
template <int N>
__device__ __forceinline__ void carry(int64_t (&col)[N], int32_t (&out)[N]) {
#pragma unroll
  for (int k = 0; k < N - 1; k++) {
    col[k + 1] += col[k] >> RADIX;
    out[k] = (int32_t)(col[k] & MASK28);
  }
  out[N - 1] = (int32_t)col[N - 1];
}

// e: a value < 2^512 as 8 little-endian 64-bit words. h: the 10 limbs of
// value mod L, canonical (limb 9 is bit 252). Column bounds, before each
// carry, with the carry in (ops/sha512.py:column_bounds; tests pin them
// below 2^63):
//   fold 1: x limbs in [0, 2^28), 5 products -x_i * C_j a column: < 2^58;
//           y = x_lo - x_hi * C in (-2^385, 2^252), top limb in [-2^21, 0];
//   fold 2: y limbs 9..13, same count of products: < 2^58;
//           z in [0, 2^252 + 2^258), z_hi = limb 9 in [0, 65];
//   fold 3: z_hi * C_j: < 2^35; w in (-2^132, 2^252), w_hi in {-1, 0};
//   w < 0: w + L = w_lo + C, in [0, L).
__device__ __forceinline__ void reduce_mod_l(const uint64_t (&e)[8], int32_t (&h)[10]) {
  int32_t x[19];
#pragma unroll
  for (int k = 0; k < 19; k++) {
    const int q = RADIX * k / 64, off = RADIX * k % 64;
    uint64_t v = e[q] >> off;
    if (off > 64 - RADIX && q + 1 < 8) v |= e[q + 1] << (64 - off);
    x[k] = (int32_t)(v & MASK28);
  }
  int64_t col[14];
#pragma unroll
  for (int k = 0; k < 14; k++) col[k] = k < 9 ? x[k] : 0;
#pragma unroll
  for (int i = 0; i < 10; i++)
#pragma unroll
    for (int j = 0; j < 5; j++) col[i + j] -= (int64_t)x[9 + i] * c_limb(j);
  int32_t y[14];
  carry(col, y);

  int64_t zc[10];
#pragma unroll
  for (int k = 0; k < 10; k++) zc[k] = k < 9 ? y[k] : 0;
#pragma unroll
  for (int i = 0; i < 5; i++)
#pragma unroll
    for (int j = 0; j < 5; j++) zc[i + j] -= (int64_t)y[9 + i] * c_limb(j);
  int32_t z[10];
  carry(zc, z);

  int64_t wc[10];
#pragma unroll
  for (int k = 0; k < 10; k++) wc[k] = k < 9 ? z[k] : 0;
#pragma unroll
  for (int j = 0; j < 5; j++) wc[j] -= (int64_t)z[9] * c_limb(j);
  int32_t w[10];
  carry(wc, w);

  int64_t hc[10];
#pragma unroll
  for (int k = 0; k < 10; k++) hc[k] = k < 9 ? w[k] : 0;
#pragma unroll
  for (int j = 0; j < 5; j++) hc[j] += w[9] & c_limb(j);  // w_hi = -1: add C
  carry(hc, h);
}

// Digit d (16^d) of the limbs: 7 per 28-bit limb, digit 63 = limb 9.
__device__ __forceinline__ uint8_t nibble(const int32_t (&h)[10], int d) {
  return d < 63 ? (uint8_t)((h[d / 7] >> (4 * (d % 7))) & 15) : (uint8_t)h[9];
}

__device__ __forceinline__ uint64_t rotr(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

__device__ __forceinline__ uint64_t bswap64(uint64_t d) {
  const uint32_t lo = __byte_perm((uint32_t)d, 0, 0x0123), hi = __byte_perm((uint32_t)(d >> 32), 0, 0x0123);
  return ((uint64_t)lo << 32) | hi;
}

// The 96-byte message as 12 big-endian words -> the digest as 8
// little-endian 64-bit words of the 512-bit integer (RFC 8032's
// digest-to-scalar convention).
__device__ __forceinline__ void sha512_96(uint64_t (&w)[16], uint64_t (&e)[8]) {
  constexpr uint64_t K[80] = {
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
  constexpr uint64_t H0[8] = {0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
                              0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
                              0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
  w[12] = 0x8000000000000000ULL;  // padding: 0x80 then zeros
  w[13] = 0;
  w[14] = 0;
  w[15] = 96 * 8;  // message length in bits
  uint64_t s[8];
#pragma unroll
  for (int i = 0; i < 8; i++) s[i] = H0[i];
#pragma unroll
  for (int t = 0; t < 80; t++) {
    if (t >= 16) {
      const uint64_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint64_t s0 = rotr(w15, 1) ^ rotr(w15, 8) ^ (w15 >> 7);
      const uint64_t s1 = rotr(w2, 19) ^ rotr(w2, 61) ^ (w2 >> 6);
      w[t & 15] += s0 + w[(t - 7) & 15] + s1;
    }
    const uint64_t e_ = s[4], a_ = s[0];
    const uint64_t S1 = rotr(e_, 14) ^ rotr(e_, 18) ^ rotr(e_, 41);
    const uint64_t ch = (e_ & s[5]) ^ (~e_ & s[6]);
    const uint64_t t1 = s[7] + S1 + ch + (K[t] + w[t & 15]);
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
#pragma unroll
  for (int i = 0; i < 8; i++) e[i] = bswap64(s[i] + H0[i]);
}

// Tile rows: 0..31 R, 32..63 M, 64..95 A (K2 only; K2g reads A by index).
template <bool GATHER>
__device__ __forceinline__ const uint8_t* tile_src(int row, const uint8_t* r, const uint8_t* m,
                                                   const uint8_t* a) {
  return row < 32 ? r : (row < 64 || GATHER ? m : a);
}

// K2 (GATHER false): r, a, m (32, B) uint8 rows. K2g (GATHER true): a is
// the (32, N) committee key table and idx the (B,) validator index per
// lane; a lane whose index lies outside [0, N) reads no key and gets
// all-zero digits (ops/sha512.py:h_digits_gather_plain masks it the same
// way). out: (64, B) uint8 digits of h mod L, row d = 16^d.
template <bool GATHER>
__global__ void __launch_bounds__(HS_THREADS)
h_digits_kernel(const uint8_t* __restrict__ r, const uint8_t* __restrict__ a,
                const int32_t* __restrict__ idx, const uint8_t* __restrict__ m,
                uint8_t* __restrict__ out, int n_keys, int batch) {
  constexpr int ROWS = GATHER ? 64 : 96;
  constexpr int VPR = HS_THREADS / 16;  // 16-byte vectors in a tile row
  constexpr int RPP = HS_THREADS / VPR;  // tile rows a pass covers: 16
  __shared__ __align__(16) uint8_t tin[ROWS][HS_THREADS];
  __shared__ __align__(16) uint8_t tout[64][HS_THREADS];
  const int t = threadIdx.x;
  const int l0 = blockIdx.x * HS_THREADS;
  const int lane = l0 + t;
  const int width = min(HS_THREADS, batch - l0);
  const uintptr_t bits = (uintptr_t)r | (uintptr_t)m | (GATHER ? 0 : (uintptr_t)a) | (uintptr_t)out |
                         (uintptr_t)batch;
  const bool wide = (bits & 15) == 0;  // width is then a multiple of 16 too
  const int vc = 16 * (t % VPR);

  if (wide) {
    if (vc < width) {
#pragma unroll
      for (int p = 0; p < ROWS / RPP; p++) {
        const int row = p * RPP + t / VPR;
        const uint8_t* src = tile_src<GATHER>(row, r, m, a) + (size_t)(row % 32) * batch + l0 + vc;
        *reinterpret_cast<uint4*>(&tin[row][vc]) = *reinterpret_cast<const uint4*>(src);
      }
    }
  } else if (t < width) {
#pragma unroll 8
    for (int row = 0; row < ROWS; row++)
      tin[row][t] = tile_src<GATHER>(row, r, m, a)[(size_t)(row % 32) * batch + lane];
  }
  __syncthreads();

  if (t < width) {
    const int v = GATHER ? idx[lane] : 0;
    if (!GATHER || (v >= 0 && v < n_keys)) {
      uint64_t w[16];
#pragma unroll
      for (int j = 0; j < 12; j++) {
        uint64_t word = 0;
#pragma unroll
        for (int k = 0; k < 8; k++) {
          const int row = 8 * (j % 4) + k;  // byte row of R, A or M
          uint8_t b;
          if (j < 4)
            b = tin[row][t];
          else if (j >= 8)
            b = tin[32 + row][t];
          else if (GATHER)
            b = __ldg(a + (size_t)row * n_keys + v);
          else
            b = tin[64 + row][t];
          word = (word << 8) | b;
        }
        w[j] = word;
      }
      uint64_t e[8];
      sha512_96(w, e);
      int32_t h[10];
      reduce_mod_l(e, h);
#pragma unroll
      for (int d = 0; d < 64; d++) tout[d][t] = nibble(h, d);
    } else {
#pragma unroll
      for (int d = 0; d < 64; d++) tout[d][t] = 0;
    }
  }
  __syncthreads();

  if (wide) {
    if (vc < width) {
#pragma unroll
      for (int p = 0; p < 64 / RPP; p++) {
        const int row = p * RPP + t / VPR;
        *reinterpret_cast<uint4*>(out + (size_t)row * batch + l0 + vc) =
            *reinterpret_cast<const uint4*>(&tout[row][vc]);
      }
    }
  } else if (t < width) {
#pragma unroll 8
    for (int d = 0; d < 64; d++) out[(size_t)d * batch + lane] = tout[d][t];
  }
}

// Test entry: x (64, B) uint8 little-endian values < 2^512 -> out (32, B)
// uint8 bytes of value mod L, through K2's own reduce_mod_l.
__global__ void __launch_bounds__(128)
reduce_mod_l_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int batch) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  uint64_t e[8];
#pragma unroll
  for (int q = 0; q < 8; q++) {
    uint64_t word = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) word |= (uint64_t)x[(size_t)(8 * q + k) * batch + lane] << (8 * k);
    e[q] = word;
  }
  int32_t h[10];
  reduce_mod_l(e, h);
#pragma unroll
  for (int b = 0; b < 32; b++)
    out[(size_t)b * batch + lane] = (uint8_t)(nibble(h, 2 * b) | (nibble(h, 2 * b + 1) << 4));
}

int blocks_of(int batch, int threads) { return (batch + threads - 1) / threads; }

}  // namespace

extern "C" int hs_h_digits(const void* r, const void* a, const void* m, void* out, int batch,
                           void* stream) {
  h_digits_kernel<false><<<blocks_of(batch, HS_THREADS), HS_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)r, (const uint8_t*)a, nullptr, (const uint8_t*)m, (uint8_t*)out, 0, batch);
  return (int)cudaGetLastError();
}

extern "C" int hs_h_digits_idx(const void* r, const void* keys, const void* idx, const void* m,
                               void* out, int n_keys, int batch, void* stream) {
  h_digits_kernel<true><<<blocks_of(batch, HS_THREADS), HS_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)r, (const uint8_t*)keys, (const int32_t*)idx, (const uint8_t*)m, (uint8_t*)out,
      n_keys, batch);
  return (int)cudaGetLastError();
}

extern "C" int hs_reduce_mod_l(const void* x, void* out, int batch, void* stream) {
  reduce_mod_l_kernel<<<blocks_of(batch, 128), 128, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (uint8_t*)out, batch);
  return (int)cudaGetLastError();
}
