// Native staging plane of the PyTorch/CUDA port: the host side of a chunk.
//
// Each entry point writes a chunk's uint8 wire array straight into a
// caller-owned shard-major buffer (shards, rows, width / shards), the
// layout the verifier uploads (`ops/verifier.py`, `fill_shards`): lane b
// sits in shard b / w at column b % w, w = width / shards. Lanes [n, width)
// are zeroed (the buffer comes from a pool and holds an older chunk), and
// s_ok[b] is 1 when lane b's scalar s is below the group order L. Every row
// group is 32 bytes of one lane:
//
//   hs_stage_packed_hh     128 rows: A, R, S, h = SHA-512(R || A || M) mod L
//   hs_stage_packed_dh     128 rows: A, R, S, M (32-byte messages)
//   hs_stage_committee_hh   96 rows: R, S, h (the keys only feed the hash)
//   hs_stage_committee_dh   96 rows: R, S, M (32-byte messages)
//
// Messages of any length come as one blob with n + 1 int64 offsets. Keys
// are n x 32 bytes, signatures n x 64 (R then S). A plain C interface: no
// CPython API, so a ctypes call runs without the interpreter lock. Returns
// 0, or 1 when the sizes are inconsistent (nothing is written then).
//
// SHA-512 is FIPS 180-4. The reduction mod L folds at bit 252 three times
// (2^252 = -c mod L), each round adding a multiple of L that keeps every
// intermediate non-negative, then subtracts L at most a few times. Held
// byte for byte against hashlib and Python integers by
// tests/test_torch_native_staging.py.

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;

namespace {

// ---------------------------------------------------------------------------
// Constants: SHA-512's initial hash value and round constants (FIPS 180-4
// section 5.3.5 and 4.2.3); the group order L = 2^252 + c.
// ---------------------------------------------------------------------------

const uint64_t SHA512_H0[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
    0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL, 0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
};

const uint64_t SHA512_K[80] = {
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
    0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL, 0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL,
};

// L = 2^252 + 27742317777372353535851937790883648493, little-endian limbs.
const uint64_t L_LIMBS[4] = {
    0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL, 0x0000000000000000ULL, 0x1000000000000000ULL,
};

// c = L - 2^252, two limbs.
const uint64_t C_LIMBS[2] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL};

// MBIAS[r]: the multiple of L added in fold round r, larger than that
// round's largest hi * c (hi < 2^260, 2^135 and 2^9), 7 limbs.
const uint64_t MBIAS[3][7] = {
    {0x0000000000000000ULL, 0x0000000000000000ULL, 0x0498c6973d74fb40ULL, 0x37be77a8bde73596ULL,
     0x0000000000000005ULL, 0x0000000000000000ULL, 0x0000000000000004ULL},
    {0x12631a5cf5d3ed00ULL, 0xdef9dea2f79cd658ULL, 0x0000000000000014ULL, 0x0000000000000000ULL,
     0x0000000000000010ULL, 0x0000000000000000ULL, 0x0000000000000000ULL},
    {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL, 0x0000000000000000ULL, 0x1000000000000000ULL,
     0x0000000000000000ULL, 0x0000000000000000ULL, 0x0000000000000000ULL},
};

// ---------------------------------------------------------------------------
// SHA-512
// ---------------------------------------------------------------------------

inline uint64_t rotr(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

void sha512_compress(uint64_t st[8], const uint8_t *block) {
  uint64_t w[80];
  for (int i = 0; i < 16; i++) {
    w[i] = 0;
    for (int j = 0; j < 8; j++) w[i] = (w[i] << 8) | block[8 * i + j];
  }
  for (int i = 16; i < 80; i++) {
    uint64_t s0 = rotr(w[i - 15], 1) ^ rotr(w[i - 15], 8) ^ (w[i - 15] >> 7);
    uint64_t s1 = rotr(w[i - 2], 19) ^ rotr(w[i - 2], 61) ^ (w[i - 2] >> 6);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint64_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint64_t e = st[4], f = st[5], g = st[6], h = st[7];
  for (int i = 0; i < 80; i++) {
    uint64_t S1 = rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41);
    uint64_t ch = (e & f) ^ (~e & g);
    uint64_t t1 = h + S1 + ch + SHA512_K[i] + w[i];
    uint64_t S0 = rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39);
    uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint64_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// SHA-512 of the concatenation of `nparts` byte strings.
void sha512(const uint8_t *const parts[], const size_t lens[], int nparts, uint8_t out[64]) {
  uint64_t st[8];
  memcpy(st, SHA512_H0, sizeof(st));
  uint8_t buf[128];
  size_t fill = 0;
  uint64_t total = 0;
  for (int p = 0; p < nparts; p++) {
    const uint8_t *data = parts[p];
    size_t len = lens[p];
    total += len;
    while (len > 0) {
      size_t take = 128 - fill;
      if (take > len) take = len;
      memcpy(buf + fill, data, take);
      fill += take; data += take; len -= take;
      if (fill == 128) { sha512_compress(st, buf); fill = 0; }
    }
  }
  // Padding: 0x80, zeros, the 128-bit big-endian bit length (its high 64
  // bits are 0: no message here reaches 2^64 bits).
  buf[fill++] = 0x80;
  if (fill > 112) {
    memset(buf + fill, 0, 128 - fill);
    sha512_compress(st, buf);
    fill = 0;
  }
  memset(buf + fill, 0, 120 - fill);
  uint64_t bits = total * 8;
  for (int i = 0; i < 8; i++) buf[127 - i] = (uint8_t)(bits >> (8 * i));
  sha512_compress(st, buf);
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++) out[8 * i + j] = (uint8_t)(st[i] >> (56 - 8 * j));
}

// ---------------------------------------------------------------------------
// Scalars mod L (little-endian 64-bit limbs, 512-bit working width)
// ---------------------------------------------------------------------------

const int NL = 8;

bool ge_l(const uint64_t x[NL]) {
  for (int i = NL - 1; i >= 4; i--)
    if (x[i]) return true;
  for (int i = 3; i >= 0; i--) {
    if (x[i] > L_LIMBS[i]) return true;
    if (x[i] < L_LIMBS[i]) return false;
  }
  return true;  // equal
}

void sub_l(uint64_t x[NL]) {
  uint64_t borrow = 0;
  for (int i = 0; i < NL; i++) {
    uint64_t li = (i < 4) ? L_LIMBS[i] : 0;
    u128 t = (u128)x[i] - li - borrow;
    x[i] = (uint64_t)t;
    borrow = (t >> 64) ? 1 : 0;
  }
}

// 64-byte little-endian value -> value mod L, 32 little-endian bytes.
// Three rounds of x = hi 2^252 + lo -> lo + MBIAS[r] - hi c: sizes 2^512 ->
// < 2^387 -> < 2^261 -> < 2^254, then at most three subtractions of L.
void reduce_mod_l(const uint8_t in[64], uint8_t out[32]) {
  uint64_t x[NL];
  for (int i = 0; i < NL; i++) {
    uint64_t v = 0;
    for (int j = 7; j >= 0; j--) v = (v << 8) | in[8 * i + j];
    x[i] = v;
  }
  for (int round = 0; round < 3; round++) {
    uint64_t hi[5];  // x >> 252
    for (int i = 0; i < 5; i++) {
      uint64_t lo64 = (i + 3 < NL) ? x[i + 3] : 0;
      uint64_t hi64 = (i + 4 < NL) ? x[i + 4] : 0;
      hi[i] = (lo64 >> 60) | (hi64 << 4);
    }
    uint64_t acc[NL] = {x[0], x[1], x[2], x[3] & 0x0FFFFFFFFFFFFFFFULL, 0, 0, 0, 0};
    u128 carry = 0;
    for (int i = 0; i < NL; i++) {
      u128 t = (u128)acc[i] + (i < 7 ? MBIAS[round][i] : 0) + carry;
      acc[i] = (uint64_t)t;
      carry = t >> 64;
    }
    uint64_t prod[NL] = {0};  // hi * c
    for (int i = 0; i < 5; i++) {
      u128 c2 = 0;
      for (int j = 0; j < 2; j++) {
        u128 t = (u128)hi[i] * C_LIMBS[j] + prod[i + j] + c2;
        prod[i + j] = (uint64_t)t;
        c2 = t >> 64;
      }
      for (int k = i + 2; k < NL && c2; k++) {
        u128 t = (u128)prod[k] + c2;
        prod[k] = (uint64_t)t;
        c2 = t >> 64;
      }
    }
    uint64_t borrow = 0;
    for (int i = 0; i < NL; i++) {
      u128 t = (u128)acc[i] - prod[i] - borrow;
      x[i] = (uint64_t)t;
      borrow = (t >> 64) ? 1 : 0;
    }
  }
  while (ge_l(x)) sub_l(x);
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 8; j++) out[8 * i + j] = (uint8_t)(x[i] >> (8 * j));
}

// s (32 little-endian bytes) < L.
bool lt_l(const uint8_t s[32]) {
  uint64_t x[NL] = {0};
  for (int i = 0; i < 4; i++) {
    uint64_t v = 0;
    for (int j = 7; j >= 0; j--) v = (v << 8) | s[8 * i + j];
    x[i] = v;
  }
  return !ge_l(x);
}

// ---------------------------------------------------------------------------
// Staging into the shard-major buffer
// ---------------------------------------------------------------------------

// Lanes per block: a block's 32-byte inputs (a few KB) and its 128 output
// rows of BLOCK bytes stay in the L1 cache while they are transposed.
const int64_t BLOCK = 64;

// Swap the bit fields `mask << s` of a with `mask` of b.
inline void swap_fields(uint64_t &a, uint64_t &b, int s, uint64_t mask) {
  const uint64_t t = ((a >> s) ^ b) & mask;
  b ^= t;
  a ^= t << s;
}

// 8 x 8 byte transpose: byte k of x[i] becomes byte i of x[k] (4 x 4, then
// 2 x 2, then 1 x 1 blocks swapped across the diagonal).
inline void transpose8(uint64_t x[8]) {
  for (int i = 0; i < 4; i++) swap_fields(x[i], x[i + 4], 32, 0x00000000FFFFFFFFULL);
  for (int i = 0; i < 8; i += (i & 1) ? 3 : 1) swap_fields(x[i], x[i + 2], 16, 0x0000FFFF0000FFFFULL);
  for (int i = 0; i < 8; i += 2) swap_fields(x[i], x[i + 1], 8, 0x00FF00FF00FF00FFULL);
}

// One 32-row group of `m` lanes: lane j's 32 bytes at src + j * stride go
// to column j of rows 0..31 of dst, whose rows are w bytes apart. Eight
// lanes at a time move as 8 x 8 byte tiles in 64-bit words (the host is
// little-endian: byte k of a loaded word is the k-th byte in memory).
void put_rows(uint8_t *dst, int64_t w, const uint8_t *src, int64_t stride, int64_t m) {
  int64_t j = 0;
  for (; j + 8 <= m; j += 8) {
    for (int q = 0; q < 4; q++) {
      uint64_t x[8];
      for (int i = 0; i < 8; i++) memcpy(&x[i], src + (j + i) * stride + 8 * q, 8);
      transpose8(x);
      for (int k = 0; k < 8; k++) memcpy(dst + (8 * q + k) * w + j, &x[k], 8);
    }
  }
  for (; j < m; j++)
    for (int r = 0; r < 32; r++) dst[r * w + j] = src[j * stride + r];
}

// A wire layout: `ngroups` row groups; group g of lane b is 32 bytes at
// src[g] + b * stride[g], or, where src[g] is null, the hash h of lane b.
struct Layout {
  int ngroups;
  const uint8_t *src[4];
  int64_t stride[4];
};

// The body every entry shares. `keys` and `msgs` / `offsets` feed the hash
// (unused when no group is the hash); `sigs` gives R and S.
int stage(const Layout &lay, const uint8_t *msgs, const int64_t *offsets, const uint8_t *keys,
          const uint8_t *sigs, int64_t n, uint8_t *out, int64_t width, int64_t shards, uint8_t *s_ok) {
  if (n < 0 || shards < 1 || width < n || width % shards != 0) return 1;
  const int64_t w = width / shards;
  const int64_t rows = 32 * lay.ngroups;
  bool hashed = false;
  for (int g = 0; g < lay.ngroups; g++) hashed |= lay.src[g] == nullptr;
  uint8_t h[BLOCK * 32];
  for (int64_t b0 = 0; b0 < n;) {
    const int64_t shard = b0 / w, col = b0 % w;
    int64_t m = w - col;
    if (m > n - b0) m = n - b0;
    if (m > BLOCK) m = BLOCK;
    for (int64_t j = 0; j < m; j++) {
      const int64_t b = b0 + j;
      s_ok[b] = lt_l(sigs + 64 * b + 32) ? 1 : 0;
      if (hashed) {
        const uint8_t *parts[3] = {sigs + 64 * b, keys + 32 * b, msgs + offsets[b]};
        const size_t lens[3] = {32, 32, (size_t)(offsets[b + 1] - offsets[b])};
        uint8_t digest[64];
        sha512(parts, lens, 3, digest);
        reduce_mod_l(digest, h + 32 * j);
      }
    }
    uint8_t *dst = out + shard * rows * w + col;
    for (int g = 0; g < lay.ngroups; g++) {
      if (lay.src[g] == nullptr)
        put_rows(dst + 32 * g * w, w, h, 32, m);
      else
        put_rows(dst + 32 * g * w, w, lay.src[g] + b0 * lay.stride[g], lay.stride[g], m);
    }
    b0 += m;
  }
  for (int64_t shard = 0; shard < shards; shard++) {  // pad lanes [n, width)
    int64_t lo = n - shard * w;
    if (lo < 0) lo = 0;
    if (lo >= w) continue;
    for (int64_t r = 0; r < rows; r++) memset(out + (shard * rows + r) * w + lo, 0, w - lo);
  }
  return 0;
}

}  // namespace

extern "C" {

int hs_stage_packed_hh(const uint8_t *msgs, const int64_t *offsets, const uint8_t *keys,
                       const uint8_t *sigs, int64_t n, uint8_t *out, int64_t width, int64_t shards,
                       uint8_t *s_ok) {
  const Layout lay = {4, {keys, sigs, sigs + 32, nullptr}, {32, 64, 64, 0}};
  return stage(lay, msgs, offsets, keys, sigs, n, out, width, shards, s_ok);
}

int hs_stage_packed_dh(const uint8_t *msgs, const uint8_t *keys, const uint8_t *sigs, int64_t n,
                       uint8_t *out, int64_t width, int64_t shards, uint8_t *s_ok) {
  const Layout lay = {4, {keys, sigs, sigs + 32, msgs}, {32, 64, 64, 32}};
  return stage(lay, nullptr, nullptr, nullptr, sigs, n, out, width, shards, s_ok);
}

int hs_stage_committee_hh(const uint8_t *msgs, const int64_t *offsets, const uint8_t *keys,
                          const uint8_t *sigs, int64_t n, uint8_t *out, int64_t width,
                          int64_t shards, uint8_t *s_ok) {
  const Layout lay = {3, {sigs, sigs + 32, nullptr}, {64, 64, 0}};
  return stage(lay, msgs, offsets, keys, sigs, n, out, width, shards, s_ok);
}

int hs_stage_committee_dh(const uint8_t *msgs, const uint8_t *sigs, int64_t n, uint8_t *out,
                          int64_t width, int64_t shards, uint8_t *s_ok) {
  const Layout lay = {3, {sigs, sigs + 32, msgs}, {64, 64, 32}};
  return stage(lay, nullptr, nullptr, nullptr, sigs, n, out, width, shards, s_ok);
}

}  // extern "C"
