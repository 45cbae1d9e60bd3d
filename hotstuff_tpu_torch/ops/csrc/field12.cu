// Kernel K8: GF(2^255 - 19) in 22 radix-2^12 uint32 limbs.
//
// Replaces the reference's experimental field, hotstuff_tpu/ops/field12.py:
// mul (:137), sqr (:147), sqr_n (:158), _reduce (:120), sub (:112), carry
// (:97) and canonical (:184); its one device caller is the reference's
// tuning tool (tools/tune_device.py --field, :72-108), whose port is
// hotstuff_tpu_torch/tune_device.py. Entry points:
//   hs_field12            n squarings a lane in one launch (sqr_n, sqr = n 1)
//   hs_field12_mul        one product
//   hs_field12_sub        a - b (mod p), normalized
//   hs_field12_canonical  the representative in [0, p) of any 264-bit value
//
// Layout. The products, hs_field12 and hs_field12_mul, give each lane four
// threads, one in each warp of a block of 128: a block takes 32 lanes, and
// warp g computes the column pairs k in [F12_PART[g], F12_PART[g + 1]) of
// every product of its 32 lanes: product rows k and 22 + k, which the fold
// adds as limb k. A pair holds 12 or 11 of a squaring's 253 products and 22
// of a product's 484, so the warps take 69 / 69 / 58 / 57 and 132 / 132 /
// 110 / 110. The warp is a template argument: its rows and products are
// constants, no warp diverges (the four threads of a lane in one warp would
// run four different row sets one after the other) and no register array
// is indexed at run time, as csrc/split_field.cuh does for K4.
//
// One product, on each warp, with three exchanges through the block's shared
// memory (a __syncthreads each):
//   1. the column sums of its rows, from the whole of a (and b), published;
//      the three raw rows below each of its two bands read back (row k
//      after the three non-wrapping carry passes depends on rows k - 3 ..
//      k); warp 0 reads rows 41-43, whose carries reach rows 44-45;
//   2. the three passes over each band with its halo and the fold of its
//      limbs (rows 44-45 into 22-23 on warp 0), published; the three folded
//      limbs below its own read back (limb k after the three wrapping passes
//      depends on limbs k - 3 .. k; warp 0 reads limbs 19-21, whose carry
//      enters limb 0 times FOLD);
//   3. the three wrapping passes: its own limbs are then exact; between
//      squarings they are gathered (16-byte rows), since every warp's rows
//      need all of a.
// The passes, the fold and the wrap are the reference's, row for row; only
// the three rows or limbs of a halo are carried twice. (Six raw rows of
// halo, carried through both stages, would save the second exchange: that
// design issued more instructions a squaring and took more time, PERF.md
// section 6.) An element stays (22, B) uint32 in
// memory, limb i of lane b at [i * B + b]. A lane past the batch computes
// on the last lane (every warp must reach every barrier) and skips its
// stores. hs_field12_sub and hs_field12_canonical do no limb products and
// stay one thread a lane, in blocks of 128.
//
// Every step is the reference's, in its order, so K8 equals the plain
// version (ops/field12.py) and the JAX function limb for limb, not only
// mod p:
//   * products are 32-bit IMADs, not IMAD.WIDE: the reference's bounds keep
//     every product below 2^27 and every column sum below 2^31.1 for
//     normalized inputs or one lazy add (field12.py:8-10, :138-139); a row
//     is summed in another order than the reference's, and a squaring's
//     row as 2 (sum a_i a_j) + a_i^2 rather than sum (2 a_i) a_j + a_i^2,
//     which uint32's ring arithmetic ignores; each row takes the same
//     products, all on one warp;
//   * carry is three wrapping passes; _reduce three non-wrapping passes over
//     the 46 rows (the top row's carry is dropped), the fold of rows 44-45
//     into rows 22-23 with FOLD, the FOLD multiply of rows 22-43 into 0-21,
//     then carry; canonical its sequential carries, two FOLD folds, two
//     folds of bit 255 (bit 3 of limb 21) and two conditional subtractions
//     of p. The uint32-exactness argument of the reference holds for these
//     passes; another carry order would need a new one.
//
// Bound: INT32 operations. A product is 484 IMADs, a squaring 253 (22 + 231),
// plus about 450 carry and fold operations either way. One thread a lane,
// this kernel's first design, put 4,096 lanes on 32 of 132 SMs, one warp a
// scheduler, a chain of about 870 operations a squaring on each: latency
// bound, 128 lanes as slow as 4,096. Here 4,096 lanes are 128 blocks, one
// warp on each scheduler of 128 SMs, each warp's chain about 60 products
// and 200 carry and fold operations a squaring, plus three barriers.
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

#define F12_N 22
#define F12_BITS 12
#define F12_MASK 4095u
#define F12_FOLD 9728u  // 2^264 = 19 * 2^9 (mod p)
#define F12_THREADS 128       // sub, canonical: one thread a lane
#define F12_LANES 32           // sqr_n, mul: a block of four warps takes 32 lanes
#define F12_SPLIT_THREADS 128  // its threads
#define F12_HALO 3             // rows (limbs) a warp reads below each of its runs
#define F12_STRIDE 28          // words of a lane's gathered element: 16-byte rows, loads without bank conflicts

namespace {

// The partition of the products: warp g of a block owns the column pairs
// [F12_PART[g], F12_PART[g + 1]) of its lanes (rows k and 22 + k; warp 0
// also rows 44 and 45, which hold no products). tests/test_torch_field12.py
// reads this table.
constexpr int F12_PART[5] = {0, 6, 12, 17, 22};

template <int G>
struct f12_band {
  static constexpr int L0 = F12_PART[G], L1 = F12_PART[G + 1], N = L1 - L0;
};

// The block's exchange area.
struct __align__(16) f12_area {
  uint32_t raw[2 * F12_N][F12_LANES];    // product rows 0-43 as their warps summed them
  uint32_t fold[F12_N][F12_LANES];       // limbs 0-21 after the fold
  uint32_t limb[F12_LANES][F12_STRIDE];  // each lane's limbs after a product
};

// Limbs of 8192 p, each in [8 * 4096, 2^17) (field12.py BIAS).
__constant__ uint32_t F12_BIAS[F12_N] = {
    32768, 36818, 36855, 36855, 36855, 36855, 36855, 36855, 36855, 36855, 36855,
    36855, 36855, 36855, 36855, 36855, 36855, 36855, 36855, 36855, 36855, 65527};

struct fe12 {
  uint32_t v[F12_N];
};

__device__ __forceinline__ fe12 f12_load(const uint32_t* __restrict__ p, int lane, int batch) {
  fe12 r;
#pragma unroll
  for (int i = 0; i < F12_N; i++) r.v[i] = __ldg(p + (size_t)i * batch + lane);
  return r;
}

__device__ __forceinline__ void f12_store(uint32_t* __restrict__ p, int lane, int batch, const fe12& a) {
#pragma unroll
  for (int i = 0; i < F12_N; i++) p[(size_t)i * batch + lane] = a.v[i];
}

// _carry_pass(wrap=True) three times: limb 0 takes the top limb's carry
// times FOLD, limb k the carry of limb k - 1.
__device__ __forceinline__ void f12_carry(uint32_t* c) {
#pragma unroll
  for (int pass = 0; pass < 3; pass++) {
    uint32_t hi[F12_N];
#pragma unroll
    for (int k = 0; k < F12_N; k++) {
      hi[k] = c[k] >> F12_BITS;
      c[k] &= F12_MASK;
    }
    c[0] += hi[F12_N - 1] * F12_FOLD;
#pragma unroll
    for (int k = 1; k < F12_N; k++) c[k] += hi[k - 1];
  }
}

// f(std::integral_constant<int, K>) for K = 0 .. N - 1: an index that is a
// constant expression, for a template argument.
template <class F, int... K>
__device__ __forceinline__ void f12_each(F&& f, std::integer_sequence<int, K...>) {
  (f(std::integral_constant<int, K>{}), ...);
}
template <int N, class F>
__device__ __forceinline__ void f12_each(F&& f) {
  f12_each(f, std::make_integer_sequence<int, N>{});
}

// Product row R of a * b (SQ false: a_i b_j, i + j = R) or of a^2 (SQ true:
// (2 a_i) a_j for i < j and a_i^2 for i = j, summed as 2 (sum a_i a_j) +
// a_i^2, the same uint32).
template <int R, bool SQ>
__device__ __forceinline__ uint32_t f12_row(const uint32_t* a, const uint32_t* b) {
  constexpr int LO = R > F12_N - 1 ? R - (F12_N - 1) : 0;
  uint32_t s = 0;
  if constexpr (SQ) {
#pragma unroll
    for (int i = LO; 2 * i < R; i++) s += a[i] * a[R - i];
    s += s;
    if constexpr (R % 2 == 0 && R / 2 < F12_N) s += a[R / 2] * a[R / 2];
  } else {
#pragma unroll
    for (int i = LO; i <= R && i < F12_N; i++) s += a[i] * b[R - i];
  }
  return s;
}

// Three carry passes over NR consecutive rows (_carry_pass: row k takes the
// carry of row k - 1, the top row's carry is dropped); row WRAP, if any,
// takes its carry in times FOLD (limb 0 after limb 21). The first row takes
// no carry in, so where it is a halo row the first three rows come out
// short and no one reads them.
template <int NR, int WRAP>
__device__ __forceinline__ void f12_passes(uint32_t (&c)[NR]) {
#pragma unroll
  for (int pass = 0; pass < 3; pass++) {
    uint32_t hi[NR];
#pragma unroll
    for (int k = 0; k < NR; k++) {
      hi[k] = c[k] >> F12_BITS;
      c[k] &= F12_MASK;
    }
#pragma unroll
    for (int k = 1; k < NR; k++) c[k] += (k == WRAP ? F12_FOLD : 1u) * hi[k - 1];
  }
}

// One product on warp G for block lane `lane`: a * b, or a^2 (SQ), a and b
// whole; own gets limbs [L0, L1) of the normalized result (_reduce).
template <int G, bool SQ>
__device__ __forceinline__ void f12_product(f12_area& s, int lane, const uint32_t (&a)[F12_N],
                                            const uint32_t (&b)[F12_N], uint32_t (&own)[f12_band<G>::N]) {
  using B = f12_band<G>;
  constexpr int H = F12_HALO, NR = H + B::N;
  // lo[H + k] and up[H + k]: rows L0 + k and 22 + L0 + k; lo[h] and up[h]
  // below them: the halo, rows L0 - H + h (none below row 0) and 19 + L0 + h.
  uint32_t lo[NR], up[NR];
  f12_each<B::N>([&](auto kc) {
    constexpr int k = decltype(kc)::value;
    lo[H + k] = f12_row<B::L0 + k, SQ>(a, b);
    up[H + k] = f12_row<F12_N + B::L0 + k, SQ>(a, b);
    s.raw[B::L0 + k][lane] = lo[H + k];
    s.raw[F12_N + B::L0 + k][lane] = up[H + k];
  });
  __syncthreads();
#pragma unroll
  for (int h = 0; h < H; h++) {
    constexpr int R0 = B::L0 - H;
    lo[h] = R0 + h >= 0 ? s.raw[R0 + h >= 0 ? R0 + h : 0][lane] : 0u;
    up[h] = s.raw[F12_N + R0 + h][lane];
  }
  f12_passes<NR, -1>(lo);
  f12_passes<NR, -1>(up);
  // w[H + k]: limb L0 + k after the fold; w[j < H]: limbs L0 - H + j
  // (warp 0: limbs 19-21) from the warp below, after the second exchange.
  uint32_t w[H + B::N];
#pragma unroll
  for (int k = 0; k < B::N; k++) w[H + k] = lo[H + k] + F12_FOLD * up[H + k];
  if constexpr (G == 0) {
    uint32_t tail[H + 2];  // rows 41-45; 44 and 45 take only the carries out of row 43
#pragma unroll
    for (int h = 0; h < H; h++) tail[h] = s.raw[2 * F12_N - H + h][lane];
    tail[H] = tail[H + 1] = 0;
    f12_passes<H + 2, -1>(tail);
    w[H] = lo[H] + F12_FOLD * (up[H] + F12_FOLD * tail[H]);
    w[H + 1] = lo[H + 1] + F12_FOLD * (up[H + 1] + F12_FOLD * tail[H + 1]);
  }
#pragma unroll
  for (int k = 0; k < B::N; k++) s.fold[B::L0 + k][lane] = w[H + k];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < H; j++) w[j] = s.fold[(B::L0 - H + j + F12_N) % F12_N][lane];
  f12_passes<H + B::N, G == 0 ? H : -1>(w);
#pragma unroll
  for (int k = 0; k < B::N; k++) own[k] = w[H + k];
}

// Every warp's limbs of the lane's last product, into a (whole).
template <int G>
__device__ __forceinline__ void f12_gather(f12_area& s, int lane, const uint32_t (&own)[f12_band<G>::N],
                                           uint32_t (&a)[F12_N]) {
  uint32_t* mine = s.limb[lane];
#pragma unroll
  for (int k = 0; k < f12_band<G>::N; k++) mine[f12_band<G>::L0 + k] = own[k];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 5; q++) {
    const uint4 v = reinterpret_cast<const uint4*>(mine)[q];
    a[4 * q] = v.x, a[4 * q + 1] = v.y, a[4 * q + 2] = v.z, a[4 * q + 3] = v.w;
  }
  const uint2 v = reinterpret_cast<const uint2*>(mine)[10];
  a[20] = v.x, a[21] = v.y;
}

// hs_field12 on warp G: n squarings of the lane at column col.
template <int G>
__device__ __forceinline__ void f12_sqr_n_body(f12_area& s, const uint32_t* __restrict__ x,
                                               uint32_t* __restrict__ out, int n, int lane, int col,
                                               bool store, int batch) {
  using B = f12_band<G>;
  fe12 a = f12_load(x, col, batch);
  uint32_t own[B::N];
#pragma unroll
  for (int k = 0; k < B::N; k++) own[k] = a.v[B::L0 + k];
#pragma unroll 1
  for (int r = 0; r < n; r++) {
    if (r > 0) f12_gather<G>(s, lane, own, a.v);
    f12_product<G, true>(s, lane, a.v, a.v, own);
  }
  if (!store) return;
#pragma unroll
  for (int k = 0; k < B::N; k++) out[(size_t)(B::L0 + k) * batch + col] = own[k];
}

// hs_field12_mul on warp G.
template <int G>
__device__ __forceinline__ void f12_mul_body(f12_area& s, const uint32_t* __restrict__ a,
                                             const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                                             int lane, int col, bool store, int batch) {
  using B = f12_band<G>;
  const fe12 x = f12_load(a, col, batch), y = f12_load(b, col, batch);
  uint32_t own[B::N];
  f12_product<G, false>(s, lane, x.v, y.v, own);
  if (!store) return;
#pragma unroll
  for (int k = 0; k < B::N; k++) out[(size_t)(B::L0 + k) * batch + col] = own[k];
}

// _seq_carry: limbs < 4096 in place, returns the carry out of limb 21.
__device__ __forceinline__ uint32_t f12_seq_carry(uint32_t* x) {
  uint32_t cin = 0;
#pragma unroll
  for (int i = 0; i < F12_N; i++) {
    const uint32_t t = x[i] + cin;
    x[i] = t & F12_MASK;
    cin = t >> F12_BITS;
  }
  return cin;
}

// _cond_sub_p: x - p where x >= p (x + 2^264 - p carries out of limb 21).
__device__ __forceinline__ void f12_cond_sub_p(uint32_t* x) {
  uint32_t t[F12_N];
#pragma unroll
  for (int i = 0; i < F12_N; i++) t[i] = x[i];
  t[0] += 19u;            // 2^264 - p: limb 0 = 19, limb 21 = 4088, the rest 0
  t[F12_N - 1] += 4088u;
  const bool ge = f12_seq_carry(t) >= 1u;
#pragma unroll
  for (int i = 0; i < F12_N; i++) x[i] = ge ? t[i] : x[i];
}

__device__ __forceinline__ void f12_canonical(uint32_t* x) {
  uint32_t cout = f12_seq_carry(x);
  x[0] += cout * F12_FOLD;
  cout = f12_seq_carry(x);
  x[0] += cout * F12_FOLD;
  f12_seq_carry(x);  // limbs < 4096, value < 2^264
#pragma unroll
  for (int r = 0; r < 2; r++) {
    const uint32_t q = x[F12_N - 1] >> 3;  // value >> 255
    x[F12_N - 1] &= 7u;
    x[0] += q * 19u;
    f12_seq_carry(x);
  }
  f12_cond_sub_p(x);
  f12_cond_sub_p(x);
}

__global__ void __launch_bounds__(F12_SPLIT_THREADS)
field12_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int n, int batch) {
  __shared__ f12_area area;
  const int lane = threadIdx.x & 31, want = blockIdx.x * F12_LANES + lane;
  const int col = min(want, batch - 1);  // a lane past the batch computes on the last
  const bool store = want < batch;
  switch (threadIdx.x >> 5) {
    case 0: f12_sqr_n_body<0>(area, x, out, n, lane, col, store, batch); break;
    case 1: f12_sqr_n_body<1>(area, x, out, n, lane, col, store, batch); break;
    case 2: f12_sqr_n_body<2>(area, x, out, n, lane, col, store, batch); break;
    default: f12_sqr_n_body<3>(area, x, out, n, lane, col, store, batch); break;
  }
}

__global__ void __launch_bounds__(F12_SPLIT_THREADS)
field12_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                   uint32_t* __restrict__ out, int batch) {
  __shared__ f12_area area;
  const int lane = threadIdx.x & 31, want = blockIdx.x * F12_LANES + lane;
  const int col = min(want, batch - 1);
  const bool store = want < batch;
  switch (threadIdx.x >> 5) {
    case 0: f12_mul_body<0>(area, a, b, out, lane, col, store, batch); break;
    case 1: f12_mul_body<1>(area, a, b, out, lane, col, store, batch); break;
    case 2: f12_mul_body<2>(area, a, b, out, lane, col, store, batch); break;
    default: f12_mul_body<3>(area, a, b, out, lane, col, store, batch); break;
  }
}

__global__ void __launch_bounds__(F12_THREADS)
field12_sub_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                   uint32_t* __restrict__ out, int batch) {
  const int lane = blockIdx.x * F12_THREADS + threadIdx.x;
  if (lane >= batch) return;
  fe12 x = f12_load(a, lane, batch);
  const fe12 y = f12_load(b, lane, batch);
#pragma unroll
  for (int i = 0; i < F12_N; i++) x.v[i] = x.v[i] + F12_BIAS[i] - y.v[i];
  f12_carry(x.v);
  f12_store(out, lane, batch, x);
}

__global__ void __launch_bounds__(F12_THREADS)
field12_canonical_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int batch) {
  const int lane = blockIdx.x * F12_THREADS + threadIdx.x;
  if (lane >= batch) return;
  fe12 a = f12_load(x, lane, batch);
  f12_canonical(a.v);
  f12_store(out, lane, batch, a);
}

inline int f12_blocks(int batch) { return (batch + F12_THREADS - 1) / F12_THREADS; }
inline int f12_split_blocks(int batch) { return (batch + F12_LANES - 1) / F12_LANES; }

}  // namespace

// x, out: (22, B) uint32 (int32 tensors of the same bits).
extern "C" int hs_field12(const void* x, void* out, int n, int batch, void* stream) {
  field12_kernel<<<f12_split_blocks(batch), F12_SPLIT_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)out, n, batch);
  return (int)cudaGetLastError();
}

extern "C" int hs_field12_mul(const void* a, const void* b, void* out, int batch, void* stream) {
  field12_mul_kernel<<<f12_split_blocks(batch), F12_SPLIT_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, batch);
  return (int)cudaGetLastError();
}

extern "C" int hs_field12_sub(const void* a, const void* b, void* out, int batch, void* stream) {
  field12_sub_kernel<<<f12_blocks(batch), F12_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, batch);
  return (int)cudaGetLastError();
}

extern "C" int hs_field12_canonical(const void* x, void* out, int batch, void* stream) {
  field12_canonical_kernel<<<f12_blocks(batch), F12_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)out, batch);
  return (int)cudaGetLastError();
}
