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
// Layout: one thread a lane, blocks of 128 threads; an element is (22, B)
// uint32, limb i of lane b at [i * B + b], so neighbouring threads read
// neighbouring words. The 22 limbs of each operand and the 46-row
// accumulator stay in registers (about 90 words).
//
// Every step is the reference's, in its order, so K8 equals the plain
// version (ops/field12.py) and the JAX function limb for limb, not only
// mod p:
//   * products are 32-bit IMADs, not IMAD.WIDE: the reference's bounds keep
//     every product below 2^27 and every column sum below 2^31.1 for
//     normalized inputs or one lazy add (field12.py:8-10, :138-139); the
//     rows are summed in another order than the reference's, which uint32's
//     ring arithmetic ignores, but each row takes the same products;
//   * carry is three wrapping passes; _reduce three non-wrapping passes over
//     the 46 rows (the top row's carry is dropped), the fold of rows 44-45
//     into rows 22-23 with FOLD, the FOLD multiply of rows 22-43 into 0-21,
//     then carry; canonical its sequential carries, two FOLD folds, two
//     folds of bit 255 (bit 3 of limb 21) and two conditional subtractions
//     of p. The uint32-exactness argument of the reference holds for these
//     passes; another carry order would need a new one.
//
// Bound: INT32 operations. A product is 484 IMADs, a squaring 253 (22 + 231),
// plus about 450 carry and fold operations either way. 4,096 lanes are 32
// blocks: 32 of 132 SMs, one warp a scheduler, so a chain is latency bound,
// as K6 and K7 are. More lanes a launch, or several threads a lane, are for
// a later design.
#include <cuda_runtime.h>

#include <cstdint>

#define F12_N 22
#define F12_ROWS 46
#define F12_BITS 12
#define F12_MASK 4095u
#define F12_FOLD 9728u  // 2^264 = 19 * 2^9 (mod p)
#define F12_THREADS 128

namespace {

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

// _reduce: 46 product rows -> a normalized element.
__device__ __forceinline__ fe12 f12_reduce(uint32_t* c) {
#pragma unroll
  for (int pass = 0; pass < 3; pass++) {  // _carry_pass(wrap=False)
    uint32_t hi[F12_ROWS];
#pragma unroll
    for (int k = 0; k < F12_ROWS; k++) {
      hi[k] = c[k] >> F12_BITS;
      c[k] &= F12_MASK;
    }
#pragma unroll
    for (int k = 1; k < F12_ROWS; k++) c[k] += hi[k - 1];
  }
  c[F12_N] += F12_FOLD * c[2 * F12_N];          // tail rows 44-45 into 22-23
  c[F12_N + 1] += F12_FOLD * c[2 * F12_N + 1];
  fe12 r;
#pragma unroll
  for (int k = 0; k < F12_N; k++) r.v[k] = c[k] + F12_FOLD * c[F12_N + k];
  f12_carry(r.v);
  return r;
}

__device__ __forceinline__ fe12 f12_mul(const fe12& a, const fe12& b) {
  uint32_t c[F12_ROWS];
#pragma unroll
  for (int k = 0; k < F12_ROWS; k++) c[k] = 0;
#pragma unroll
  for (int i = 0; i < F12_N; i++) {
#pragma unroll
    for (int j = 0; j < F12_N; j++) c[i + j] += a.v[i] * b.v[j];
  }
  return f12_reduce(c);
}

// Row 2i takes a_i^2, row i + j (j > i) takes (2 a_i) a_j: the reference's
// column sums (a2 = a + a, c[2i+1 : i+22] += a2[i] * a[i+1:]).
__device__ __forceinline__ fe12 f12_sqr(const fe12& a) {
  uint32_t c[F12_ROWS];
#pragma unroll
  for (int k = 0; k < F12_ROWS; k++) c[k] = 0;
#pragma unroll
  for (int i = 0; i < F12_N; i++) {
    const uint32_t a2 = a.v[i] + a.v[i];
    c[2 * i] += a.v[i] * a.v[i];
#pragma unroll
    for (int j = i + 1; j < F12_N; j++) c[i + j] += a2 * a.v[j];
  }
  return f12_reduce(c);
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

__global__ void __launch_bounds__(F12_THREADS)
field12_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int n, int batch) {
  const int lane = blockIdx.x * F12_THREADS + threadIdx.x;
  if (lane >= batch) return;  // no exchange between threads
  fe12 a = f12_load(x, lane, batch);
#pragma unroll 1
  for (int s = 0; s < n; s++) a = f12_sqr(a);
  f12_store(out, lane, batch, a);
}

__global__ void __launch_bounds__(F12_THREADS)
field12_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                   uint32_t* __restrict__ out, int batch) {
  const int lane = blockIdx.x * F12_THREADS + threadIdx.x;
  if (lane >= batch) return;
  f12_store(out, lane, batch, f12_mul(f12_load(a, lane, batch), f12_load(b, lane, batch)));
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

}  // namespace

// x, out: (22, B) uint32 (int32 tensors of the same bits).
extern "C" int hs_field12(const void* x, void* out, int n, int batch, void* stream) {
  field12_kernel<<<f12_blocks(batch), F12_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)out, n, batch);
  return (int)cudaGetLastError();
}

extern "C" int hs_field12_mul(const void* a, const void* b, void* out, int batch, void* stream) {
  field12_mul_kernel<<<f12_blocks(batch), F12_THREADS, 0, (cudaStream_t)stream>>>(
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
