// The device tuning tool's ALU yardstick (hotstuff_tpu_torch/tune_device.py
// --vpu): n dependent steps of one elementwise chain a thread, in one launch.
//
// Counterpart of the reference tool's three jnp chains (tools/tune_device.py
// bench_vpu, :35-66, each 64 steps on (64, 4096)), which XLA compiles into
// one program; a chain of torch launches would time the launches instead.
// Not a kernel of the verifier. op selects the chain:
//   0  f32  x * x + 1.0, as __fmul_rn then __fadd_rn, so that nvcc does not
//      contract the two into an FMA: the plain PyTorch x * x + 1.0 equals it
//      bit for bit, and the tool's count of 2 operations a step is what
//      the card issues;
//   1  i32  x * x + 1 with wrap-around, computed in uint32 (defined
//      behaviour); the same bits as int32;
//   2  u32  (x ^ (x >> 7)) + (x << 3).
// One thread an element, blocks of 128, the loop unrolled 16 steps at a
// time so that the loop counter costs little beside the chain.
#include <cuda_runtime.h>

#include <cstdint>

#define ALU_THREADS 128

namespace {

template <int OP>
__global__ void __launch_bounds__(ALU_THREADS)
alu_chain_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int n, int count) {
  const int i = blockIdx.x * ALU_THREADS + threadIdx.x;
  if (i >= count) return;
  uint32_t v = x[i];
  if constexpr (OP == 0) {
    float f = __uint_as_float(v);
#pragma unroll 16
    for (int s = 0; s < n; s++) f = __fadd_rn(__fmul_rn(f, f), 1.0f);
    v = __float_as_uint(f);
  } else if constexpr (OP == 1) {
#pragma unroll 16
    for (int s = 0; s < n; s++) v = v * v + 1u;
  } else {
#pragma unroll 16
    for (int s = 0; s < n; s++) v = (v ^ (v >> 7)) + (v << 3);
  }
  out[i] = v;
}

}  // namespace

// x, out: count 32-bit elements (float32 for op 0, int32 for ops 1 and 2).
extern "C" int hs_alu_chain(const void* x, void* out, int op, int n, int count, void* stream) {
  const int blocks = (count + ALU_THREADS - 1) / ALU_THREADS;
  const uint32_t* in = (const uint32_t*)x;
  uint32_t* o = (uint32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case 0: alu_chain_kernel<0><<<blocks, ALU_THREADS, 0, s>>>(in, o, n, count); break;
    case 1: alu_chain_kernel<1><<<blocks, ALU_THREADS, 0, s>>>(in, o, n, count); break;
    case 2: alu_chain_kernel<2><<<blocks, ALU_THREADS, 0, s>>>(in, o, n, count); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
