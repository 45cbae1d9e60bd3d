// n squarings a lane on the port's production field (field.cuh, 10 limbs of
// radix 2^25.5), in one launch: the other row of the device tuning tool's
// --field leg (hotstuff_tpu_torch/tune_device.py), beside K8's radix-2^12
// chain.
//
// Counterpart of the reference tool's chain on its production field,
// lax.fori_loop(0, chain, f32f.sqr) (tools/tune_device.py:96-99): one
// compiled program, so one launch here too, not one launch a squaring. Not
// a kernel of the verifier: its plain version is ops/field.py sqr_n, which
// it equals limb for limb (fe_sq runs the steps of field.py's sqr).
//
// One thread a lane, blocks of 128; the element stays in registers across
// the chain. Bound: INT32 operations, 55 IMAD.WIDE a squaring plus the
// carry chain; at 4,096 lanes latency bound, as K8.
#include <cuda_runtime.h>

#include "field.cuh"

#define FS_THREADS 128

namespace {

__global__ void __launch_bounds__(FS_THREADS)
field_sqr_n_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, int n, int batch) {
  const int lane = blockIdx.x * FS_THREADS + threadIdx.x;
  if (lane >= batch) return;
  fe a = load_fe(x + lane, batch);
#pragma unroll 1
  for (int s = 0; s < n; s++) a = fe_sq(a);
  store_fe(out + lane, batch, a);
}

}  // namespace

// x, out: (10, B) int32 limbs.
extern "C" int hs_field_sqr_n(const void* x, void* out, int n, int batch, void* stream) {
  const int blocks = (batch + FS_THREADS - 1) / FS_THREADS;
  field_sqr_n_kernel<<<blocks, FS_THREADS, 0, (cudaStream_t)stream>>>((const int32_t*)x, (int32_t*)out, n, batch);
  return (int)cudaGetLastError();
}
