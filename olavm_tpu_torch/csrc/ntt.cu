// K1: batched radix-2 decimation-in-time NTT along the last axis.
//
// Replaces olavm_tpu/ntt/pallas_ntt.py:223 ntt_pallas (_pass_call :152,
// body _stage_ladder_roll :105, twiddles _twiddle_tables :62): coefficients
// -> values p(w^i) in natural order for a (batch, n) array, n = 2^log_n;
// with the inverse root's table it computes the inverse transform WITHOUT
// the 1/n factor (the caller applies it, as olavm_tpu/ntt/ntt.py:129-136).
// The TPU kernel's sublane rolls, parity masks and factor-axis transposes
// are TPU layout tricks and are not carried over.
//
// Design: one bit-reversal gather kernel (in -> out), then one launch per
// radix-2 stage, in place on out. Each thread does one butterfly; the
// twiddle of stage s at offset j is tw[j << (log_n - s)] from a table of
// the n/2 powers of the root built by the caller.
//
// Bound: device memory. Every stage reads and writes the whole array once
// (16 bytes per butterfly element pair per stage against one field multiply),
// so the transform moves ~2 * 8 * batch * n * log_n bytes. A shared-memory
// design that runs several stages per pass would cut that traffic; this
// first version keeps each stage a separate, simple launch.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

__global__ void bitrev_kernel(const uint64_t* __restrict__ in,
                              uint64_t* __restrict__ out, int64_t total,
                              int log_n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t mask = (int64_t{1} << log_n) - 1;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int64_t row = idx & ~mask;
    const uint32_t i = static_cast<uint32_t>(idx & mask);
    const uint32_t r = __brev(i) >> (32 - log_n);
    out[row | r] = in[idx];
  }
}

__global__ void stage_kernel(uint64_t* __restrict__ x,
                             const uint64_t* __restrict__ tw,
                             int64_t butterflies, int log_n, int s) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t half = int64_t{1} << (s - 1);
  const int64_t per_row = int64_t{1} << (log_n - 1);
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < butterflies; t += stride) {
    const int64_t row = t >> (log_n - 1);
    const int64_t k = t & (per_row - 1);
    const int64_t j = k & (half - 1);
    const int64_t i0 = (row << log_n) + ((k >> (s - 1)) << s) + j;
    const int64_t i1 = i0 + half;
    const uint64_t u = x[i0];
    const uint64_t v = gl::mul(x[i1], tw[j << (log_n - s)]);
    x[i0] = gl::add(u, v);
    x[i1] = gl::sub(u, v);
  }
}

}  // namespace

// in, out: (batch, 2^log_n) uint64; tw: 2^(log_n - 1) powers of the root.
extern "C" int gl_ntt(const void* in, void* out, const void* tw, int64_t batch,
                      int log_n, void* stream) {
  if (log_n < 1 || log_n > 31) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int64_t total = batch << log_n;
  bitrev_kernel<<<gl::grid_for(total, threads), threads, 0, st>>>(
      static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), total,
      log_n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t butterflies = total >> 1;
  for (int s = 1; s <= log_n; ++s) {
    stage_kernel<<<gl::grid_for(butterflies, threads), threads, 0, st>>>(
        static_cast<uint64_t*>(out), static_cast<const uint64_t*>(tw),
        butterflies, log_n, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
