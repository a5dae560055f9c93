// K6's fixed part: what every generated constraint-slice source shares.
//
// K6 replaces the quotient's op-by-op K3, add and sub launches
// (olavm_tpu/field/pallas_kernels.py:79 mul_pallas, and the jnp add and sub
// of olavm_tpu/field/gf.py:89,104, which olavm_tpu's `qpart` programs fuse
// through XLA, olavm_tpu/stark/prover_device.py:155-167). The constraint
// code of a table is recorded as a tape (stark/constraint_tape.py) and cut
// into slices of its constraint sequence; stark/constraint_codegen.py
// writes each slice as a row function `row<k>` and a kernel `slice<k>`
// over these helpers, one thread per row of a residue class, every value
// in registers, each input column read once per slice, coalesced across
// threads. Bound: the arithmetic (a field product is ~20 32-bit integer
// operations against 8 bytes per column read), not the memory.
//
// The row functions are __device__ and call only goldilocks.cuh's gl::
// helpers, so with the CUDA qualifiers stubbed a host compiler builds the
// same source (the `#else` branches below: the launch runs the rows on the
// host, in order), and tests compare it with the plain version.
#pragma once

#include <cstdint>

#include "goldilocks.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace qk {

// One launch's operands, all (rows, m)-shaped arrays row-major by column:
// lv, zl the class's trace and Z values at row i; nv, zn at the next row,
// (i + nshift) mod m; sel the selector columns (z_last, lagrange_first,
// lagrange_last); bank the challenge bank (alphas first); pool the tape's
// constants; acc the (alphas, m) accumulators, read unless the slice is the
// first and written by every slice; zh_inv one value (zh_stride 0) or a
// column (zh_stride 1), multiplied in by the last slice.
struct Args {
  const uint64_t* lv;
  const uint64_t* nv;
  const uint64_t* zl;
  const uint64_t* zn;
  const uint64_t* sel;
  const uint64_t* bank;
  const uint64_t* pool;
  uint64_t* acc;
  const uint64_t* zh_inv;
  int64_t m;
  int64_t nshift;
  int64_t zh_stride;
};

constexpr int THREADS = 128;

__device__ __forceinline__ uint64_t load(const uint64_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

__device__ __forceinline__ int64_t next_row(const Args& a, int64_t i) {
  const int64_t j = i + a.nshift;
  return j >= a.m ? j - a.m : j;
}

__device__ __forceinline__ uint64_t neg(uint64_t x) { return gl::sub(0, x); }

// 1 where x equals the (canonical) constant c, else 0
__device__ __forceinline__ uint64_t ieq(uint64_t x, uint64_t c) {
  return x == c ? 1 : 0;
}

// one Horner step of an accumulator: acc * alpha + c
__device__ __forceinline__ uint64_t horner(uint64_t acc, uint64_t alpha,
                                          uint64_t c) {
  return gl::add(gl::mul(acc, alpha), c);
}

#ifndef __CUDACC__
// the host build's launch: every row in order
inline void host_rows(void (*row)(const Args&, int64_t), const Args& a) {
  for (int64_t i = 0; i < a.m; ++i) row(a, i);
}
#endif

}  // namespace qk

#ifdef __CUDACC__
// slice k's kernel: a grid-stride loop over the rows
#define QK_SLICE_KERNEL(k)                                                    \
  __global__ void __launch_bounds__(qk::THREADS) slice##k(const qk::Args a) { \
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;     \
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +         \
                     threadIdx.x;                                             \
         i < a.m; i += stride)                                                \
      row##k(a, i);                                                           \
  }
#define QK_LAUNCH(k)                                                    \
  slice##k<<<gl::grid_for(a.m, qk::THREADS), qk::THREADS, 0,            \
             static_cast<cudaStream_t>(stream)>>>(a)
#define QK_STATUS() static_cast<int>(cudaGetLastError())
#else
#define QK_SLICE_KERNEL(k)
#define QK_LAUNCH(k) qk::host_rows(row##k, a)
#define QK_STATUS() 0
#endif
