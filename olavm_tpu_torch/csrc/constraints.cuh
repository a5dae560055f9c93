// K6's fixed part: what every generated constraint-slice source shares.
//
// K6 replaces the quotient's op-by-op K3, add and sub launches
// (olavm_tpu/field/pallas_kernels.py:79 mul_pallas, and the jnp add and sub
// of olavm_tpu/field/gf.py:89,104, which olavm_tpu's `qpart` programs fuse
// through XLA, olavm_tpu/stark/prover_device.py:155-167). The constraint
// code of a table is recorded as a tape (stark/constraint_tape.py), lowered
// (products by a pooled 0 or 1 folded, each operation made once) and cut
// into slices of its operations; stark/constraint_codegen.py writes each
// slice as a row function `row<k>` and a kernel `slice<k>` over these
// helpers, one thread per row of a residue class, every value in
// registers, each input column read once per slice, coalesced across
// threads. Bound: the arithmetic (a field product is ~20 32-bit integer
// operations against 8 bytes per column read), not the memory. So:
// - every intermediate is a residue below 2^64 (goldilocks.cuh's lazy
//   helpers); only an `ieq` operand and the written accumulators are made
//   canonical;
// - the constants (the tape's pool, the challenge bank, each alpha's powers
//   and the values that read no row, such as a challenge's powers) sit in
//   constant memory, `qk_c` of each generated source, made once per class
//   by `prepare` from the device tensors: a uniform operand costs no load;
// - each constraint c_j enters the sum c_j alpha^(K-1-j) as an unreduced
//   128-bit product into a 160-bit sum per alpha (gl::acc_add), reduced once
//   per slice;
// - a value that later slices read goes to a scratch column once;
// - __launch_bounds__ caps the registers so that MIN_BLOCKS blocks (12
//   warps) share an SM; the plan keeps few values live at once
//   (constraint_tape.pressure), and each load waits for a value computed a
//   few nodes before it (qk::load_at), so that ptxas neither hoists the
//   loads nor spills.
//
// The row functions are __device__ and call only goldilocks.cuh's gl::
// helpers, so with the CUDA qualifiers stubbed a host compiler builds the
// same source (the `#else` branches below: the launch runs the rows on the
// host, in order), and tests compare it with the plain version.
#pragma once

#include <cstdint>
#include <cstring>

#include "goldilocks.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace qk {

// One launch's operands, all (rows, m)-shaped arrays row-major by column:
// lv, zl the class's trace and Z values at row i; nv, zn at the next row,
// (i + nshift) mod m; sel the selector columns (z_last, lagrange_first,
// lagrange_last); acc the (alphas, m) accumulators, read unless the slice is
// the first and written by every slice that adds a constraint; scr the
// scratch columns; zh_inv one value (zh_stride 0) or a column (zh_stride 1),
// multiplied in by the last slice; zero 0 (opaque).
struct Args {
  const uint64_t* lv;
  const uint64_t* nv;
  const uint64_t* zl;
  const uint64_t* zn;
  const uint64_t* sel;
  uint64_t* acc;
  uint64_t* scr;
  const uint64_t* zh_inv;
  int64_t m;
  int64_t nshift;
  int64_t zh_stride;
  int64_t zero;  // 0, unknown to the compiler (opaque)
};

constexpr int THREADS = 128;
// blocks of THREADS an SM must hold: at most 65536 / (128 * 3) = 168
// registers a thread, 12 warps an SM (at 4 blocks, 128 registers, ptxas
// spilled a few bytes in two tables' slices: PERF.md)
constexpr int MIN_BLOCKS = 3;

__device__ __forceinline__ uint64_t load(const uint64_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// element (c, r) of an (., m) array, loaded once `after` is known: the
// address takes `after & zero` (0 at run time, but no compiler can tell),
// so the load issues where the row function has it, and a value read again
// later is a load of its own, neither hoisted to the kernel's start nor
// merged with an earlier load (either would hold it in a register, or
// spill it, in between)
__device__ __forceinline__ uint64_t load_at(const uint64_t* base, int64_t c,
                                           int64_t r, int64_t m,
                                           int64_t zero, uint64_t after) {
  return load(base + (c + static_cast<int64_t>(after & zero)) * m + r);
}

__device__ __forceinline__ int64_t next_row(const Args& a, int64_t i) {
  const int64_t j = i + a.nshift;
  return j >= a.m ? j - a.m : j;
}

// 1 where the canonical x equals the (canonical) constant c, else 0
__device__ __forceinline__ uint64_t ieq(uint64_t x, uint64_t c) {
  return x == c ? 1 : 0;
}

// x^e, canonical
__device__ __forceinline__ uint64_t power(uint64_t x, uint64_t e) {
  uint64_t r = 1;
  for (; e; e >>= 1) {
    if (e & 1) r = gl::mul(r, x);
    x = gl::mul(x, x);
  }
  return r;
}

// entry t of a constant table: [pool | bank | alpha_r^u at r * k + u], the
// alphas being the bank's first `alphas` values
__device__ __forceinline__ uint64_t constant(int64_t t, const uint64_t* pool,
                                            int npool, const uint64_t* bank,
                                            int nbank, int k) {
  if (t < npool) return pool[t];
  if (t < npool + nbank) return bank[t - npool];
  t -= npool + nbank;
  return power(bank[t / k], static_cast<uint64_t>(t % k));
}

#ifdef __CUDACC__
// the constant table: every thread fills entries of [pool | bank | powers],
// and the first also makes the uniform values (Uniform, generated) after
// them
template <class Uniform>
__global__ void prepare_kernel(const uint64_t* pool, int npool,
                               const uint64_t* bank, int nbank, int k,
                               int64_t n, uint64_t* cst) {
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t t = t0; t < n; t += static_cast<int64_t>(gridDim.x) * blockDim.x)
    cst[t] = constant(t, pool, npool, bank, nbank, k);
  if (t0 == 0) Uniform()(pool, bank, cst + n);
}

// fill a source's constant table `sym` through the device buffer `cst` (a
// kernel, then one device-to-device copy: both in stream order, both
// captured by a CUDA graph)
template <class Uniform, class Symbol>
inline int prepare(const Symbol& sym, const uint64_t* pool, int npool,
                   const uint64_t* bank, int nbank, int alphas, int k,
                   int uniform, uint64_t* cst, void* stream) {
  const int64_t n = npool + nbank + static_cast<int64_t>(alphas) * k;
  const auto s = static_cast<cudaStream_t>(stream);
  prepare_kernel<Uniform><<<gl::grid_for(n, 256), 256, 0, s>>>(
      pool, npool, bank, nbank, k, n, cst);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      cudaMemcpyToSymbolAsync(sym, cst, (n + uniform) * sizeof(uint64_t), 0,
                              cudaMemcpyDeviceToDevice, s));
}
#else
template <class Uniform, class Symbol>
inline int prepare(Symbol& sym, const uint64_t* pool, int npool,
                   const uint64_t* bank, int nbank, int alphas, int k,
                   int uniform, uint64_t* cst, void*) {
  const int64_t n = npool + nbank + static_cast<int64_t>(alphas) * k;
  for (int64_t t = 0; t < n; ++t)
    cst[t] = constant(t, pool, npool, bank, nbank, k);
  Uniform()(pool, bank, cst + n);
  std::memcpy(sym, cst, (n + uniform) * sizeof(uint64_t));
  return 0;
}

// the host build's launch: every row in order
inline void host_rows(void (*row)(const Args&, int64_t), const Args& a) {
  for (int64_t i = 0; i < a.m; ++i) row(a, i);
}
#endif

}  // namespace qk

#ifdef __CUDACC__
// slice k's kernel: one row a thread (no loop: in a grid-stride loop the
// compiler hoists the constants' loads out of it and holds them all in
// registers)
#define QK_SLICE_KERNEL(k)                                                \
  __global__ void __launch_bounds__(qk::THREADS, qk::MIN_BLOCKS)          \
      slice##k(const qk::Args a) {                                        \
    const int64_t i =                                                     \
        static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;      \
    if (i < a.m) row##k(a, i);                                            \
  }
#define QK_LAUNCH(k)                                                      \
  slice##k<<<static_cast<unsigned>((a.m + qk::THREADS - 1) / qk::THREADS), \
             qk::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a)
#define QK_STATUS() static_cast<int>(cudaGetLastError())
// blocks of slice k an SM holds at once
#define QK_OCCUPANCY(k)                                          \
  static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor( \
      blocks, slice##k, qk::THREADS, 0))
#else
#define QK_SLICE_KERNEL(k)
#define QK_LAUNCH(k) qk::host_rows(row##k, a)
#define QK_STATUS() 0
#define QK_OCCUPANCY(k) (*blocks = 0)
#endif
