// K11: the row combination of one CTL Z (stark/ctl_kernels.py), so that a
// CTL Z program runs K11 and K8 (csrc/scan.cu) and no K3, add, fill or
// select chain.
//
// Replaces no Pallas kernel: olavm_tpu combines a view's rows with jnp
// (olavm_tpu/stark/ctl_device.py:51-81: each column's linear combination,
// sum_i col_i beta^i + gamma through a power table of beta and a tree sum,
// and the filter's select), which the port ran as about 45 launches a Z
// (a fill, then a product and a sum a term; a product a column, a tree of
// sums, the add of gamma; the filter's own combination, eq and select),
// each reading and writing whole columns.
//
// gl_ctl_combine: for each row j of a (C, n) trace,
//   v_j = sum_i (sum_t k_it trace[c_it][j] + const_i) beta^i + gamma
//       = sum_s coef_s trace[row_s][j] + coef_const,
//   out[j] = v_j where the filter's sum_t fk_t trace[fc_t][j] + fconst is 1
//   (no filter: everywhere), else 1,
// canonical. The view's structure (the distinct trace rows it reads, its
// columns' terms as (slot, column, coefficient mod p), the constants and
// the filter's coefficient a slot) goes by value in the kernel's
// parameters, static per program key, so a replayed graph needs no copy;
// beta and gamma are read from the (2,) device bank, where the challenges
// enter. Folding beta into the coefficients (coef_s = sum over the terms
// on slot s of k beta^i) makes a row one dot product of the view's slots,
// each a 128-bit product added unreduced into a 160-bit sum (gl::acc_add)
// and reduced once, and the filter a second one.
//
// A block's first thread computes beta's powers and the coefficients into
// shared memory (the view's terms, at most MAX_TERMS products) before the
// barrier; then each thread takes rows j = t, t + T, ... of the grid's T
// threads, neighbouring threads on neighbouring rows (each load
// coalesced), and loads every slot of its row before it sums them (all
// loads in flight at once). Bound: device memory, (slots + 1) x 8 bytes a
// row, every distinct row read once; a slot costs a product or two.
//
// The kernel calls only goldilocks.cuh's gl:: helpers, and the first thread
// writes its block's shared values before any other thread reads them, so
// with the CUDA qualifiers stubbed (shared memory as a static array, the
// barrier as nothing) a host compiler builds this namespace and runs every
// thread in turn (tests/test_torch_ctl_kernels.py).
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace ctl {

constexpr int MAX_SLOTS = 32;
constexpr int MAX_COLUMNS = 32;
constexpr int MAX_TERMS = 64;
constexpr int THREADS = 256;
// blocks a launch at most: a few a streaming multiprocessor, each thread
// then walks several rows, and the block's setup is paid once
constexpr int MAX_BLOCKS = 132 * 4;

// bits of View::use
constexpr int USE_VALUE = 1;
constexpr int USE_FILTER = 2;

// one CTL view: `slots` distinct trace rows, `columns` linear combinations
// (beta^0 .. beta^(columns - 1)) of `terms` terms, and the filter's
// coefficient on each slot (filtered: the view has a filter)
struct View {
  int32_t slots, columns, terms, filtered;
  int32_t row[MAX_SLOTS];
  int32_t use[MAX_SLOTS];
  int32_t term_slot[MAX_TERMS], term_column[MAX_TERMS];
  uint64_t term_k[MAX_TERMS];
  uint64_t constant[MAX_COLUMNS];
  uint64_t filter_k[MAX_SLOTS];
  uint64_t filter_constant;
};

// S: the slots' bucket (at least v.slots), so that a view of few slots
// keeps few registers
template <int S>
__global__ void __launch_bounds__(THREADS)
    combine_kernel(const View v, const uint64_t* __restrict__ trace,
                   const uint64_t* __restrict__ bank,
                   uint64_t* __restrict__ out, int64_t n) {
  // coef[s] for each slot, coef[MAX_SLOTS] the constant part with gamma
  __shared__ uint64_t coef[MAX_SLOTS + 1];
  __shared__ uint64_t pw[MAX_COLUMNS];
  if (threadIdx.x == 0) {
    const uint64_t beta = bank[0];
    uint64_t c = bank[1];
    uint64_t b = 1;
    for (int i = 0; i < v.columns; ++i) {
      pw[i] = b;
      if (v.constant[i]) c = gl::add(c, gl::mul(v.constant[i], b));
      b = gl::mul(b, beta);
    }
    coef[MAX_SLOTS] = c;
    for (int s = 0; s < v.slots; ++s) coef[s] = 0;
    for (int t = 0; t < v.terms; ++t)
      coef[v.term_slot[t]] = gl::add(
          coef[v.term_slot[t]], gl::mul(v.term_k[t], pw[v.term_column[t]]));
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
       j < n; j += stride) {
    uint64_t x[S];
#pragma unroll
    for (int s = 0; s < S; ++s)
      x[s] = s < v.slots ? __ldg(trace + v.row[s] * n + j) : 0;
    gl::u160 acc = {coef[MAX_SLOTS], 0, 0};
    gl::u160 f = {v.filter_constant, 0, 0};
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (s >= v.slots) break;
      if (v.use[s] & USE_VALUE)
        gl::acc_add(acc, gl::mul_wide(x[s], coef[s]));
      if (v.use[s] & USE_FILTER)
        gl::acc_add(f, gl::mul_wide(x[s], v.filter_k[s]));
    }
    const bool on =
        !v.filtered || gl::canonical(gl::reduce160_lazy(f)) == 1;
    out[j] = on ? gl::canonical(gl::reduce160_lazy(acc)) : 1;
  }
}

inline unsigned blocks(int64_t n) {
  const int64_t b = (n + THREADS - 1) / THREADS;
  return static_cast<unsigned>(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

}  // namespace ctl

// view: a host ctl::View; trace: (C, n); bank: [beta, gamma]; out: (n,)
extern "C" int gl_ctl_combine(const void* view, const void* trace,
                              const void* bank, void* out, int64_t n,
                              void* stream) {
  const auto& v = *static_cast<const ctl::View*>(view);
  const auto s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
#define CTL_COMBINE(S)                                                      \
  ctl::combine_kernel<S><<<ctl::blocks(n), ctl::THREADS, 0, s>>>(           \
      v, static_cast<const uint64_t*>(trace),                               \
      static_cast<const uint64_t*>(bank), static_cast<uint64_t*>(out), n)
  if (v.slots <= 8) {
    CTL_COMBINE(8);
  } else if (v.slots <= 16) {
    CTL_COMBINE(16);
  } else if (v.slots <= ctl::MAX_SLOTS) {
    CTL_COMBINE(32);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CTL_COMBINE
  return static_cast<int>(cudaGetLastError());
}
