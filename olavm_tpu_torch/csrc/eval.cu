// K5: Goldilocks dot products of polynomial coefficients with power tables.
//
// out[t][c] = sum_i coeffs[c][i] * pows[t][i] for (C, n) coefficients and
// (k, n) power tables [1, x_t, x_t^2, ...]: every polynomial at every point.
// Replaces the jnp evaluation of olavm_tpu/stark/oracle_device.py:335-389
// eval_at_points_dev (the FRI query leaves recomputed from the coefficients,
// 28 base points per oracle, so that no LDE stays resident) and of :484-511
// eval_at_ext (the openings: the re and im rows of the zeta and g * zeta
// power tables, a base polynomial times an extension power being two base
// dot products). There each is a product array and a log-depth sum per
// point; here one pass reads each coefficient once for all k points.
//
// Design: a block takes one column c and a chunk of the n terms; its 256
// threads split into `groups` (1, 2, 4 or 8, whole warps each) by point, so
// that a thread holds at most 4 points' sums: thread g of a group sums
// points g, g + groups, ... over every `lanes`-th term of the chunk. Each
// product is added unreduced into a 160-bit sum (goldilocks.cuh acc_add)
// and reduced once per thread; the threads' sums are then added mod p over
// the warp by shuffles and over the group's warps through shared memory.
// One partial sum per (chunk, point, column) goes to device memory, and a
// second kernel adds the chunks. The blocks of one chunk are launched in
// turn (blockIdx.x is the column), so the chunk's power rows are read from
// device memory about once and from L2 by the other columns.
//
// Bound: integer operations. A term is a 64x64->128 product (8 multiplies)
// and a 160-bit add (5), against 8 bytes of coefficient read once for all
// k points: the multiply pipe bounds it.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int POINTS_PER_THREAD = 4;
constexpr int MAX_GROUPS = 8;
constexpr int MAX_POINTS = POINTS_PER_THREAD * MAX_GROUPS;  // 32

// coeffs: (C, n); pows: (k, n); partial: (chunks, k, C), chunks = gridDim.y
__global__ void __launch_bounds__(THREADS)
dot_kernel(const uint64_t* __restrict__ coeffs, const uint64_t* __restrict__ pows,
           uint64_t* __restrict__ partial, int64_t n, int C, int k, int groups,
           int64_t chunk_len) {
  __shared__ uint64_t warp_sums[WARPS][POINTS_PER_THREAD];
  const int c = blockIdx.x;
  const int chunk = blockIdx.y;
  const int lanes = THREADS / groups;  // threads per group, whole warps
  const int g = threadIdx.x / lanes;
  const int e = threadIdx.x % lanes;
  const int64_t begin = chunk * chunk_len;
  const int64_t end = begin + chunk_len < n ? begin + chunk_len : n;
  const uint64_t* col = coeffs + c * n;

  gl::u160 acc[POINTS_PER_THREAD];
#pragma unroll
  for (int j = 0; j < POINTS_PER_THREAD; ++j) acc[j] = {0, 0, 0};
  for (int64_t i = begin + e; i < end; i += lanes) {
    const uint64_t x = col[i];
#pragma unroll
    for (int j = 0; j < POINTS_PER_THREAD; ++j) {
      const int t = g + groups * j;
      if (t < k) gl::acc_add(acc[j], gl::mul_wide(x, pows[t * n + i]));
    }
  }

  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < POINTS_PER_THREAD; ++j) {
    uint64_t r = gl::canonical(gl::reduce160_lazy(acc[j]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      r = gl::add(r, __shfl_down_sync(0xFFFFFFFFu, r, off));
    if (threadIdx.x % 32 == 0) warp_sums[warp][j] = r;
  }
  __syncthreads();
  if (threadIdx.x < k) {
    const int t = threadIdx.x;
    const int tg = t % groups, j = t / groups;
    const int warps_per_group = lanes / 32;
    uint64_t r = 0;
    for (int w = tg * warps_per_group; w < (tg + 1) * warps_per_group; ++w)
      r = gl::add(r, warp_sums[w][j]);
    partial[(static_cast<int64_t>(chunk) * k + t) * C + c] = r;
  }
}

// out: (k, C) <- the sum over chunks of partial (chunks, k, C)
__global__ void __launch_bounds__(THREADS)
sum_chunks_kernel(const uint64_t* __restrict__ partial, uint64_t* __restrict__ out,
                  int chunks, int64_t kc) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= kc) return;
  uint64_t r = 0;
  for (int ch = 0; ch < chunks; ++ch) r = gl::add(r, partial[ch * kc + idx]);
  out[idx] = r;
}

}  // namespace

// coeffs: (C, n) canonical elements; pows: (k, n), 1 <= k <= 32; partial:
// scratch of chunks * k * C words (1 <= chunks <= 65535; the caller picks
// chunks to fill the card); out: (k, C).
extern "C" int gl_eval_points(const void* coeffs, const void* pows, void* partial,
                              void* out, int64_t n, int C, int k, int chunks,
                              void* stream) {
  if (n < 1 || C < 1 || k < 1 || k > MAX_POINTS || chunks < 1 || chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int groups = 1;
  while (groups * POINTS_PER_THREAD < k) groups *= 2;
  const int64_t chunk_len = (n + chunks - 1) / chunks;
  const auto st = static_cast<cudaStream_t>(stream);
  dot_kernel<<<dim3(C, chunks), THREADS, 0, st>>>(
      static_cast<const uint64_t*>(coeffs), static_cast<const uint64_t*>(pows),
      static_cast<uint64_t*>(partial), n, C, k, groups, chunk_len);
  const int64_t kc = static_cast<int64_t>(k) * C;
  sum_chunks_kernel<<<static_cast<unsigned>((kc + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      static_cast<const uint64_t*>(partial), static_cast<uint64_t*>(out), chunks, kc);
  return static_cast<int>(cudaGetLastError());
}
