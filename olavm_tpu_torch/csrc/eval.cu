// K5: Goldilocks dot products of polynomial coefficients with power tables.
//
// out[t][c] = sum_i coeffs[c][i] * pows[t][i] for (C, n) coefficients and
// (k, n) power tables [1, x_t, x_t^2, ...]: every polynomial at every point.
// Replaces the jnp evaluation of olavm_tpu/stark/oracle_device.py:335
// eval_at_points_dev (the FRI query leaves recomputed from the coefficients,
// k = 28 base points per oracle, so that no LDE stays resident) and of :484
// eval_at_ext (the openings: the re and im rows of the zeta and g * zeta
// power tables, a base polynomial times an extension power being two base
// dot products; k = 4 for the trace and Z batches, 2 for the quotient's).
//
// Bound. A term is a 64x64->128 product (8 multiplies on the multiply pipe)
// and its add into a wide sum; the sums are reduced once. Each coefficient
// and power is 8 bytes read once. At (94, 2^20) x 28 the multiply pipe
// bounds it (2.21e10 multiplies: 1.32 ms, against 1.02 GB: 0.31 ms); at k =
// 4 the bytes do ((C + k) n words: 0.245 ms at (94, 2^20), against 0.19 ms
// of multiplies), and at k = 2.
//
// The first design of this kernel (one block per column and chunk, every
// thread a few points of one column) read the chunk's power rows once per
// column from L2: its time per column stayed ~0.1 ms from C = 8 to C = 94
// at (C, 2^20) x 28 while the distinct bytes per column fell 3.5x (PERF.md
// section 6). Here a block owns a chunk of terms across all columns and
// points of its group (the whole (C, k) up to 512 threads of tiles: C <=
// 134 at k <= 28), and its threads own the output:
// - The chunk is walked in sub-tiles of TERMS terms. Each sub-tile's
//   coefficient and power rows are copied into shared memory with cp.async
//   (16 bytes a copy where n is even), STAGES deep, so the next sub-tile
//   loads while this one is multiplied; words past n and rows past C or k
//   are zero-filled. Every word is read from device memory once per launch.
// - Thread (ct, pt, s) holds an RC x RT register tile of sums
//   (eval_tile.cuh: a term is four IMAD.WIDE.U32 with carry and two carry
//   adds): columns RC * ct + r, points RT * pt + q, over the term pairs s,
//   s + slices, ... of each sub-tile. One shared-memory coefficient serves
//   RT products, one power RC. Column r of tile ct sits in staged row r * tc
//   + ct (points likewise), so the lanes of a warp read consecutive rows,
//   and a row of STRIDE words (an odd count of 16-byte groups) puts eight
//   consecutive rows in eight bank groups: no bank conflicts.
// - slices > 1 only where a block has few tiles (k <= 4, or few columns):
//   a tile's slices are consecutive lanes, their sums are reduced by each
//   thread and added mod p by warp shuffles, and one partial sum per
//   (chunk, point, column) goes to device memory. A second kernel adds the
//   chunks in a fixed order (none for one chunk): no atomics, the same bits
//   at every run.
// The wrapper (field/gf.py eval_plan) picks the groups, slices and chunk
// length from the shape, the SM count and the card's occupancy of this
// kernel (gl_eval_occupancy): one wave of blocks.
//
// The tile: 2 columns x 4 points, 64-term sub-tiles, 105 registers, no
// spills (ptxas, sm_90a). Measured on the H100 against 4 x 4, 4 x 2, 8 x 4,
// 8 x 2 and 2 x 2 tiles, 32-term sub-tiles, 3 stages and blocks capped at
// 256 threads (PERF.md section 6): (94, 2^20) x 28 in ~2.06 ms, 64 % of
// the multiply bound, and x 4 in ~0.38 ms, 63 % of the bytes bound.
#include <cuda_runtime.h>

#include "eval_tile.cuh"
#include "goldilocks.cuh"

namespace {

using eval::MAX_THREADS;
using eval::RC;
using eval::RT;
using eval::STAGES;
using eval::STRIDE;
using eval::TERMS;

constexpr int PAIRS = TERMS / 2;
constexpr int SUM_THREADS = 256;
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory on sm_90

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// rows of a block's staged sub-tile, rounded up so that the stages that
// follow the row table start 16-byte aligned
__host__ __device__ constexpr int table_words(int rows) { return (rows + 1) & ~1; }

__host__ __device__ constexpr int64_t smem_words(int cols, int points) {
  return table_words(cols + points) + static_cast<int64_t>(STAGES) * (cols + points) * STRIDE;
}

// Copy terms [i0, i0 + TERMS) of every staged row into buf ([rows][STRIDE]);
// row_start[row] is the row's offset in coeffs or pows (< 0: past C or k).
// `wide`: n is even and both arrays 16-byte aligned, so every row starts
// 16-byte aligned and a pair of terms lies wholly below n or past it.
__device__ __forceinline__ void stage(uint64_t* buf, const int64_t* row_start,
                                      const uint64_t* coeffs, const uint64_t* pows,
                                      int64_t n, bool wide, int cols, int rows,
                                      int64_t i0) {
  for (int e = threadIdx.x; e < rows * PAIRS; e += blockDim.x) {
    const int row = e / PAIRS, pair = e % PAIRS;
    const int64_t start = row_start[row];
    const uint64_t* src = row < cols ? coeffs : pows;
    const int64_t i = i0 + 2 * pair;
    uint64_t* dst = buf + row * STRIDE + 2 * pair;
    if (wide) {
      const bool in = start >= 0 && i < n;
      cp_async16(dst, in ? src + start + i : src, in ? 16 : 0);
    } else {
      const bool in0 = start >= 0 && i < n, in1 = start >= 0 && i + 1 < n;
      cp_async8(dst, in0 ? src + start + i : src, in0 ? 8 : 0);
      cp_async8(dst + 1, in1 ? src + start + i + 1 : src, in1 ? 8 : 0);
    }
  }
  cp_async_commit();
}

// coeffs: (C, n); pows: (k, n); partial: (gridDim.x, k, C). Block (x, y, z)
// takes terms [x * chunk_len, (x + 1) * chunk_len), columns [y * cols, (y +
// 1) * cols) and points [z * points, (z + 1) * points); it has (cols / RC) *
// (points / RT) * slices threads, thread (pt * tc + ct) * slices + s.
__global__ void __launch_bounds__(MAX_THREADS)
dot_kernel(const uint64_t* __restrict__ coeffs, const uint64_t* __restrict__ pows,
           uint64_t* __restrict__ partial, int64_t n, bool wide, int C, int k,
           int cols, int points, int slices, int64_t chunk_len) {
  extern __shared__ __align__(16) uint64_t smem[];
  const int rows = cols + points;
  int64_t* row_start = reinterpret_cast<int64_t*>(smem);
  uint64_t* stages = smem + table_words(rows);
  const int tc = cols / RC, tp = points / RT;
  const int s = threadIdx.x % slices, ct = threadIdx.x / slices % tc;
  const int pt = threadIdx.x / slices / tc;
  const int c_base = blockIdx.y * cols, t_base = blockIdx.z * points;

  // staged row r * tc + ct holds column c_base + RC * ct + r, row cols + q *
  // tp + pt point t_base + RT * pt + q
  for (int row = threadIdx.x; row < rows; row += blockDim.x) {
    int64_t start;
    if (row < cols) {
      const int c = c_base + RC * (row % tc) + row / tc;
      start = c < C ? static_cast<int64_t>(c) * n : -1;
    } else {
      const int t = t_base + RT * ((row - cols) % tp) + (row - cols) / tp;
      start = t < k ? static_cast<int64_t>(t) * n : -1;
    }
    row_start[row] = start;
  }
  __syncthreads();

  const int64_t begin = static_cast<int64_t>(blockIdx.x) * chunk_len;
  const int64_t end = begin + chunk_len < n ? begin + chunk_len : n;
  const int subs = static_cast<int>((end - begin + TERMS - 1) / TERMS);
  const int64_t stage_words = static_cast<int64_t>(rows) * STRIDE;

  eval::Tile tile;
  tile.zero();
  stage(stages, row_start, coeffs, pows, n, wide, cols, rows, begin);
  for (int u = 0; u < subs; ++u) {
    if (u + 1 < subs) {
      stage(stages + (u + 1) % STAGES * stage_words, row_start, coeffs, pows, n,
            wide, cols, rows, begin + static_cast<int64_t>(u + 1) * TERMS);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const uint64_t* buf = stages + u % STAGES * stage_words;
    const ulonglong2* xs = reinterpret_cast<const ulonglong2*>(buf + ct * STRIDE);
    const ulonglong2* ys =
        reinterpret_cast<const ulonglong2*>(buf + (cols + pt) * STRIDE);
    for (int p = s; p < PAIRS; p += slices) {
      ulonglong2 xv[RC], yv[RT];
#pragma unroll
      for (int r = 0; r < RC; ++r) xv[r] = xs[r * tc * (STRIDE / 2) + p];
#pragma unroll
      for (int q = 0; q < RT; ++q) yv[q] = ys[q * tp * (STRIDE / 2) + p];
      uint64_t x0[RC], x1[RC], y0[RT], y1[RT];
#pragma unroll
      for (int r = 0; r < RC; ++r) x0[r] = xv[r].x, x1[r] = xv[r].y;
#pragma unroll
      for (int q = 0; q < RT; ++q) y0[q] = yv[q].x, y1[q] = yv[q].y;
      tile.add(x0, y0);
      tile.add(x1, y1);
    }
    // the buffer just read is the one the next iteration stages into
    __syncthreads();
  }

  // a tile's slices are consecutive lanes of one warp: their sums are added
  // mod p by shuffles, and slice 0 writes
  const int lanes = min(32, static_cast<int>(blockDim.x - (threadIdx.x & ~31u)));
  const unsigned mask = lanes == 32 ? 0xFFFFFFFFu : (1u << lanes) - 1;
  uint64_t v[RC][RT];
#pragma unroll
  for (int r = 0; r < RC; ++r)
#pragma unroll
    for (int q = 0; q < RT; ++q) v[r][q] = tile.sum(r, q);
  for (int off = slices / 2; off > 0; off /= 2)
#pragma unroll
    for (int r = 0; r < RC; ++r)
#pragma unroll
      for (int q = 0; q < RT; ++q)
        v[r][q] = gl::add(v[r][q], __shfl_down_sync(mask, v[r][q], off));
  if (s != 0) return;
#pragma unroll
  for (int r = 0; r < RC; ++r)
#pragma unroll
    for (int q = 0; q < RT; ++q) {
      const int c = c_base + RC * ct + r, t = t_base + RT * pt + q;
      if (c < C && t < k)
        partial[(static_cast<int64_t>(blockIdx.x) * k + t) * C + c] = v[r][q];
    }
}

// out: (k, C) <- the sum over chunks of partial (chunks, k, C): a warp per
// output, its lanes over the chunks, then a fixed tree of shuffles
__global__ void __launch_bounds__(SUM_THREADS)
sum_chunks_kernel(const uint64_t* __restrict__ partial, uint64_t* __restrict__ out,
                  int chunks, int64_t kc) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * (SUM_THREADS / 32) + threadIdx.x / 32;
  if (idx >= kc) return;
  const int lane = threadIdx.x % 32;
  uint64_t r = 0;
  for (int ch = lane; ch < chunks; ch += 32) r = gl::add(r, partial[ch * kc + idx]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    r = gl::add(r, __shfl_down_sync(0xFFFFFFFFu, r, off));
  if (lane == 0) out[idx] = r;
}

// above 48 KB a block's dynamic shared memory must be allowed first (on the
// current device), up to the limit: what a launch takes sets its occupancy
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_LIMIT);
}

}  // namespace

// coeffs: (C, n) canonical elements; pows: (k, n); partial: scratch of
// ceil(n / chunk_len) * k * C words (unused when that is one chunk); out:
// (k, C). The plan (cols, points, slices, chunk_len) comes from field/gf.py
// eval_plan: cols a multiple of RC and points of RT, (cols / RC) * (points
// / RT) * slices <= MAX_THREADS threads, slices a power of two up to 32
// and TERMS / 2, chunk_len a multiple of TERMS below 2^31 (the overflow
// invariant of eval_tile.cuh).
extern "C" int gl_eval_points(const void* coeffs, const void* pows, void* partial,
                              void* out, int64_t n, int C, int k, int cols,
                              int points, int slices, int64_t chunk_len,
                              void* stream) {
  if (n < 1 || C < 1 || k < 1 || cols < RC || cols % RC != 0 || points < RT ||
      points % RT != 0 || slices < 1 || slices > 32 || slices > PAIRS ||
      (slices & (slices - 1)) != 0 || chunk_len < TERMS || chunk_len % TERMS != 0 ||
      chunk_len >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t threads = static_cast<int64_t>(cols / RC) * (points / RT) * slices;
  const int64_t chunks = (n + chunk_len - 1) / chunk_len;
  const int64_t col_groups = (C + cols - 1) / cols;
  const int64_t point_groups = (k + points - 1) / points;
  const int64_t smem = 8 * smem_words(cols, points);
  if (threads > MAX_THREADS || chunks > 0x7FFFFFFF || col_groups > 65535 ||
      point_groups > 65535 || smem > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool wide = n % 2 == 0 && reinterpret_cast<uintptr_t>(coeffs) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(pows) % 16 == 0;
  const auto st = static_cast<cudaStream_t>(stream);
  // one chunk: its partial sums are the output, and no second pass runs
  dot_kernel<<<dim3(static_cast<unsigned>(chunks), static_cast<unsigned>(col_groups),
                    static_cast<unsigned>(point_groups)),
               static_cast<unsigned>(threads), static_cast<size_t>(smem), st>>>(
      static_cast<const uint64_t*>(coeffs), static_cast<const uint64_t*>(pows),
      static_cast<uint64_t*>(chunks == 1 ? out : partial), n, wide, C, k, cols,
      points, slices, chunk_len);
  if (chunks > 1) {
    const int64_t kc = static_cast<int64_t>(k) * C;
    constexpr int warps = SUM_THREADS / 32;
    sum_chunks_kernel<<<static_cast<unsigned>((kc + warps - 1) / warps), SUM_THREADS, 0,
                        st>>>(static_cast<const uint64_t*>(partial),
                              static_cast<uint64_t*>(out), static_cast<int>(chunks), kc);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of dot_kernel with `threads` threads and `smem` bytes of shared
// memory that one SM holds at once (the plan's one wave).
extern "C" int gl_eval_occupancy(int threads, int64_t smem, int* blocks) {
  if (threads < 1 || threads > MAX_THREADS || smem < 0 || smem > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, dot_kernel, threads, static_cast<size_t>(smem)));
}
