// K1: batched Goldilocks NTT along the last axis, several radix-2 stages per
// pass in shared memory.
//
// Replaces olavm_tpu/ntt/pallas_ntt.py:223 ntt_pallas (_pass_call :152,
// body _stage_ladder_roll :105, twiddles _twiddle_tables :62): coefficients
// -> values p(w^i) in natural order for a (batch, n) array, n = 2^log_n;
// with the inverse root's table it computes the inverse transform WITHOUT
// the 1/n factor (the caller applies it, as olavm_tpu/ntt/ntt.py:129-136).
// The TPU kernel's sublane rolls, parity masks and factor-axis transposes
// are TPU layout tricks and are not carried over. Field arithmetic is exact,
// so any factorisation of the transform gives the same bits.
//
// Design. n = 2^L is split into at most three digits, L = a + b + c (the
// plan() below). Position (pa, pb, pc) = pa 2^(b+c) + pb 2^c + pc of the
// output array first receives the input element of index
// pa + 2^a pb + 2^(a+b) pc (a digit reversal, folded into the first pass's
// load), and then one pass per digit runs a whole 2^digit-point transform
// in shared memory:
//   pass 1  over pc (runs of 2^c contiguous positions);
//   pass 2  over pb (stride 2^c), after multiplying the element at
//           (pa, pb, q) by w_n^(pb q 2^a), q the c low bits of its position;
//   pass 3  over pa (stride 2^(b+c)), after multiplying the element at
//           (pa, q) by w_n^(pa q), q the b + c low bits.
// Every pass reads and writes the array once, so n = 2^24 moves it three
// times where one launch per stage moved it 24 times, and any n <= 2^13 is
// ONE launch that packs several batch rows into a block.
//
// A block's tile is 2^m rows (the digit being transformed) by `cols`
// independent columns, 2^13 elements in all. In pass 1 the columns are
// neighbouring values of the input's low L - c bits, so both the digit-
// reversed load (runs of `cols` contiguous elements) and the store (runs of
// 2^c) are coalesced; in the later passes the columns are `cols` contiguous
// positions, so a strided row is read and written in contiguous runs. The
// tile's row pitch is odd (cols | 1) so that both the column-wise stage
// accesses and the row-wise pass-1 store spread over the banks. The
// radix-2 stages run in place in shared memory, two at a time on four rows
// in registers, with __syncthreads() between the pairs, the small
// transform's bit reversal folded into the row a loaded element is written
// to. Stage twiddles w_(2^m)^k are staged per block in shared memory from
// the caller's table of n/2 powers of the root; the between-pass twiddle is
// two reads of that table per thread and a running product down the rows
// (w^e for e >= n/2 is -w^(e - n/2)).
//
// `in` and `out` must not alias: pass 1 reads `in` at digit-reversed
// positions while other blocks write `out`. Later passes work in place.
//
// Bound: integer operations. A butterfly is one field multiply, one add and
// one sub (~32 32-bit integer instructions) against 16 bytes per pass, and
// with three passes the memory traffic no longer dominates.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int TILE_LOG = 13;   // elements per tile
constexpr int THREADS = 512;
constexpr int MAX_LOG_N = 30;  // three digits of at most 10 bits

// Digit widths: c (pass 1), b (pass 2), a (pass 3); b or a may be 0.
struct Plan {
  int a, b, c, passes;
};

Plan plan(int log_n) {
  Plan p{0, 0, log_n, 1};
  if (log_n <= TILE_LOG) return p;
  p.passes = log_n <= 20 ? 2 : 3;
  p.c = (log_n + p.passes - 1) / p.passes;
  const int rest = log_n - p.c;
  if (p.passes == 2) {
    p.a = rest;
  } else {
    p.b = (rest + 1) / 2;
    p.a = rest - p.b;
  }
  return p;
}

// Row pitch of a tile of 2^cols_log columns: odd, so that walking down a
// column and walking along a row both spread over the banks (left as it is
// for one or two columns, where padding would cost half the tile).
__host__ __device__ __forceinline__ int pitch_for(int cols_log) {
  const int cols = 1 << cols_log;
  return cols_log < 2 ? cols : cols | 1;
}

__device__ __forceinline__ uint64_t neg(uint64_t x) {
  return x ? gl::P - x : 0;
}

// In-place decimation-in-time stages over the rows of a tile whose rows were
// loaded in bit-reversed order: 2^m rows, 2^cols_log columns, row pitch
// `pitch`; tws[k] = w_(2^m)^k for k < 2^(m-1). Radix-2 stage s joins rows
// i and i + 2^(s-1) with the twiddle w_(2^s)^j, j the row's offset in its
// half-block. Two stages at a time run on four rows held in registers (one
// read and one write of shared memory and one barrier for both); an odd m
// starts with stage 1 alone, whose twiddle is 1.
__device__ __forceinline__ void stages(uint64_t* tile, const uint64_t* tws,
                                       int m, int cols_log, int pitch) {
  const int col_mask = (1 << cols_log) - 1;
  int s = 1;
  if (m & 1) {
    const int butterflies = 1 << (m - 1 + cols_log);
    for (int t = threadIdx.x; t < butterflies; t += THREADS) {
      const int i0 = ((t >> cols_log) << 1) * pitch + (t & col_mask);
      const uint64_t u = tile[i0];
      const uint64_t v = tile[i0 + pitch];
      tile[i0] = gl::add(u, v);
      tile[i0 + pitch] = gl::sub(u, v);
    }
    __syncthreads();
    s = 2;
  }
  const int quads = 1 << (m - 2 + cols_log);
  for (; s < m; s += 2) {
    const int half = 1 << (s - 1);
    for (int t = threadIdx.x; t < quads; t += THREADS) {
      const int col = t & col_mask;
      const int k = t >> cols_log;
      const int j = k & (half - 1);
      const int i0 = (((k >> (s - 1)) << (s + 1)) | j) * pitch + col;
      const int step = half * pitch;
      // stage s: rows (0, 1) and (2, 3) of the quad, both with w_(2^s)^j
      const uint64_t w = tws[j << (m - s)];
      uint64_t x0 = tile[i0];
      uint64_t x1 = gl::mul(tile[i0 + step], w);
      uint64_t x2 = tile[i0 + 2 * step];
      uint64_t x3 = gl::mul(tile[i0 + 3 * step], w);
      const uint64_t y0 = gl::add(x0, x1);
      const uint64_t y1 = gl::sub(x0, x1);
      // stage s + 1: rows (0, 2) with w_(2^(s+1))^j, (1, 3) with ^(j + half)
      const uint64_t y2 = gl::mul(gl::add(x2, x3), tws[j << (m - s - 1)]);
      const uint64_t y3 = gl::mul(gl::sub(x2, x3), tws[(j + half) << (m - s - 1)]);
      tile[i0] = gl::add(y0, y2);
      tile[i0 + step] = gl::add(y1, y3);
      tile[i0 + 2 * step] = gl::sub(y0, y2);
      tile[i0 + 3 * step] = gl::sub(y1, y3);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void load_stage_twiddles(
    uint64_t* tws, const uint64_t* __restrict__ tw, int m, int log_n) {
  for (int k = threadIdx.x; k < (1 << (m - 1)); k += THREADS)
    tws[k] = tw[static_cast<int64_t>(k) << (log_n - m)];
}

__device__ __forceinline__ int bitrev(int i, int bits) {
  return bits == 0 ? 0 : static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - bits));
}

// Pass 1: the transform over the c low bits of the position. Column `col`
// of block `blockIdx.x` is the (batch row, low input bits) pair of index
// rho = blockIdx.x * cols + col; its 2^c elements are read at stride
// 2^(a+b) and stored contiguously at the digit-reversed high position.
__global__ void __launch_bounds__(THREADS)
first_pass_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                  const uint64_t* __restrict__ tw, int64_t total_cols,
                  int log_n, int a, int b, int c) {
  extern __shared__ uint64_t smem[];
  const int cols_log = TILE_LOG - c;
  const int cols = 1 << cols_log;
  const int pitch = pitch_for(cols_log);
  uint64_t* tile = smem;
  uint64_t* tws = smem + (static_cast<size_t>(pitch) << c);
  const int hi_bits = a + b;
  const int64_t rho0 = static_cast<int64_t>(blockIdx.x) << cols_log;
  const int64_t hi_mask = (int64_t{1} << hi_bits) - 1;

  load_stage_twiddles(tws, tw, c, log_n);
  for (int idx = threadIdx.x; idx < (1 << TILE_LOG); idx += THREADS) {
    // one pass: a column is a batch row, contiguous along the row index;
    // several passes: neighbouring columns are contiguous in the input
    const int col = hi_bits == 0 ? idx >> c : idx & (cols - 1);
    const int row = hi_bits == 0 ? idx & ((1 << c) - 1) : idx >> cols_log;
    const int64_t rho = rho0 + col;
    uint64_t v = 0;
    if (rho < total_cols) {
      const int64_t batch = rho >> hi_bits;
      const int64_t low = rho & hi_mask;
      v = in[(batch << log_n) + low + (static_cast<int64_t>(row) << hi_bits)];
    }
    tile[bitrev(row, c) * pitch + col] = v;
  }
  __syncthreads();

  stages(tile, tws, c, cols_log, pitch);

  for (int idx = threadIdx.x; idx < (1 << TILE_LOG); idx += THREADS) {
    const int col = idx >> c;
    const int row = idx & ((1 << c) - 1);
    const int64_t rho = rho0 + col;
    if (rho < total_cols) {
      const int64_t batch = rho >> hi_bits;
      const int64_t low = rho & hi_mask;
      // input bits (pb, pa) -> position digits (pa, pb)
      const int64_t pos_hi = ((low & ((int64_t{1} << a) - 1)) << b) | (low >> a);
      out[(batch << log_n) + (pos_hi << c) + row] = tile[row * pitch + col];
    }
  }
}

// w_n^e for 0 <= e < n from the table of the n/2 first powers.
__device__ __forceinline__ uint64_t root_pow(const uint64_t* __restrict__ tw,
                                             int64_t e, int64_t half_n) {
  const uint64_t w = tw[e & (half_n - 1)];
  return e >= half_n ? neg(w) : w;
}

// Passes 2 and 3: the transform over the m position bits above the `done`
// low bits, in place. A tile is 2^m rows at stride 2^done by `cols`
// contiguous positions; an element is first multiplied by
// w_n^((row * q) << (log_n - done - m)), q its `done` low position bits. A
// thread keeps one column and walks down its rows in equal steps, so it
// reads two powers from the table and carries the twiddle as a running
// product: reading one power per element scatters 32-byte sectors over the
// whole table and costs more traffic than the array itself.
__global__ void __launch_bounds__(THREADS)
strided_pass_kernel(uint64_t* __restrict__ x, const uint64_t* __restrict__ tw,
                    int log_n, int done, int m) {
  extern __shared__ uint64_t smem[];
  const int cols_log = TILE_LOG - m;
  const int cols = 1 << cols_log;
  const int pitch = pitch_for(cols_log);
  uint64_t* tile = smem;
  uint64_t* tws = smem + (static_cast<size_t>(pitch) << m);
  // block -> (rows above this digit incl. batch, column group)
  const int groups_log = done - cols_log;
  const int64_t q0 = (static_cast<int64_t>(blockIdx.x) & ((int64_t{1} << groups_log) - 1))
                     << cols_log;
  const int64_t hi = static_cast<int64_t>(blockIdx.x) >> groups_log;
  uint64_t* base = x + (hi << (done + m)) + q0;
  const int64_t half_n = int64_t{1} << (log_n - 1);
  const int shift = log_n - done - m;

  load_stage_twiddles(tws, tw, m, log_n);
  {
    const int col = threadIdx.x & (cols - 1);
    const int row_step = THREADS >> cols_log;
    const int64_t q = q0 + col;
    int row = threadIdx.x >> cols_log;
    uint64_t t = root_pow(tw, (row * q) << shift, half_n);
    const uint64_t t_step = root_pow(tw, (row_step * q) << shift, half_n);
    for (; row < (1 << m); row += row_step) {
      const uint64_t v = base[(static_cast<int64_t>(row) << done) + col];
      tile[bitrev(row, m) * pitch + col] = gl::mul(v, t);
      t = gl::mul(t, t_step);
    }
  }
  __syncthreads();

  stages(tile, tws, m, cols_log, pitch);

  for (int idx = threadIdx.x; idx < (1 << TILE_LOG); idx += THREADS) {
    const int col = idx & (cols - 1);
    const int row = idx >> cols_log;
    base[(static_cast<int64_t>(row) << done) + col] = tile[row * pitch + col];
  }
}

size_t smem_bytes(int m) {
  const size_t pitch = pitch_for(TILE_LOG - m);
  return ((pitch << m) + (size_t{1} << (m - 1))) * sizeof(uint64_t);
}

}  // namespace

// Kernel launches one transform of size 2^log_n takes (0 if unsupported).
extern "C" int gl_ntt_passes(int log_n) {
  if (log_n < 1 || log_n > MAX_LOG_N) return 0;
  return plan(log_n).passes;
}

// in, out: (batch, 2^log_n) uint64, not aliased; tw: 2^(log_n - 1) powers of
// the root.
extern "C" int gl_ntt(const void* in, void* out, const void* tw, int64_t batch,
                      int log_n, void* stream) {
  if (log_n < 1 || log_n > MAX_LOG_N || batch < 1 || in == out)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = plan(log_n);
  const uint64_t* twp = static_cast<const uint64_t*>(tw);
  uint64_t* outp = static_cast<uint64_t*>(out);

  // above 48 KB a kernel must be allowed its dynamic shared memory; the
  // largest tile is the one 2^13-point pass with its 2^12 twiddles (96 KB)
  cudaError_t err = cudaFuncSetAttribute(
      first_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(TILE_LOG)));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      strided_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(TILE_LOG)));
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t total_cols = batch << (p.a + p.b);
  const int cols_log = TILE_LOG - p.c;
  const int64_t blocks = (total_cols + (int64_t{1} << cols_log) - 1) >> cols_log;
  const int64_t tiles = (batch << log_n) >> TILE_LOG;
  if (blocks > 0x7FFFFFFF || tiles > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  first_pass_kernel<<<static_cast<unsigned>(blocks), THREADS, smem_bytes(p.c), st>>>(
      static_cast<const uint64_t*>(in), outp, twp, total_cols, log_n, p.a, p.b,
      p.c);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (p.b > 0) {
    strided_pass_kernel<<<static_cast<unsigned>(tiles), THREADS, smem_bytes(p.b), st>>>(
        outp, twp, log_n, p.c, p.b);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (p.a > 0) {
    strided_pass_kernel<<<static_cast<unsigned>(tiles), THREADS, smem_bytes(p.a), st>>>(
        outp, twp, log_n, p.c + p.b, p.a);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
