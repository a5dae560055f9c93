// K8: the grand-product scan, the inclusive (or exclusive) modular prefix
// product along each row of a contiguous (rows, n) array, in place or into
// another array.
//
// Replaces no Pallas kernel: olavm_tpu scans with jnp, a Hillis-Steele
// loop of log2 n shift-and-multiply steps (olavm_tpu/field/gf.py:317
// prefix_prod), which the port ran as log2 n x (fill + cat + K3) launches,
// each step reading 16 bytes and writing 8 a point; the exclusive form (the
// permutation argument's Z, olavm_tpu/stark/ctl_device.py:199) took one
// more cat.
//
// One pass with decoupled look-back (Merrill and Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", 2016), the field's
// product as the operator. It commutes, so the order in which a tile
// multiplies its predecessors' values does not change the result. The
// callers scan a table's grand products together: a (Z, n) array of all
// the CTL Zs of a table (CpuStark's 78 rows of 2^20), or of all its
// permutation batches, in one launch.
// - A block takes the next tile of TILE points from an atomic counter, not
//   from blockIdx: blocks are not scheduled in order, and a look-back that
//   waited on a tile no running block holds would never end. Tile t is
//   part t / rows of row t % rows: every tile a block waits on (an earlier
//   part of its row) is held by a block that started earlier and waits on
//   none later, and the tiles in flight at once are spread over the rows,
//   so that a look-back over a row of a (Z, n) launch meets a published
//   prefix within a few tiles (with the rows in order, the hundreds of
//   tiles in flight would sit in one or two rows and look back over long
//   chains).
// - Each warp of a tile loads its 32 ITEMS points with 16-byte vector
//   loads, neighbouring lanes on neighbouring words (each load
//   instruction covers 512 contiguous bytes), into shared memory, from
//   where thread t takes its ITEMS consecutive points (a pad word after
//   every ITEMS keeps the reads free of bank conflicts) and scans them in
//   registers; warp shuffles scan the threads' products, and one thread
//   the warps'. Where a row is not 16-byte aligned (n odd) a thread loads
//   its own points with 8-byte loads. (Unstaged, a thread's own 16-byte
//   loads would read each 32-byte sector in two instructions; they ran
//   slower on an H100.)
// - It publishes the tile's product (flag AGGREGATE), then warp 0 looks
//   back over the row's earlier tiles 32 at a time, multiplying their
//   products until it meets one that has published its inclusive prefix
//   (flag PREFIX), and publishes its own; the first tile of a row publishes
//   its prefix at once. A value is written before its flag (release) and
//   read after it (acquire).
// - Each thread multiplies its points by its thread's, warp's and tile's
//   exclusive prefix and they go back the way they came: through shared
//   memory, stored by the warp as 16-byte vectors. The exclusive form
//   stores at point i the inclusive product of the points before it, which
//   the thread holds or is its prefix (at its first point), so a tile
//   writes only the points it read: either form may scan in place
//   (out == x).
// The counter and the flags are scratch that the caller zeroes in its
// stream before each launch (the products and prefixes are written before
// their flags and need no zeroing), so that the launch can be captured into
// a CUDA graph (no allocation, no host read). Bound: device memory, 16 bytes
// a point (8 read, 8 written); about 2 products a point.
//
// The kernel calls only goldilocks.cuh's gl:: helpers, warp intrinsics and
// the helpers below, each with a host twin: with the CUDA qualifiers, the
// barrier and the warp intrinsics stubbed, a host compiler builds this
// namespace and runs a launch's blocks one after another in the counter's
// order, each block's threads side by side (tests/test_torch_inv_scan.py).
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace scan {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint64_t AGGREGATE = 1, PREFIX = 2;
// a point's place in the staging: a pad word after every ITEMS
__device__ __forceinline__ int pad(int k) { return k + k / ITEMS; }

__device__ __forceinline__ void store_release(uint64_t* p, uint64_t v) {
#ifdef __CUDA_ARCH__
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
#else
  __atomic_store_n(p, v, __ATOMIC_RELEASE);
#endif
}

__device__ __forceinline__ uint64_t load_acquire(const uint64_t* p) {
#ifdef __CUDA_ARCH__
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
#else
  return __atomic_load_n(p, __ATOMIC_ACQUIRE);
#endif
}

__device__ __forceinline__ void store_relaxed(uint64_t* p, uint64_t v) {
#ifdef __CUDA_ARCH__
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
#else
  __atomic_store_n(p, v, __ATOMIC_RELAXED);
#endif
}

__device__ __forceinline__ uint64_t load_relaxed(const uint64_t* p) {
#ifdef __CUDA_ARCH__
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
#else
  return __atomic_load_n(p, __ATOMIC_RELAXED);
#endif
}

// the next tile of the launch
__device__ __forceinline__ int64_t next_tile(uint64_t* counter) {
#ifdef __CUDA_ARCH__
  return static_cast<int64_t>(
      atomicAdd(reinterpret_cast<unsigned long long*>(counter), 1ull));
#else
  return static_cast<int64_t>(__atomic_fetch_add(counter, 1, __ATOMIC_RELAXED));
#endif
}

__device__ __forceinline__ uint64_t shfl_up(uint64_t v, int d) {
  return __shfl_up_sync(FULL, static_cast<unsigned long long>(v), d);
}

__device__ __forceinline__ uint64_t shfl_xor(uint64_t v, int d) {
  return __shfl_xor_sync(FULL, static_cast<unsigned long long>(v), d);
}

// a pair of points [i, i + 1) as one 16-byte word
struct alignas(16) Pair {
  uint64_t a, b;
};

// state: [counter, flag[tiles], aggregate[tiles], prefix[tiles]], the
// counter and flags 0 at the launch, tile t's words at t. VEC: rows and
// pointers 16-byte aligned (n even), so a warp's points move as pairs.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    scan_kernel(const uint64_t* x, uint64_t* out, uint64_t* state, int64_t n,
                int64_t rows, int64_t tiles, int exclusive) {
  // each warp's product, then its exclusive prefix in the tile
  __shared__ uint64_t warp_pre[WARPS];
  // the tile's exclusive prefix in its row
  __shared__ uint64_t tile_pre;
  __shared__ int64_t tile_id;
  __shared__ uint64_t stage[TILE + TILE / ITEMS];
  uint64_t* const flag = state + 1;
  uint64_t* const aggregate = flag + tiles;
  uint64_t* const prefix = aggregate + tiles;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) tile_id = next_tile(state);
  __syncthreads();
  const int64_t tile = tile_id;
  const int64_t row = tile % rows, part = tile / rows;
  const uint64_t* const src = x + row * n;
  uint64_t* const dst = out + row * n;
  // the thread's first point in its row
  const int64_t first = part * TILE + static_cast<int64_t>(tid) * ITEMS;

  // the warp's 32 ITEMS points: lane l moves pairs at 2 l + 64 k, then
  // each thread reads its ITEMS consecutive ones from shared memory
  const int seg = warp * 32 * ITEMS;
  uint64_t v[ITEMS];
  if constexpr (VEC) {
#pragma unroll
    for (int k = 0; k < ITEMS / 2; ++k) {
      const int kk = seg + 2 * lane + 64 * k;
      const int64_t i = part * TILE + kk;
      Pair p = {1, 1};
      if (i < n) p = *reinterpret_cast<const Pair*>(src + i);
      stage[pad(kk)] = p.a;
      stage[pad(kk + 1)] = p.b;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) v[j] = stage[pad(tid * ITEMS + j)];
    __syncwarp();
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int64_t i = first + j;
      v[j] = i < n ? src[i] : 1;
    }
  }
#pragma unroll
  for (int j = 1; j < ITEMS; ++j) v[j] = gl::mul(v[j - 1], v[j]);
  // the warp's inclusive scan of its threads' products
  uint64_t y = v[ITEMS - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint64_t up = shfl_up(y, d);
    if (lane >= d) y = gl::mul(y, up);
  }
  uint64_t lane_pre = shfl_up(y, 1);
  if (lane == 0) lane_pre = 1;
  if (lane == 31) warp_pre[warp] = y;
  __syncthreads();

  if (warp == 0) {
    uint64_t total = 1;
    if (lane == 0) {
      for (int w = 0; w < WARPS; ++w) {
        const uint64_t p = warp_pre[w];
        warp_pre[w] = total;
        total = gl::mul(total, p);
      }
    }
    total = __shfl_sync(FULL, static_cast<unsigned long long>(total), 0);
    uint64_t before = 1;  // the product of the row's earlier tiles
    if (part == 0) {
      if (lane == 0) {
        store_relaxed(prefix + tile, total);
        store_release(flag + tile, PREFIX);
      }
    } else {
      if (lane == 0) {
        store_relaxed(aggregate + tile, total);
        store_release(flag + tile, AGGREGATE);
      }
      // windows of the row's 32 earlier tiles (parts), lane 0 the nearest;
      // the row's first tile has a prefix, so no window reaches past it
      for (int64_t nearest = part - 1;; nearest -= 32) {
        const int64_t p = (nearest - lane) * rows + row;
        uint64_t f;
        do {
          f = nearest - lane >= 0 ? load_acquire(flag + p) : PREFIX;
        } while (__any_sync(FULL, f == 0));
        const unsigned prefixes = __ballot_sync(FULL, f == PREFIX);
        // the nearest tile with a prefix: it and the tiles after it count
        const int stop = prefixes ? __ffs(prefixes) - 1 : 32;
        uint64_t val = 1;
        if (lane < stop) val = load_relaxed(aggregate + p);
        else if (lane == stop) val = load_relaxed(prefix + p);
#pragma unroll
        for (int d = 16; d; d >>= 1) val = gl::mul(val, shfl_xor(val, d));
        before = gl::mul(before, val);
        if (prefixes) break;
      }
      if (lane == 0) {
        store_relaxed(prefix + tile, gl::mul(before, total));
        store_release(flag + tile, PREFIX);
      }
    }
    if (lane == 0) tile_pre = before;
  }
  __syncthreads();

  // the product of the row's points before the thread's first
  const uint64_t pre = gl::mul(gl::mul(tile_pre, warp_pre[warp]), lane_pre);
  uint64_t w[ITEMS];
  if (exclusive) {
    w[0] = pre;
#pragma unroll
    for (int j = 1; j < ITEMS; ++j) w[j] = gl::mul(pre, v[j - 1]);
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) w[j] = gl::mul(pre, v[j]);
  }
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) stage[pad(tid * ITEMS + j)] = w[j];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < ITEMS / 2; ++k) {
      const int kk = seg + 2 * lane + 64 * k;
      const int64_t i = part * TILE + kk;
      if (i < n)
        *reinterpret_cast<Pair*>(dst + i) = {stage[pad(kk)], stage[pad(kk + 1)]};
    }
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int64_t i = first + j;
      if (i < n) dst[i] = w[j];
    }
  }
}

inline int64_t tiles_per_row(int64_t n) { return (n + TILE - 1) / TILE; }

}  // namespace scan

// The scratch words a launch over (rows, n) needs; the first
// gl_prefix_prod_zeroed_words(rows, n) of them zeroed by the caller.
extern "C" int64_t gl_prefix_prod_state_words(int64_t rows, int64_t n) {
  return 1 + 3 * rows * scan::tiles_per_row(n);
}

extern "C" int64_t gl_prefix_prod_zeroed_words(int64_t rows, int64_t n) {
  return 1 + rows * scan::tiles_per_row(n);
}

// x, out: (rows, n), contiguous, the same array or disjoint; state:
// gl_prefix_prod_state_words(rows, n) words (fewer are refused), the first
// gl_prefix_prod_zeroed_words(rows, n) zeroed; exclusive: 0 or 1
extern "C" int gl_prefix_prod(const void* x, void* out, void* state,
                              int64_t state_words, int64_t rows, int64_t n,
                              int exclusive, void* stream) {
  const int64_t tiles = rows * scan::tiles_per_row(n);
  if (rows < 0 || n < 0 || state_words < gl_prefix_prod_state_words(rows, n) ||
      tiles > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tiles == 0) return 0;
  const bool vec = n % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const uint64_t*>(x);
  auto* os = static_cast<uint64_t*>(out);
  auto* st = static_cast<uint64_t*>(state);
  const unsigned grid = static_cast<unsigned>(tiles);
  if (vec)
    scan::scan_kernel<true><<<grid, scan::THREADS, 0, s>>>(
        xs, os, st, n, rows, tiles, exclusive ? 1 : 0);
  else
    scan::scan_kernel<false><<<grid, scan::THREADS, 0, s>>>(
        xs, os, st, n, rows, tiles, exclusive ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
