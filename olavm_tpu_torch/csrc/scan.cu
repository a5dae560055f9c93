// K8: the grand-product scan, the inclusive (or exclusive) modular prefix
// product along each row of a contiguous (rows, n) array.
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
// multiplies its predecessors' values does not change the result.
// - A block takes the next tile of TILE points from an atomic counter, not
//   from blockIdx: blocks are not scheduled in order, and a look-back that
//   waited on a tile no running block holds would never end. Tiles are
//   numbered row by row, so every tile a block waits on is held by a block
//   that started earlier and waits on none later.
// - It loads the tile coalesced into shared memory; each thread scans its
//   ITEMS consecutive points in registers, warp shuffles scan the threads'
//   products, and one thread the warps'.
// - It publishes the tile's product (flag AGGREGATE), then warp 0 looks
//   back over the row's earlier tiles 32 at a time, multiplying their
//   products until it meets one that has published its inclusive prefix
//   (flag PREFIX), and publishes its own; the first tile of a row publishes
//   its prefix at once. A value is written before its flag (release) and
//   read after it (acquire).
// - Each point times its thread's, warp's and tile's exclusive prefix goes
//   back through shared memory and is stored coalesced, one place later in
//   the exclusive form, whose first value is 1.
// The counter, the flags, the products and the prefixes are scratch that
// the caller allocates and zeroes in its stream before each launch, so that
// the launch can be captured into a CUDA graph (no allocation, no host
// read). Bound: device memory, 16 bytes a point (8 read, 8 written);
// about 2 products a point.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint64_t AGGREGATE = 1, PREFIX = 2;

// a tile's point j in shared memory, one pad word after every 16: thread t
// reads its ITEMS consecutive points with few bank conflicts
__device__ __forceinline__ int pad(int j) { return j + (j >> 4); }
constexpr int SMEM_WORDS = TILE + TILE / 16;

__device__ __forceinline__ void store_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t load_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t load_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ uint64_t shfl_up(uint64_t v, int d) {
  return __shfl_up_sync(FULL, static_cast<unsigned long long>(v), d);
}

__device__ __forceinline__ uint64_t shfl_xor(uint64_t v, int d) {
  return __shfl_xor_sync(FULL, static_cast<unsigned long long>(v), d);
}

// state: [counter, flag[tiles], aggregate[tiles], prefix[tiles]], the
// counter and flags 0 at the launch
__global__ void __launch_bounds__(THREADS)
    scan_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ out,
                uint64_t* __restrict__ state, int64_t n,
                int64_t tiles_per_row, int64_t tiles, int exclusive) {
  __shared__ uint64_t s[SMEM_WORDS];
  // each warp's product, then its exclusive prefix in the tile
  __shared__ uint64_t warp_pre[WARPS];
  // the tile's exclusive prefix in its row
  __shared__ uint64_t tile_pre;
  __shared__ int64_t tile_id;
  uint64_t* const flag = state + 1;
  uint64_t* const aggregate = flag + tiles;
  uint64_t* const prefix = aggregate + tiles;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0)
    tile_id = static_cast<int64_t>(
        atomicAdd(reinterpret_cast<unsigned long long*>(state), 1ull));
  __syncthreads();
  const int64_t tile = tile_id;
  const int64_t row = tile / tiles_per_row, part = tile % tiles_per_row;
  const int64_t first_tile = tile - part;  // the row's first tile
  const uint64_t* const src = x + row * n;
  uint64_t* const dst = out + row * n;
  const int64_t base = part * TILE;

  // coalesced load; points past the row's end are 1
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int k = j * THREADS + tid;
    const int64_t i = base + k;
    s[pad(k)] = i < n ? __ldg(src + i) : 1;
  }
  __syncthreads();
  uint64_t v[ITEMS];
  v[0] = s[pad(tid * ITEMS)];
#pragma unroll
  for (int j = 1; j < ITEMS; ++j)
    v[j] = gl::mul(v[j - 1], s[pad(tid * ITEMS + j)]);
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
      // windows of 32 earlier tiles, lane 0 the nearest; the row's first
      // tile has a prefix, so no window reaches past it
      for (int64_t nearest = tile - 1;; nearest -= 32) {
        const int64_t p = nearest - lane;
        uint64_t f;
        do {
          f = p >= first_tile ? load_acquire(flag + p) : PREFIX;
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

  const uint64_t pre = gl::mul(gl::mul(tile_pre, warp_pre[warp]), lane_pre);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) s[pad(tid * ITEMS + j)] = gl::mul(pre, v[j]);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int k = j * THREADS + tid;
    const int64_t i = base + k + exclusive;
    if (i < n) dst[i] = s[pad(k)];
  }
  if (exclusive && part == 0 && tid == 0) dst[0] = 1;
}

}  // namespace

// The scratch words a launch over (rows, n) needs (zeroed by the caller).
extern "C" int64_t gl_prefix_prod_state_words(int64_t rows, int64_t n) {
  return 1 + 3 * rows * ((n + TILE - 1) / TILE);
}

// x, out: (rows, n), contiguous; state: gl_prefix_prod_state_words(rows, n)
// zeroed words (fewer are refused); exclusive: 0 or 1
extern "C" int gl_prefix_prod(const void* x, void* out, void* state,
                              int64_t state_words, int64_t rows, int64_t n,
                              int exclusive, void* stream) {
  const int64_t tiles_per_row = (n + TILE - 1) / TILE;
  const int64_t tiles = rows * tiles_per_row;
  if (rows < 0 || n < 0 || state_words < gl_prefix_prod_state_words(rows, n) ||
      tiles > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tiles == 0) return 0;
  scan_kernel<<<static_cast<unsigned>(tiles), THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(x), static_cast<uint64_t*>(out),
      static_cast<uint64_t*>(state), n, tiles_per_row, tiles,
      exclusive ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
