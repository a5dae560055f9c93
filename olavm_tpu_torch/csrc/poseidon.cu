// K2: batched width-12 Poseidon permutation over (12, n) states.
//
// Replaces olavm_tpu/field/pallas_kernels.py:127 poseidon_permute_pallas
// (_poseidon_call :108, body _poseidon_kernel :98), which runs
// olavm_tpu/hash/poseidon.py:417 permute_stacked_gf_unrolled on blocks of
// 2048 lanes in VMEM: 4 full rounds, 22 partial rounds in the fast
// partial-MDS form, 4 full rounds.
//
// Bound: integer operations. A permutation reads and writes 192 bytes and
// needs ~25,600 32-bit integer operations, far above the card's
// operations-per-byte line, so the state never leaves registers. The
// arithmetic is in poseidon_perm.cuh: small-constant MDS layers and dot
// products reduced once (see there). One thread per state (two per thread,
// for more independent instructions, needed 255 registers, spilled and ran
// slower): the 12 words stay in registers for all 30 rounds; the round
// constants and the partial rounds' tables live in __constant__ memory,
// where every thread of a warp reads the same word at the same time (a
// broadcast). State row i of lane t is in[i * n + t], so a warp's loads and
// stores of one row are coalesced.
//
// The same library holds the Poseidon Merkle kernels, so that they share
// K2's __constant__ tables and gl_poseidon_init:
// - poseidon_leaves replaces the leaf sponge of olavm_tpu/merkle/device.py:42
//   leaf_digests (a jnp chain of permute_gf there): one thread per leaf runs
//   the rate-8 overwrite sponge over its C elements, ceil(C / 8)
//   permutations with the 12 words in registers throughout;
// - poseidon_absorb is the same kernel streamed, for a commit that never
//   holds its whole LDE (olavm_tpu/merkle/device.py:106-183
//   leaf_stream_absorb): it absorbs one block of at most 16 LDE columns
//   (one or two permutations) into the (12, n) sponge states that the
//   leaf's earlier blocks left in device memory, and writes them back, or
//   the digests after the leaf's last block;
// - poseidon_level replaces olavm_tpu/merkle/device.py:186 compress_digests:
//   one thread per parent permutes [left, right, 0, 0, 0, 0].
// Both are bound by operations, as K2 is: a leaf reads 8 bytes per absorbed
// element and a parent 64 bytes, against ~28,000 operations per
// permutation. The digests are (8, n) arrays of u32 words (lo, hi of each
// of the 4 elements), the layout of the blake3 digests, so the tree code
// is shared by the two hashers.
// Where a thread runs many permutations, the warps of an SM drift apart in
// the permutation's code, and fetching the instructions of many places at
// once, not the pipes, sets the pace: over a capped grid of small blocks
// these kernels ran the permutation slower the more of them each thread
// ran, where K2 runs one per thread in step with its neighbours (PERF.md
// §6). So for large inputs each kernel runs one block of BIG_THREADS (20
// warps, five per scheduler) per SM over a persistent grid, with a barrier
// after every permutation: the warps of an SM fetch the same code at the
// same time. A thread's next chunk (leaves) or pair of digests (level) is
// copied into shared memory with cp.async while it permutes the current
// one, into a second buffer, so that no load waits in line before a
// permutation and no register holds it. Below BIG_MIN_PER_SM items per SM
// a grid of such blocks would leave SMs idle, and blocks of SMALL_THREADS
// without barriers, five per SM, run instead.
#include <cuda_runtime.h>

#include "poseidon_merkle.cuh"

namespace {

constexpr int THREADS = 128;
// blocks of THREADS per SM: at most 128 registers a thread, no spills
constexpr int MIN_BLOCKS = 4;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
permute_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
               int64_t n) {
  using poseidon::WIDTH;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       lane < n; lane += stride) {
    uint64_t s[WIDTH];
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) s[i] = in[i * n + lane];
    poseidon::permute(s);
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) out[i * n + lane] = s[i];
  }
}

// words 0-3 of s as digest j of an (8, n) u32-word array: element w's low
// half at row 2w, its high half at row 2w + 1
__device__ __forceinline__ void store_digest(uint64_t* out, int64_t n,
                                             int64_t j, const uint64_t* s) {
#pragma unroll
  for (int w = 0; w < poseidon::DIGEST; ++w) {
    out[(2 * w) * n + j] = s[w] & 0xFFFFFFFFull;
    out[(2 * w + 1) * n + j] = s[w] >> 32;
  }
}

// the Merkle kernels' two launch shapes (see the note at the top)
constexpr int BIG_THREADS = 640;
constexpr int SMALL_THREADS = 128;
// items per SM from which the big shape runs: half of its threads have an
// item (below that the small shape was the faster one on the H100)
constexpr int BIG_MIN_PER_SM = BIG_THREADS / 2;

__device__ __forceinline__ void cp_async8(uint64_t* dst, const uint64_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most one group of this thread's copies is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// chunk c (k elements) of leaf t into this thread's column of buf
template <int BLOCK>
__device__ __forceinline__ void stage_chunk(uint64_t (*buf)[BLOCK],
                                            const uint64_t* cols, int64_t n,
                                            int64_t t, int c, int k) {
  using poseidon::RATE;
  if (t < n) {
    const uint64_t* src = cols + static_cast<int64_t>(c) * RATE * n + t;
    uint64_t* dst = &buf[0][threadIdx.x];
    if (k == RATE) {
#pragma unroll
      for (int i = 0; i < RATE; ++i) cp_async8(dst + i * BLOCK, src + i * n);
    } else {
#pragma unroll
      for (int i = 0; i < RATE; ++i)
        if (i < k) cp_async8(dst + i * BLOCK, src + i * n);
    }
  }
  cp_async_commit();
}

// cols: (C, n) canonical elements, leaf t is column t. Each leaf's sponge
// starts from row t of the (12, n) states state_in, or from zero where
// state_in is nullptr; its final state goes to state_out and its digest to
// the (8, n) words digest_out, each where not nullptr. state_in and
// state_out may be one array (a thread reads and writes only its own
// leaf's column), so neither is __restrict__. The loops are the same for
// every thread of a block (a thread past n permutes what its buffer holds
// and stores nothing), as the big shape's barrier needs.
template <int BLOCK>
__global__ void __launch_bounds__(BLOCK, BIG_THREADS / BLOCK)
leaves_kernel(const uint64_t* __restrict__ cols, int64_t n, int C,
              const uint64_t* state_in, uint64_t* state_out,
              uint64_t* __restrict__ digest_out) {
  using poseidon::RATE;
  using poseidon::WIDTH;
  extern __shared__ uint64_t leaves_buf[];  // [2][RATE][BLOCK]
  auto buf = reinterpret_cast<uint64_t (*)[RATE][BLOCK]>(leaves_buf);
  const int chunks = (C + RATE - 1) / RATE;
  const int last = C - (chunks - 1) * RATE;  // elements in the last chunk
  const int64_t stride = static_cast<int64_t>(gridDim.x) * BLOCK;
  int64_t base = static_cast<int64_t>(blockIdx.x) * BLOCK;
  int b = 0;
  stage_chunk<BLOCK>(buf[0], cols, n, base + threadIdx.x, 0,
                     chunks == 1 ? last : RATE);
  for (; base < n; base += stride) {
    const int64_t t = base + threadIdx.x;
    uint64_t s[WIDTH];
    if (state_in != nullptr && t < n) {
#pragma unroll
      for (int i = 0; i < WIDTH; ++i) s[i] = state_in[i * n + t];
    } else {
#pragma unroll
      for (int i = 0; i < WIDTH; ++i) s[i] = 0;
    }
#pragma unroll 1
    for (int c = 0; c < chunks; ++c) {
      // the next chunk: of this leaf, or the first of the next leaf
      if (c + 1 < chunks)
        stage_chunk<BLOCK>(buf[b ^ 1], cols, n, t, c + 1,
                           c + 2 == chunks ? last : RATE);
      else
        stage_chunk<BLOCK>(buf[b ^ 1], cols, n, t + stride, 0,
                           chunks == 1 ? last : RATE);
      cp_async_wait_one();
      poseidon::absorb(s, &buf[b][0][threadIdx.x], BLOCK,
                       c + 1 == chunks ? last : RATE);
      poseidon::permute(s);
      if (BLOCK == BIG_THREADS) __syncthreads();
      b ^= 1;
    }
    if (t < n) {
      if (state_out != nullptr) {
#pragma unroll
        for (int i = 0; i < WIDTH; ++i) state_out[i * n + t] = s[i];
      }
      if (digest_out != nullptr) store_digest(digest_out, n, t, s);
    }
  }
  cp_async_wait_all();
}

// the two children of parent i, each word row's pair as one 16-byte copy
template <int BLOCK>
__device__ __forceinline__ void stage_pair(ulonglong2 (*buf)[BLOCK],
                                           const uint64_t* digests, int64_t n,
                                           int64_t i) {
  if (i < (n >> 1)) {
#pragma unroll
    for (int w = 0; w < 2 * poseidon::DIGEST; ++w)
      cp_async16(&buf[w][threadIdx.x], digests + w * n + 2 * i);
  }
  cp_async_commit();
}

// digests: (8, n) words, n even; out: (8, n / 2). Parent i compresses
// children 2i and 2i + 1.
template <int BLOCK>
__global__ void __launch_bounds__(BLOCK, BIG_THREADS / BLOCK)
level_kernel(const uint64_t* __restrict__ digests, uint64_t* __restrict__ out,
             int64_t n) {
  using poseidon::DIGEST;
  extern __shared__ ulonglong2 level_buf[];  // [2][2 * DIGEST][BLOCK]
  auto buf = reinterpret_cast<ulonglong2 (*)[2 * DIGEST][BLOCK]>(level_buf);
  const int64_t parents = n >> 1;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * BLOCK;
  int64_t base = static_cast<int64_t>(blockIdx.x) * BLOCK;
  int b = 0;
  stage_pair<BLOCK>(buf[0], digests, n, base + threadIdx.x);
  for (; base < parents; base += stride) {
    const int64_t i = base + threadIdx.x;
    stage_pair<BLOCK>(buf[b ^ 1], digests, n, i + stride);
    cp_async_wait_one();
    uint64_t left[DIGEST], right[DIGEST], s[poseidon::WIDTH];
#pragma unroll
    for (int w = 0; w < DIGEST; ++w) {
      const ulonglong2 lo = buf[b][2 * w][threadIdx.x];
      const ulonglong2 hi = buf[b][2 * w + 1][threadIdx.x];
      left[w] = lo.x | (hi.x << 32);
      right[w] = lo.y | (hi.y << 32);
    }
    poseidon::two_to_one(left, right, s);
    if (BLOCK == BIG_THREADS) __syncthreads();
    if (i < parents) store_digest(out, parents, i, s);
    b ^= 1;
  }
  cp_async_wait_all();
}

template <int BLOCK>
constexpr int leaves_smem() { return 2 * poseidon::RATE * BLOCK * 8; }
template <int BLOCK>
constexpr int level_smem() { return 2 * 2 * poseidon::DIGEST * BLOCK * 16; }

// SMs of the current device; 0 if it cannot be read
int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

// a persistent grid for `items` over blocks of `threads`, `per_sm` of them
// resident on each of `sms` SMs
unsigned persistent_grid(int64_t items, int threads, int per_sm, int sms) {
  const int64_t blocks = (items + threads - 1) / threads;
  const int64_t cap = static_cast<int64_t>(sms) * per_sm;
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}

}  // namespace

// Host pointers to the constant tables of poseidon_constants.json (as
// canonical uint64), copied into __constant__ memory once per process. The
// MDS tables are compiled into the kernel: if circ or diag differ from them,
// returns -1 and copies nothing.
extern "C" int gl_poseidon_init(const void* rc, const void* circ,
                                const void* diag, const void* first,
                                const void* prc, const void* vs,
                                const void* wh, const void* init) {
  using namespace poseidon;
  if (mds_mismatch(static_cast<const uint64_t*>(circ),
                   static_cast<const uint64_t*>(diag)))
    return -1;
  cudaError_t e;
  if ((e = cudaMemcpyToSymbol(c_rc, rc, sizeof(c_rc))) != cudaSuccess) return e;
  if ((e = cudaMemcpyToSymbol(c_first, first, sizeof(c_first))) != cudaSuccess) return e;
  if ((e = cudaMemcpyToSymbol(c_prc, prc, sizeof(c_prc))) != cudaSuccess) return e;
  if ((e = cudaMemcpyToSymbol(c_vs, vs, sizeof(c_vs))) != cudaSuccess) return e;
  if ((e = cudaMemcpyToSymbol(c_wh, wh, sizeof(c_wh))) != cudaSuccess) return e;
  if ((e = cudaMemcpyToSymbol(c_init, init, sizeof(c_init))) != cudaSuccess) return e;
  // above 48 KB a block's dynamic shared memory must be allowed first
  if ((e = cudaFuncSetAttribute(leaves_kernel<BIG_THREADS>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                leaves_smem<BIG_THREADS>())) != cudaSuccess)
    return e;
  if ((e = cudaFuncSetAttribute(level_kernel<BIG_THREADS>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                level_smem<BIG_THREADS>())) != cudaSuccess)
    return e;
  return 0;
}

// in, out: (12, n) uint64 states, row-major.
extern "C" int gl_poseidon_permute(const void* in, void* out, int64_t n,
                                   void* stream) {
  permute_kernel<<<gl::grid_for(n, THREADS), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// the leaf kernel in the launch shape for n leaves
static int launch_leaves(const void* cols, int64_t n, int C, const void* state_in,
                  void* state_out, void* digest_out, void* stream) {
  if (n < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  const auto in = static_cast<const uint64_t*>(cols);
  const auto s_in = static_cast<const uint64_t*>(state_in);
  const auto s_out = static_cast<uint64_t*>(state_out);
  const auto d_out = static_cast<uint64_t*>(digest_out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (n >= static_cast<int64_t>(sms) * BIG_MIN_PER_SM)
    leaves_kernel<BIG_THREADS>
        <<<persistent_grid(n, BIG_THREADS, 1, sms), BIG_THREADS,
           leaves_smem<BIG_THREADS>(), st>>>(in, n, C, s_in, s_out, d_out);
  else
    leaves_kernel<SMALL_THREADS>
        <<<persistent_grid(n, SMALL_THREADS, BIG_THREADS / SMALL_THREADS, sms),
           SMALL_THREADS, leaves_smem<SMALL_THREADS>(), st>>>(in, n, C, s_in,
                                                                s_out, d_out);
  return static_cast<int>(cudaGetLastError());
}

// cols: (C, n) canonical elements; out: (8, n) digest words. Any C >= 1: the
// rule that a leaf of at most 4 elements is its own digest is the caller's.
extern "C" int gl_poseidon_leaves(const void* cols, void* out, int64_t n, int C,
                                  void* stream) {
  return launch_leaves(cols, n, C, nullptr, nullptr, out, stream);
}

// The streamed leaf sponge (olavm_tpu/merkle/device.py:106-183
// leaf_stream_absorb, its Poseidon half): absorb a block of W columns, (W,
// n), into the (12, n) sponge states that the leaf's earlier blocks left
// (state_in; nullptr for the first block, which starts from zero), in
// chunks of 8 (only a leaf's last block may end in a shorter chunk). The
// states go to state_out (it may be state_in) and, for a leaf's last
// block, the digests to the (8, n) words digest_out; either may be nullptr.
extern "C" int gl_poseidon_absorb(const void* block, const void* state_in,
                                  void* state_out, void* digest_out, int64_t n,
                                  int W, void* stream) {
  if (W > 16) return static_cast<int>(cudaErrorInvalidValue);
  return launch_leaves(block, n, W, state_in, state_out, digest_out, stream);
}

// digests: (8, n) words, n even, 16-byte aligned; out: (8, n / 2)
extern "C" int gl_poseidon_level(const void* digests, void* out, int64_t n,
                                 void* stream) {
  if (n < 2 || (n & 1) || (reinterpret_cast<uintptr_t>(digests) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  const auto in = static_cast<const uint64_t*>(digests);
  const auto o = static_cast<uint64_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const int64_t parents = n >> 1;
  if (parents >= static_cast<int64_t>(sms) * BIG_MIN_PER_SM)
    level_kernel<BIG_THREADS>
        <<<persistent_grid(parents, BIG_THREADS, 1, sms), BIG_THREADS,
           level_smem<BIG_THREADS>(), st>>>(in, o, n);
  else
    level_kernel<SMALL_THREADS>
        <<<persistent_grid(parents, SMALL_THREADS, BIG_THREADS / SMALL_THREADS, sms),
           SMALL_THREADS, level_smem<SMALL_THREADS>(), st>>>(in, o, n);
  return static_cast<int>(cudaGetLastError());
}
