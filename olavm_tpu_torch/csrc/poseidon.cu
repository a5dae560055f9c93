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
// - poseidon_level replaces olavm_tpu/merkle/device.py:186 compress_digests:
//   one thread per parent permutes [left, right, 0, 0, 0, 0].
// Both are bound by operations, as K2 is: a leaf reads 8 bytes per absorbed
// element and a parent 64 bytes, against ~28,000 operations per
// permutation. The digests are (8, n) arrays of u32 words (lo, hi of each
// of the 4 elements), the layout of the blake3 digests, so the tree code
// is shared by the two hashers.
#include <cuda_runtime.h>

#include "poseidon_merkle.cuh"

namespace {

constexpr int THREADS = 128;
// blocks of THREADS per SM: at most 128 registers, which the kernel needs
// without spilling; 5 or 6 blocks (96, 80 registers) spill and run slower
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

// cols: (C, n) canonical elements, leaf t is column t; out: (8, n) words
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
leaves_kernel(const uint64_t* __restrict__ cols, uint64_t* __restrict__ out,
              int64_t n, int C) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < n; t += stride) {
    uint64_t s[poseidon::WIDTH];
    poseidon::sponge(cols + t, n, C, s);
    store_digest(out, n, t, s);
  }
}

// digests: (8, n) words, n even; out: (8, n / 2). Parent i compresses
// children 2i and 2i + 1, read as one 16-byte load per word row.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
level_kernel(const uint64_t* __restrict__ digests, uint64_t* __restrict__ out,
             int64_t n) {
  using poseidon::DIGEST;
  const int64_t parents = n >> 1;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < parents; i += stride) {
    uint64_t left[DIGEST], right[DIGEST], s[poseidon::WIDTH];
#pragma unroll
    for (int w = 0; w < DIGEST; ++w) {
      const ulonglong2 lo =
          *reinterpret_cast<const ulonglong2*>(digests + (2 * w) * n + 2 * i);
      const ulonglong2 hi =
          *reinterpret_cast<const ulonglong2*>(digests + (2 * w + 1) * n + 2 * i);
      left[w] = lo.x | (hi.x << 32);
      right[w] = lo.y | (hi.y << 32);
    }
    poseidon::two_to_one(left, right, s);
    store_digest(out, parents, i, s);
  }
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

// cols: (C, n) canonical elements; out: (8, n) digest words. Any C >= 1: the
// rule that a leaf of at most 4 elements is its own digest is the caller's.
extern "C" int gl_poseidon_leaves(const void* cols, void* out, int64_t n, int C,
                                  void* stream) {
  if (n < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  leaves_kernel<<<gl::grid_for(n, THREADS), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(cols), static_cast<uint64_t*>(out), n, C);
  return static_cast<int>(cudaGetLastError());
}

// digests: (8, n) words, n even, 16-byte aligned; out: (8, n / 2)
extern "C" int gl_poseidon_level(const void* digests, void* out, int64_t n,
                                 void* stream) {
  if (n < 2 || (n & 1) || (reinterpret_cast<uintptr_t>(digests) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  level_kernel<<<gl::grid_for(n >> 1, THREADS), THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(digests), static_cast<uint64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
