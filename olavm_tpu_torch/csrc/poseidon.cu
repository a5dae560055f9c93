// K2: batched width-12 Poseidon permutation over (12, n) states.
//
// Replaces olavm_tpu/field/pallas_kernels.py:127 poseidon_permute_pallas
// (_poseidon_call :108, body _poseidon_kernel :98), which runs
// olavm_tpu/hash/poseidon.py:417 permute_stacked_gf_unrolled on blocks of
// 2048 lanes in VMEM: 4 full rounds, 22 partial rounds in the fast
// partial-MDS form, 4 full rounds.
//
// Design: one thread per state. The 12 words stay in registers for all 30
// rounds; the round constants and MDS tables live in __constant__ memory,
// where every thread of a warp reads the same word at the same time (a
// broadcast). State row i of lane t is in[i * n + t], so a warp's loads and
// stores of one row are coalesced.
//
// Bound: integer multiplies. A permutation reads and writes 192 bytes and
// does ~1,000 field multiplies (~4,000 64-bit multiply instructions), far
// above the card's operations-per-byte line, so the state never leaves
// registers; the MDS rows use the general field multiply (no small-constant
// shortcut) in this first version.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int WIDTH = 12;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 22;

__constant__ uint64_t c_rc[30 * WIDTH];            // ALL_ROUND_CONSTANTS
__constant__ uint64_t c_circ[WIDTH];               // MDS_MATRIX_CIRC
__constant__ uint64_t c_diag[WIDTH];               // MDS_MATRIX_DIAG
__constant__ uint64_t c_first[WIDTH];              // FAST_PARTIAL_FIRST_ROUND_CONSTANT
__constant__ uint64_t c_prc[PARTIAL];              // FAST_PARTIAL_ROUND_CONSTANTS
__constant__ uint64_t c_vs[PARTIAL * (WIDTH - 1)];  // FAST_PARTIAL_ROUND_VS
__constant__ uint64_t c_wh[PARTIAL * (WIDTH - 1)];  // FAST_PARTIAL_ROUND_W_HATS
__constant__ uint64_t c_init[(WIDTH - 1) * (WIDTH - 1)];  // ..._INITIAL_MATRIX

__device__ __forceinline__ void full_round(uint64_t* s, int r) {
  uint64_t t[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) t[i] = gl::pow7(gl::add(s[i], c_rc[r * WIDTH + i]));
#pragma unroll
  for (int r2 = 0; r2 < WIDTH; ++r2) {
    uint64_t acc = gl::mul(t[r2], c_diag[r2]);
#pragma unroll
    for (int j = 0; j < WIDTH; ++j)
      acc = gl::add(acc, gl::mul(t[j], c_circ[(j - r2 + WIDTH) % WIDTH]));
    s[r2] = acc;
  }
}

__global__ void permute_kernel(const uint64_t* __restrict__ in,
                               uint64_t* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       lane < n; lane += stride) {
    uint64_t s[WIDTH];
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) s[i] = in[i * n + lane];

    for (int r = 0; r < HALF_FULL; ++r) full_round(s, r);

    // partial rounds: first constant layer, then the initial dense matrix
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) s[i] = gl::add(s[i], c_first[i]);
    uint64_t t[WIDTH];
    t[0] = s[0];
#pragma unroll
    for (int c = 1; c < WIDTH; ++c) {
      uint64_t acc = 0;
#pragma unroll
      for (int r = 1; r < WIDTH; ++r)
        acc = gl::add(acc, gl::mul(s[r], c_init[(r - 1) * (WIDTH - 1) + (c - 1)]));
      t[c] = acc;
    }
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) s[i] = t[i];

    const uint64_t mds0to0 = c_circ[0] + c_diag[0];
    for (int r = 0; r < PARTIAL; ++r) {
      uint64_t s0 = gl::pow7(s[0]);
      if (r < PARTIAL - 1) s0 = gl::add(s0, c_prc[r]);
      uint64_t d = gl::mul(s0, mds0to0);
#pragma unroll
      for (int i = 1; i < WIDTH; ++i)
        d = gl::add(d, gl::mul(s[i], c_wh[r * (WIDTH - 1) + (i - 1)]));
#pragma unroll
      for (int i = 1; i < WIDTH; ++i)
        s[i] = gl::add(gl::mul(s0, c_vs[r * (WIDTH - 1) + (i - 1)]), s[i]);
      s[0] = d;
    }

    for (int r = HALF_FULL + PARTIAL; r < 2 * HALF_FULL + PARTIAL; ++r)
      full_round(s, r);

#pragma unroll
    for (int i = 0; i < WIDTH; ++i) out[i * n + lane] = s[i];
  }
}

}  // namespace

// Host pointers to the constant tables of olavm_tpu/hash/poseidon_constants.json
// (as canonical uint64), copied into __constant__ memory once per process.
extern "C" int gl_poseidon_init(const void* rc, const void* circ,
                                const void* diag, const void* first,
                                const void* prc, const void* vs,
                                const void* wh, const void* init) {
  cudaError_t e;
  if ((e = cudaMemcpyToSymbol(c_rc, rc, sizeof(c_rc))) != cudaSuccess) return e;
  if ((e = cudaMemcpyToSymbol(c_circ, circ, sizeof(c_circ))) != cudaSuccess) return e;
  if ((e = cudaMemcpyToSymbol(c_diag, diag, sizeof(c_diag))) != cudaSuccess) return e;
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
  const int threads = 128;
  permute_kernel<<<gl::grid_for(n, threads), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
