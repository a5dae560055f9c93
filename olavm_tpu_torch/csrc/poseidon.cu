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
#include <cuda_runtime.h>

#include "poseidon_perm.cuh"

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
