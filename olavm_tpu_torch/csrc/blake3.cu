// K4: blake3 Merkle hashing on the card: leaf digests and tree levels.
//
// Replaces the jnp hashing of olavm_tpu/hash/blake3.py:58 compress and :152
// two_to_one_words as olavm_tpu/merkle/device.py:106-238 drives them (leaf
// absorb over column blocks, then one compression per tree node); the JAX
// package leaves those to XLA, here they are two hand-written kernels.
//
// A batch of n leaves of C field elements is a (C, n) uint64 array (leaf i
// is column i); a digest batch is (8, n) uint64 holding one u32 word each
// (high half zero), the layout the Merkle code keeps. A leaf is hashed as
// its 8 C little-endian bytes, so column k gives message words 2k (low
// half) and 2k + 1 (high half), eight columns per 64-byte block.
//
// Design: one thread per leaf (or per parent). The 8-word chaining value,
// the 16 message words and the 16-word state are uint32 registers; the seven
// rounds are unrolled, the message permutation between rounds is a renaming
// of registers resolved at compile time, and rotates are funnel shifts.
// Neighbouring threads read neighbouring leaves of one column, so loads are
// coalesced in the (C, n) layout as it is, and each digest word is stored
// coalesced. blake3_level reads the two children of a parent as one 16-byte
// load per word.
//
// Bound: integer operations for the leaves (a compression is 7 x 8 G
// functions of 12 32-bit instructions each, the three-term adds being one
// instruction, ~680 per 64 input bytes, above the card's operations-per-byte
// line); device memory for a tree level (192 bytes per compression).
//
// blake3_absorb is the streamed form of the leaf kernel, for a commit that
// never holds its whole LDE (olavm_tpu/merkle/device.py:106-183
// leaf_stream_absorb, as olavm_tpu/stark/oracle_device.py:152-241 drives it):
// it absorbs one block of at most 16 LDE columns (one or two 64-byte
// message blocks) into the (8, n) chaining values that the previous block
// left, taking the blocks' flags, lengths and chunk counters as arguments,
// so that one kernel serves every block position. Given the first chunk's
// chaining values, it also ends a two-chunk leaf with the PARENT | ROOT
// compression. Per leaf it moves the 64 bytes of the state in and out besides
// the block, so a 16-column block is bound by device memory (256 bytes
// against two compressions).
#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"  // gl::grid_for

namespace {

constexpr uint32_t CHUNK_START = 1, CHUNK_END = 2, PARENT = 4, ROOT = 8;
constexpr int CHUNK_BLOCKS = 16;  // 64-byte blocks per 1024-byte chunk
constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ void g(uint32_t& a, uint32_t& b, uint32_t& c,
                                  uint32_t& d, uint32_t x, uint32_t y) {
  a = a + b + x;
  d = rotr(d ^ a, 16);
  c = c + d;
  b = rotr(b ^ c, 12);
  a = a + b + y;
  d = rotr(d ^ a, 8);
  c = c + d;
  b = rotr(b ^ c, 7);
}

__device__ __forceinline__ void set_iv(uint32_t (&cv)[8]) {
  cv[0] = 0x6A09E667u; cv[1] = 0xBB67AE85u; cv[2] = 0x3C6EF372u;
  cv[3] = 0xA54FF53Au; cv[4] = 0x510E527Fu; cv[5] = 0x9B05688Cu;
  cv[6] = 0x1F83D9ABu; cv[7] = 0x5BE0CD19u;
}

// cv <- compress(cv, m, counter, block_len, flags); m is left permuted.
__device__ __forceinline__ void compress(uint32_t (&cv)[8], uint32_t (&m)[16],
                                         uint32_t counter, uint32_t block_len,
                                         uint32_t flags) {
  uint32_t s0 = cv[0], s1 = cv[1], s2 = cv[2], s3 = cv[3];
  uint32_t s4 = cv[4], s5 = cv[5], s6 = cv[6], s7 = cv[7];
  uint32_t s8 = 0x6A09E667u, s9 = 0xBB67AE85u, s10 = 0x3C6EF372u,
           s11 = 0xA54FF53Au;
  uint32_t s12 = counter, s13 = 0, s14 = block_len, s15 = flags;
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    g(s0, s4, s8, s12, m[0], m[1]);
    g(s1, s5, s9, s13, m[2], m[3]);
    g(s2, s6, s10, s14, m[4], m[5]);
    g(s3, s7, s11, s15, m[6], m[7]);
    g(s0, s5, s10, s15, m[8], m[9]);
    g(s1, s6, s11, s12, m[10], m[11]);
    g(s2, s7, s8, s13, m[12], m[13]);
    g(s3, s4, s9, s14, m[14], m[15]);
    if (r < 6) {
      // m[i] <- m[PERM[i]], PERM = 2 6 3 10 7 0 4 13 1 11 12 5 9 14 15 8
      const uint32_t t[16] = {m[2], m[6],  m[3],  m[10], m[7], m[0],  m[4],  m[13],
                              m[1], m[11], m[12], m[5],  m[9], m[14], m[15], m[8]};
#pragma unroll
      for (int i = 0; i < 16; ++i) m[i] = t[i];
    }
  }
  cv[0] = s0 ^ s8;  cv[1] = s1 ^ s9;  cv[2] = s2 ^ s10; cv[3] = s3 ^ s11;
  cv[4] = s4 ^ s12; cv[5] = s5 ^ s13; cv[6] = s6 ^ s14; cv[7] = s7 ^ s15;
}

// cols: (C, n), 4 < C <= 256; out: (8, n). One or two chunks: ROOT goes on
// the last block of a single-chunk leaf; a two-chunk leaf (C > 128) hashes
// its second chunk with counter 1 and joins the two chaining values with one
// PARENT | ROOT compression.
__global__ void __launch_bounds__(THREADS)
leaves_kernel(const uint64_t* __restrict__ cols, uint64_t* __restrict__ out,
              int64_t n, int C) {
  const int nblocks = (C + 7) / 8;
  const bool two_chunks = nblocks > CHUNK_BLOCKS;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint32_t cv[8], cv0[8], m[16];
    set_iv(cv);
    for (int b = 0; b < nblocks; ++b) {
      if (b == CHUNK_BLOCKS) {
#pragma unroll
        for (int w = 0; w < 8; ++w) cv0[w] = cv[w];
        set_iv(cv);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int col = 8 * b + k;
        const uint64_t v = col < C ? cols[col * n + i] : 0;
        m[2 * k] = static_cast<uint32_t>(v);
        m[2 * k + 1] = static_cast<uint32_t>(v >> 32);
      }
      const bool last = b == nblocks - 1;
      const int in_chunk = b % CHUNK_BLOCKS;
      uint32_t flags = in_chunk == 0 ? CHUNK_START : 0;
      if (last || in_chunk == CHUNK_BLOCKS - 1)
        flags |= two_chunks ? CHUNK_END : (CHUNK_END | ROOT);
      const uint32_t block_len = last ? 8 * C - 64 * (nblocks - 1) : 64;
      compress(cv, m, b / CHUNK_BLOCKS, block_len, flags);
    }
    if (two_chunks) {
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        m[w] = cv0[w];
        m[8 + w] = cv[w];
      }
      set_iv(cv);
      compress(cv, m, 0, 64, PARENT | ROOT);
    }
#pragma unroll
    for (int w = 0; w < 8; ++w) out[w * n + i] = cv[w];
  }
}

// digests: (8, n), n even; out: (8, n / 2). Parent i is the blake3 hash of
// the 64 bytes of children 2i and 2i + 1 as ONE single-block chunk
// (CHUNK_START | CHUNK_END | ROOT), not blake3's parent mode.
__global__ void __launch_bounds__(THREADS)
level_kernel(const uint64_t* __restrict__ digests, uint64_t* __restrict__ out,
             int64_t n) {
  const int64_t parents = n >> 1;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < parents; i += stride) {
    uint32_t cv[8], m[16];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const ulonglong2 pair =
          *reinterpret_cast<const ulonglong2*>(digests + w * n + 2 * i);
      m[w] = static_cast<uint32_t>(pair.x);
      m[8 + w] = static_cast<uint32_t>(pair.y);
    }
    set_iv(cv);
    compress(cv, m, 0, 64, CHUNK_START | CHUNK_END | ROOT);
#pragma unroll
    for (int w = 0; w < 8; ++w) out[w * parents + i] = cv[w];
  }
}

// The message blocks of one absorbed column block: flags, byte lengths and
// chunk counters of its (at most two) 64-byte blocks.
struct BlockMeta {
  uint32_t flags[2], len[2], counter[2];
};

// block: (W, n), 1 <= W <= 16, columns of the leaves; state: (8, n)
// chaining values, read unless `fresh` (a leaf's first chunk starts from
// the IV), written with the result. chunk0: nullptr, or the (8, n) chaining
// values of the leaves' first chunk when this block ends a two-chunk leaf.
// state is read and written by the same thread, so it may not be __restrict__.
__global__ void __launch_bounds__(THREADS)
absorb_kernel(const uint64_t* __restrict__ block, uint64_t* state,
              const uint64_t* __restrict__ chunk0, int64_t n, int W, int fresh,
              BlockMeta meta) {
  const int nblocks = (W + 7) / 8;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint32_t cv[8], m[16];
    if (fresh) {
      set_iv(cv);
    } else {
#pragma unroll
      for (int w = 0; w < 8; ++w) cv[w] = static_cast<uint32_t>(state[w * n + i]);
    }
    for (int b = 0; b < nblocks; ++b) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int col = 8 * b + k;
        const uint64_t v = col < W ? block[col * n + i] : 0;
        m[2 * k] = static_cast<uint32_t>(v);
        m[2 * k + 1] = static_cast<uint32_t>(v >> 32);
      }
      compress(cv, m, meta.counter[b], meta.len[b], meta.flags[b]);
    }
    if (chunk0 != nullptr) {
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        m[w] = static_cast<uint32_t>(chunk0[w * n + i]);
        m[8 + w] = cv[w];
      }
      set_iv(cv);
      compress(cv, m, 0, 64, PARENT | ROOT);
    }
#pragma unroll
    for (int w = 0; w < 8; ++w) state[w * n + i] = cv[w];
  }
}

}  // namespace

extern "C" int gl_blake3_leaves(const void* cols, void* out, int64_t n, int C,
                                void* stream) {
  if (n < 1 || C <= 4 || C > 256) return static_cast<int>(cudaErrorInvalidValue);
  leaves_kernel<<<gl::grid_for(n, THREADS), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(cols), static_cast<uint64_t*>(out), n, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gl_blake3_level(const void* digests, void* out, int64_t n,
                               void* stream) {
  if (n < 2 || (n & 1) || (reinterpret_cast<uintptr_t>(digests) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  level_kernel<<<gl::grid_for(n >> 1, THREADS), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(digests), static_cast<uint64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// meta: host array of the block's flags, byte lengths and chunk counters,
// two of each (the second unused when W <= 8)
extern "C" int gl_blake3_absorb(const void* block, void* state,
                                const void* chunk0, int64_t n, int W, int fresh,
                                const uint32_t* meta, void* stream) {
  if (n < 1 || W < 1 || W > 16) return static_cast<int>(cudaErrorInvalidValue);
  BlockMeta m;
  for (int b = 0; b < 2; ++b) {
    m.flags[b] = meta[b];
    m.len[b] = meta[2 + b];
    m.counter[b] = meta[4 + b];
  }
  absorb_kernel<<<gl::grid_for(n, THREADS), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(block), static_cast<uint64_t*>(state),
      static_cast<const uint64_t*>(chunk0), n, W, fresh, m);
  return static_cast<int>(cudaGetLastError());
}
