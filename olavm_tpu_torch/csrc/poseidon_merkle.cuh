// Poseidon Merkle hashing of one leaf and of one pair of digests, for the
// leaf and level kernels of poseidon.cu.
//
// Device functions only, on poseidon::permute (poseidon_perm.cuh): like that
// header, a host compiler builds this file with the CUDA qualifiers defined
// away (tests/test_torch_poseidon_host.py), so the absorb step (in the leaf
// kernel's chunk loop there) and the compression are held against the numpy
// hasher without a card.
//
// Follows olavm_tpu/merkle/device.py:42-69 (the leaf sponge) and :186-199
// (compress_digests), which are plonky2's hash_no_pad and two_to_one
// (plonky2/src/hash/hashing.rs): a leaf of C elements is absorbed 8 at a
// time in overwrite mode, starting from the zero state. A chunk of k < 8
// elements overwrites only words 0..k-1; words k..11 keep what the previous
// permutation left. The digest is words 0-3 of the last state.
#pragma once

#include "poseidon_perm.cuh"

namespace poseidon {

constexpr int RATE = 8;
constexpr int DIGEST = 4;

// words 0..k-1 of s <- chunk[i * stride], a chunk of 1 <= k <= 8 elements
// (only the last chunk of a leaf may be short)
__device__ __forceinline__ void absorb(uint64_t* s, const uint64_t* chunk,
                                       int64_t stride, int k) {
  if (k == RATE) {
#pragma unroll
    for (int i = 0; i < RATE; ++i) s[i] = chunk[i * stride];
  } else {
#pragma unroll
    for (int i = 0; i < RATE; ++i)
      if (i < k) s[i] = chunk[i * stride];
  }
}

// two_to_one of two canonical digests: permute [left, right, 0, 0, 0, 0];
// s holds the final state
__device__ __forceinline__ void two_to_one(const uint64_t* left,
                                           const uint64_t* right,
                                           uint64_t* s) {
#pragma unroll
  for (int i = 0; i < DIGEST; ++i) {
    s[i] = left[i];
    s[DIGEST + i] = right[i];
    s[2 * DIGEST + i] = 0;
  }
  permute(s);
}

}  // namespace poseidon
