// The width-12 Poseidon permutation of one state, for K2 (poseidon.cu).
//
// Device functions and the constant tables only: no CUDA runtime, so that a
// host compiler can build this file with __device__, __forceinline__,
// __host__ and __constant__ defined away (tests/test_torch_poseidon_host.py)
// and hold it against the numpy permutation without a card.
//
// Follows olavm_tpu/hash/poseidon.py:417 permute_stacked_gf_unrolled: 4 full
// rounds, the partial rounds in plonky2's fast form (a constant layer, a
// dense 11x11 matrix, then per round x^7 of word 0, a W_HATS row into word 0
// and a VS column into the rest), 4 full rounds. What it does about the
// card's lack of a 64-bit multiply:
// - the MDS layers of the full rounds multiply by the circulant's entries,
//   which are at most 41 (plus the diagonal's 8 on row 0) and are compiled
//   in: each word is cut into limbs of 22, 22 and 20 bits, an output is
//   three sums of 12 constant x limb 32-bit multiply-adds, each below 2^31,
//   and one reduction of their total (below 2^76);
// - a dot product of full-size constants (the 11x11 matrix, each W_HATS row,
//   each VS step with its + s_i) adds unreduced 128-bit products into a
//   160-bit sum and reduces once;
// - only x^7 reduces after every product, since it is a chain;
// - the words stay lazy residues below 2^64 (goldilocks.cuh) from round to
//   round, also where a constant is added (`add_lazy`), and are made
//   canonical at the end.
// What it does about instruction fetch: the code is one copy of the full
// round (the 8 full rounds run in one loop, with the partial rounds inside
// it after the fourth) and the 11x11 entry matrix as a rolled loop of 11
// dot products through a rotating set of registers: K2 is 2,866 SASS
// instructions where a form with two copies of the full round and the
// matrix unrolled was 6,620, which the warps of an SM fetch from many
// places at once when they drift apart (poseidon.cu).
#pragma once

#include "goldilocks.cuh"

namespace poseidon {

constexpr int WIDTH = 12;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 22;

// MDS_MATRIX_CIRC and MDS_MATRIX_DIAG of poseidon_constants.json, compiled
// in; gl_poseidon_init refuses tables that differ
__host__ __device__ constexpr uint32_t mds_circ(int i) {
  switch (i) {
    case 0: return 17;
    case 1: return 15;
    case 2: return 41;
    case 3: return 16;
    case 4: return 2;
    case 5: return 28;
    case 6: return 13;
    case 7: return 13;
    case 8: return 39;
    case 9: return 18;
    case 10: return 34;
    default: return 20;
  }
}

__host__ __device__ constexpr uint32_t mds_diag(int i) { return i == 0 ? 8 : 0; }

// the full MDS matrix: out[r] = sum_j entry(r, j) * in[j]
__host__ __device__ constexpr uint32_t mds_entry(int r, int j) {
  return mds_circ((j - r + WIDTH) % WIDTH) + (j == r ? mds_diag(r) : 0);
}

// 0 when the tables equal the compiled constants
inline int mds_mismatch(const uint64_t* circ, const uint64_t* diag) {
  for (int i = 0; i < WIDTH; ++i)
    if (circ[i] != mds_circ(i) || diag[i] != mds_diag(i)) return 1;
  return 0;
}

__constant__ uint64_t c_rc[30 * WIDTH];            // ALL_ROUND_CONSTANTS
__constant__ uint64_t c_first[WIDTH];              // FAST_PARTIAL_FIRST_ROUND_CONSTANT
__constant__ uint64_t c_prc[PARTIAL];              // FAST_PARTIAL_ROUND_CONSTANTS
__constant__ uint64_t c_vs[PARTIAL * (WIDTH - 1)];  // FAST_PARTIAL_ROUND_VS
__constant__ uint64_t c_wh[PARTIAL * (WIDTH - 1)];  // FAST_PARTIAL_ROUND_W_HATS
__constant__ uint64_t c_init[(WIDTH - 1) * (WIDTH - 1)];  // ..._INITIAL_MATRIX

// a * c as 128 bits, c a small constant
__device__ __forceinline__ gl::u128 mul_small(uint64_t a, uint32_t c) {
  const uint64_t l = static_cast<uint64_t>(static_cast<uint32_t>(a)) * c;
  const uint64_t m = (a >> 32) * c;  // < 2^38
  const uint64_t lo = l + (m << 32);
  return {lo, (m >> 32) + (lo < l)};
}

// s0 + s1 * 2^22 + s2 * 2^44 for s0, s1, s2 < 2^32 (a value below 2^77),
// lazy: the bits above 2^64 fold in as a multiple of 2^64 = EPSILON
__device__ __forceinline__ uint64_t limbs_to_lazy(uint32_t s0, uint32_t s1,
                                                  uint32_t s2) {
  const uint64_t lo = s0 + (static_cast<uint64_t>(s1) << 22);  // < 2^55
  const uint64_t x = lo + (static_cast<uint64_t>(s2) << 44);
  return gl::add_eps(x, (s2 >> 20) + (x < lo));
}

// a full round: x^7 of each word plus its round constant, then the MDS
// layer. A word enters the layer as three limbs of 22, 22 and 20 bits, so
// that a row's sum of entry x limb over 12 words (13 on row 0) stays below
// 264 * 2^22 < 2^31: each term is three 32-bit multiply-adds of one result
// each, where a low and a high limb of 32 bits took two 32x32->64
// multiply-adds of two results each
__device__ __forceinline__ void full_round(uint64_t* s, int r) {
  uint32_t l0[WIDTH], l1[WIDTH], l2[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) {
    const uint64_t t = gl::pow7_lazy(gl::add_lazy(s[i], c_rc[r * WIDTH + i]));
    l0[i] = static_cast<uint32_t>(t) & 0x3FFFFF;
    l1[i] = static_cast<uint32_t>(t >> 22) & 0x3FFFFF;
    l2[i] = static_cast<uint32_t>(t >> 44);
  }
#pragma unroll
  for (int row = 0; row < WIDTH; ++row) {
    uint32_t s0 = 0, s1 = 0, s2 = 0;
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) {
      s0 += l0[j] * mds_entry(row, j);
      s1 += l1[j] * mds_entry(row, j);
      s2 += l2[j] * mds_entry(row, j);
    }
    s[row] = limbs_to_lazy(s0, s1, s2);
  }
}

// the constant layer and the dense matrix that open the partial rounds:
// output c is a dot product of column c with words 1-11, one per step of a
// rolled loop; each step's result enters out[10] and the earlier ones move
// down, so that step c's ends in out[c]
__device__ __forceinline__ void partial_entry(uint64_t* s) {
  uint64_t in[WIDTH], out[WIDTH - 1] = {};
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) in[i] = gl::add_lazy(s[i], c_first[i]);
#pragma unroll 1
  for (int c = 0; c < WIDTH - 1; ++c) {
    gl::u160 acc = {0, 0, 0};
#pragma unroll
    for (int r = 1; r < WIDTH; ++r)
      gl::acc_add(acc, gl::mul_wide(in[r], c_init[(r - 1) * (WIDTH - 1) + c]));
#pragma unroll
    for (int i = 0; i < WIDTH - 2; ++i) out[i] = out[i + 1];
    out[WIDTH - 2] = gl::reduce160_lazy(acc);
  }
  s[0] = in[0];
#pragma unroll
  for (int c = 1; c < WIDTH; ++c) s[c] = out[c - 1];
}

// partial round r: x^7 of word 0 (and its constant but in the last round),
// then word 0 <- 25 s0 + W_HATS . s[1..], s[i] <- s[i] + VS[i] s0
__device__ __forceinline__ void partial_round(uint64_t* s, int r) {
  uint64_t s0 = gl::pow7_lazy(s[0]);
  if (r < PARTIAL - 1) s0 = gl::add_lazy(s0, c_prc[r]);
  const gl::u128 d0 = mul_small(s0, mds_entry(0, 0));
  gl::u160 d = {d0.lo, d0.hi, 0};
#pragma unroll
  for (int i = 1; i < WIDTH; ++i)
    gl::acc_add(d, gl::mul_wide(s[i], c_wh[r * (WIDTH - 1) + i - 1]));
#pragma unroll
  for (int i = 1; i < WIDTH; ++i) {
    // s0 * VS < 2^64 p, so + s[i] stays below 2^128
    gl::u128 w = gl::mul_wide(s0, c_vs[r * (WIDTH - 1) + i - 1]);
    w.lo += s[i];
    w.hi += w.lo < s[i];
    s[i] = gl::reduce128_lazy(w.lo, w.hi);
  }
  s[0] = gl::reduce160_lazy(d);
}

// the permutation of one state, in place: s[12] canonical in and out (the
// words are lazy residues below 2^64 in between)
__device__ __forceinline__ void permute(uint64_t* s) {
#pragma unroll 1
  for (int r = 0; r < 2 * HALF_FULL; ++r) {
    full_round(s, r < HALF_FULL ? r : r + PARTIAL);
    if (r == HALF_FULL - 1) {
      partial_entry(s);
#pragma unroll 1
      for (int k = 0; k < PARTIAL; ++k) partial_round(s, k);
    }
  }
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = gl::canonical(s[i]);
}

}  // namespace poseidon
