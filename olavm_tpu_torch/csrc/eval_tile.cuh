// K5's per-thread register tile (csrc/eval.cu) and the constants of its
// staging, which the wrapper's plan (field/gf.py eval_plan) repeats and
// tests/test_torch_eval.py holds equal.
//
// A thread of K5 owns RC columns x RT points of the output for the terms
// of its block's chunk that fall to its slice. For every term i it adds
// the RC x RT products coeffs[c][i] * pows[t][i] unreduced into wide sums
// and reduces each sum once, at the end of the chunk. One coefficient
// serves RT products and one power RC.
//
// A sum of products x * y, x = x0 + x1 2^32 and y = y0 + y1 2^32 in 32-bit
// halves, is kept as two sums: D = sum (x0 y0 + x1 y1 2^64), 160 bits, and
// M = sum (x0 y1 + x1 y0), 96 bits; its value is D + M 2^32. Keeping the
// cross products apart means no carry runs from them into D: a term is four
// 32x32 multiply-adds with carry, which ptxas makes four IMAD.WIDE.U32 (with
// carry in and out), and two carry adds, one into D's top word and one into
// M's for both cross products: 7 SASS instructions a term in the loop. (A
// 64x64->128 product added into one 160-bit sum, goldilocks.cuh mul_wide
// and acc_add, took 15 and ran 1.3-1.4x slower at the same tile; PERF.md
// section 6.)
//
// Overflow invariant: a term adds below 2^128 to D and below 2^65 to M, so
// fewer than 2^31 terms can wrap neither D's top word nor M's. A thread adds
// one term per term of its chunk into each sum, and the kernel refuses a
// chunk of 2^31 terms or more (gl_eval_points), so the invariant holds for
// any n the kernel takes (the main path reaches n = 2^23; a chunk at
// n = 2^26 is ~2^18 terms).
#pragma once

#include <cstdint>

#include "goldilocks.cuh"

namespace eval {

constexpr int RC = 2;  // columns of a thread's tile
constexpr int RT = 4;  // points of a thread's tile
// terms per staged sub-tile, and words per staged row: two words of
// padding make a row an odd count of 16-byte bank groups, so that eight
// consecutive rows start in eight different groups
constexpr int TERMS = 64;
constexpr int STRIDE = TERMS + 2;
constexpr int STAGES = 2;        // staged sub-tiles in flight per block
constexpr int MAX_THREADS = 512; // threads per block (the plan's cap)

// sum x * y as D (dlo, dhi, dtop: 160 bits) and M (m, mtop: 96 bits)
struct Sum {
  uint64_t dlo, dhi, m;
  uint32_t dtop, mtop;
};

__device__ __forceinline__ void mad(Sum& a, uint64_t x, uint64_t y) {
#ifdef __CUDA_ARCH__
  asm("{\n\t.reg .u32 x0, x1, y0, y1, d0, d1, d2, d3, m0, m1;\n\t"
      "mov.b64 {x0, x1}, %5;\n\t"
      "mov.b64 {y0, y1}, %6;\n\t"
      "mov.b64 {d0, d1}, %0;\n\t"
      "mov.b64 {d2, d3}, %1;\n\t"
      "mov.b64 {m0, m1}, %2;\n\t"
      "mad.lo.cc.u32  d0, x0, y0, d0;\n\t"
      "madc.hi.cc.u32 d1, x0, y0, d1;\n\t"
      "madc.lo.cc.u32 d2, x1, y1, d2;\n\t"
      "madc.hi.cc.u32 d3, x1, y1, d3;\n\t"
      "addc.u32       %3, %3, 0;\n\t"
      "mad.lo.cc.u32  m0, x0, y1, m0;\n\t"
      "madc.hi.cc.u32 m1, x0, y1, m1;\n\t"
      "addc.u32       %4, %4, 0;\n\t"
      "mad.lo.cc.u32  m0, x1, y0, m0;\n\t"
      "madc.hi.cc.u32 m1, x1, y0, m1;\n\t"
      "addc.u32       %4, %4, 0;\n\t"
      "mov.b64 %0, {d0, d1};\n\t"
      "mov.b64 %1, {d2, d3};\n\t"
      "mov.b64 %2, {m0, m1};\n\t}"
      : "+l"(a.dlo), "+l"(a.dhi), "+l"(a.m), "+r"(a.dtop), "+r"(a.mtop)
      : "l"(x), "l"(y));
#else
  using u128 = unsigned __int128;
  const uint64_t x0 = x & 0xFFFFFFFFu, x1 = x >> 32;
  const uint64_t y0 = y & 0xFFFFFFFFu, y1 = y >> 32;
  const u128 t = static_cast<u128>(x0 * y0) | (static_cast<u128>(x1 * y1) << 64);
  const u128 d = ((static_cast<u128>(a.dhi) << 64) | a.dlo) + t;
  a.dtop += d < t;
  a.dlo = static_cast<uint64_t>(d);
  a.dhi = static_cast<uint64_t>(d >> 64);
  const uint64_t c0 = x0 * y1, c1 = x1 * y0;
  a.m += c0;
  a.mtop += a.m < c0;
  a.m += c1;
  a.mtop += a.m < c1;
#endif
}

// the canonical residue of D + M 2^32: M 2^32 = m 2^32 + mtop 2^96 is the
// 160-bit value (m << 32) + ((m >> 32) + mtop 2^32) 2^64
__device__ __forceinline__ uint64_t residue(const Sum& a) {
  const uint64_t d = gl::canonical(gl::reduce160_lazy({a.dlo, a.dhi, a.dtop}));
  const uint64_t m = gl::canonical(gl::reduce160_lazy(
      {a.m << 32, (a.m >> 32) | (static_cast<uint64_t>(a.mtop) << 32), 0}));
  return gl::add(d, m);
}

// a thread's RC x RT sums
struct Tile {
  Sum acc[RC][RT];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < RC; ++r)
#pragma unroll
      for (int q = 0; q < RT; ++q) acc[r][q] = {0, 0, 0, 0, 0};
  }

  // one term: x[r] is the coefficient of the tile's column r, y[q] the
  // power of its point q
  __device__ __forceinline__ void add(const uint64_t (&x)[RC], const uint64_t (&y)[RT]) {
#pragma unroll
    for (int r = 0; r < RC; ++r)
#pragma unroll
      for (int q = 0; q < RT; ++q) mad(acc[r][q], x[r], y[q]);
  }

  // the canonical residue of one sum (r and q known at compile time, so
  // that the tile stays in registers)
  __device__ __forceinline__ uint64_t sum(int r, int q) const { return residue(acc[r][q]); }
};

}  // namespace eval
