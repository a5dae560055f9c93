// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) for device code.
//
// Elements are canonical uint64 values (< p), one word each; the (lo, hi)
// u32 pair of olavm_tpu/field/gf.py exists only because the TPU has no
// 64-bit multiply. The reduction is the EPSILON trick of
// olavm_tpu/field/gf.py:_reduce128 (plonky2 goldilocks_field.rs reduce128):
// 2^64 == EPSILON and 2^96 == -1 (mod p).
//
// The card has no 64-bit integer multiply: a 64x64->128 product is built
// from 32-bit multiply-adds. `mul_wide` writes that chain in PTX (nine
// instructions with the carry flag); the carry-chained accumulate `acc_add`
// lets a dot product add its unreduced products into a 160-bit sum and
// reduce once; the reduction itself is two carry chains (`sub_small`,
// `add_eps`) in place of 64-bit compares and selects. Each PTX helper sits
// behind __CUDA_ARCH__ with a plain (unsigned __int128) twin, so that this
// file and poseidon_perm.cuh compile with a host compiler and can be checked
// on a machine without a card.
#pragma once

#include <cstdint>

#ifndef GL_LAZY_SEEN
// a host build may define it to watch every lazy result of the host twins
// (the tests: that edge inputs drive them to 2^64 - 1)
#define GL_LAZY_SEEN(x) (x)
#endif

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPSILON = 0xFFFFFFFFull;

// a 128-bit value, lo + hi * 2^64
struct u128 {
  uint64_t lo, hi;
};

// a sum of up to 2^32 products: lo + hi * 2^64 + top * 2^128
struct u160 {
  uint64_t lo, hi;
  uint32_t top;
};

// a + b mod p, canonical, for any 64-bit a and canonical b
__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  // on carry s <= p - 2, so s + EPSILON < 2^64 cannot carry again
  s += (s < a) ? EPSILON : 0;
  return s >= P ? s - P : s;
}

// a - b mod p for any 64-bit a and canonical b: canonical where a is, else
// lazy (a residue below 2^64)
__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  // on borrow d = a - b + 2^64 > EPSILON, so d - EPSILON = a - b + p >= 0
#ifdef __CUDA_ARCH__
  return (a < b) ? d - EPSILON : d;
#else
  return GL_LAZY_SEEN((a < b) ? d - EPSILON : d);
#endif
}

// any 64-bit word to its canonical residue
__device__ __forceinline__ uint64_t canonical(uint64_t x) {
  return x >= P ? x - P : x;
}

// The helpers below return a residue below 2^64 that is not always
// canonical ("lazy"): enough for an operand of a product, of a sum, or of
// `add`, and `canonical` ends such a chain.

// x + c mod p, lazy, for any 64-bit x and canonical c: on a carry out of 64
// bits the sum wrapped to at most p - 2, and adding 2^64 = EPSILON back
// cannot carry again (no compare and select, where `add` needs two)
__device__ __forceinline__ uint64_t add_lazy(uint64_t x, uint64_t c) {
#ifdef __CUDA_ARCH__
  uint32_t x0 = static_cast<uint32_t>(x), x1 = static_cast<uint32_t>(x >> 32);
  // + cy * EPSILON as + cy * 2^32 - cy
  asm("{\n\t.reg .u32 cy;\n\t"
      "add.cc.u32  %0, %0, %2;\n\t"
      "addc.cc.u32 %1, %1, %3;\n\t"
      "addc.u32    cy, 0, 0;\n\t"
      "sub.cc.u32  %0, %0, cy;\n\t"
      "subc.u32    %1, %1, 0;\n\t"
      "add.u32     %1, %1, cy;\n\t}"
      : "+r"(x0), "+r"(x1)
      : "r"(static_cast<uint32_t>(c)), "r"(static_cast<uint32_t>(c >> 32)));
  return (static_cast<uint64_t>(x1) << 32) | x0;
#else
  const uint64_t s = x + c;
  return GL_LAZY_SEEN(s < x ? s + EPSILON : s);
#endif
}

// x - k mod p, lazy, for k < 2^32
__device__ __forceinline__ uint64_t sub_small(uint64_t x, uint32_t k) {
#ifdef __CUDA_ARCH__
  uint32_t x0 = static_cast<uint32_t>(x), x1 = static_cast<uint32_t>(x >> 32);
  // on borrow (x < k) take EPSILON = 2^64 mod p off as well: x - k + 2^64
  // >= 2^64 - 2^32 + 1, so this cannot borrow again
  asm("{\n\t.reg .u32 bw;\n\t"
      "sub.cc.u32  %0, %0, %2;\n\t"
      "subc.cc.u32 %1, %1, 0;\n\t"
      "subc.u32    bw, 0, 0;\n\t"
      "sub.cc.u32  %0, %0, bw;\n\t"
      "subc.u32    %1, %1, 0;\n\t}"
      : "+r"(x0), "+r"(x1)
      : "r"(k));
  return (static_cast<uint64_t>(x1) << 32) | x0;
#else
  const uint64_t d = x - k;
  return x < k ? d - EPSILON : d;
#endif
}

// x + k * EPSILON mod p (x + k * 2^64), lazy, for k < 2^32
__device__ __forceinline__ uint64_t add_eps(uint64_t x, uint32_t k) {
#ifdef __CUDA_ARCH__
  uint32_t x0 = static_cast<uint32_t>(x), x1 = static_cast<uint32_t>(x >> 32);
  // on carry the sum wrapped below k * EPSILON <= 2^64 - 2^33 + 1, so adding
  // EPSILON for the carry cannot carry again
  asm("{\n\t.reg .u32 cy;\n\t"
      "mad.lo.cc.u32  %0, %2, %3, %0;\n\t"
      "madc.hi.cc.u32 %1, %2, %3, %1;\n\t"
      "addc.u32       cy, 0, 0;\n\t"
      "mad.lo.cc.u32  %0, cy, %3, %0;\n\t"
      "madc.hi.u32    %1, cy, %3, %1;\n\t}"
      : "+r"(x0), "+r"(x1)
      : "r"(k), "r"(static_cast<uint32_t>(EPSILON)));
  return (static_cast<uint64_t>(x1) << 32) | x0;
#else
  const uint64_t t = static_cast<uint64_t>(k) * EPSILON;
  const uint64_t r = x + t;
  return r < t ? r + EPSILON : r;
#endif
}

// a + b mod p, lazy, for any 64-bit a and b: the carry out of 64 bits is
// 2^64 = EPSILON, added back by add_eps (which handles its own carry)
__device__ __forceinline__ uint64_t add_ll(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  uint32_t x0 = static_cast<uint32_t>(a), x1 = static_cast<uint32_t>(a >> 32);
  uint32_t cy;
  asm("add.cc.u32  %0, %0, %3;\n\t"
      "addc.cc.u32 %1, %1, %4;\n\t"
      "addc.u32    %2, 0, 0;"
      : "+r"(x0), "+r"(x1), "=r"(cy)
      : "r"(static_cast<uint32_t>(b)), "r"(static_cast<uint32_t>(b >> 32)));
  return add_eps((static_cast<uint64_t>(x1) << 32) | x0, cy);
#else
  const uint64_t s = a + b;
  return GL_LAZY_SEEN(s < a ? add_eps(s, 1) : s);
#endif
}

// a - b mod p, lazy, for any 64-bit a and b: the borrow out of 64 bits is
// -2^64 = -EPSILON, taken off by sub_small (which handles its own borrow)
__device__ __forceinline__ uint64_t sub_ll(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  uint32_t x0 = static_cast<uint32_t>(a), x1 = static_cast<uint32_t>(a >> 32);
  uint32_t bw;
  // bw = 0 - borrow: 0, or 0xFFFFFFFF = EPSILON
  asm("sub.cc.u32  %0, %0, %3;\n\t"
      "subc.cc.u32 %1, %1, %4;\n\t"
      "subc.u32    %2, 0, 0;"
      : "+r"(x0), "+r"(x1), "=r"(bw)
      : "r"(static_cast<uint32_t>(b)), "r"(static_cast<uint32_t>(b >> 32)));
  return sub_small((static_cast<uint64_t>(x1) << 32) | x0, bw);
#else
  const uint64_t d = a - b;
  return GL_LAZY_SEEN(a < b ? sub_small(d, static_cast<uint32_t>(EPSILON)) : d);
#endif
}

// lo + hi * 2^64, any 128-bit value, lazy: 2^64 = EPSILON, 2^96 = -1
__device__ __forceinline__ uint64_t reduce128_lazy(uint64_t lo, uint64_t hi) {
  const uint64_t r = add_eps(sub_small(lo, static_cast<uint32_t>(hi >> 32)),
                             static_cast<uint32_t>(hi));
#ifdef __CUDA_ARCH__
  return r;
#else
  return GL_LAZY_SEEN(r);
#endif
}

__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  return canonical(reduce128_lazy(lo, hi));
}

// a * b as 128 bits, a and b any 64-bit words
__device__ __forceinline__ u128 mul_wide(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  const uint32_t a0 = static_cast<uint32_t>(a), a1 = static_cast<uint32_t>(a >> 32);
  const uint32_t b0 = static_cast<uint32_t>(b), b1 = static_cast<uint32_t>(b >> 32);
  uint32_t r0, r1, r2, r3;
  // schoolbook on 32-bit limbs: a0b0 + (a0b1 + a1b0) 2^32 + a1b1 2^64
  asm("mul.lo.u32     %0, %4, %6;\n\t"
      "mul.hi.u32     %1, %4, %6;\n\t"
      "mad.lo.cc.u32  %1, %4, %7, %1;\n\t"
      "madc.hi.u32    %2, %4, %7, 0;\n\t"
      "mad.lo.cc.u32  %1, %5, %6, %1;\n\t"
      "madc.hi.cc.u32 %2, %5, %6, %2;\n\t"
      "madc.hi.u32    %3, %5, %7, 0;\n\t"
      "mad.lo.cc.u32  %2, %5, %7, %2;\n\t"
      "addc.u32       %3, %3, 0;"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a0), "r"(a1), "r"(b0), "r"(b1));
  return {(static_cast<uint64_t>(r1) << 32) | r0,
          (static_cast<uint64_t>(r3) << 32) | r2};
#else
  const unsigned __int128 w = static_cast<unsigned __int128>(a) * b;
  return {static_cast<uint64_t>(w), static_cast<uint64_t>(w >> 64)};
#endif
}

// acc += x, with the carry out of 128 bits into acc.top
__device__ __forceinline__ void acc_add(u160& acc, u128 x) {
#ifdef __CUDA_ARCH__
  asm("add.cc.u64  %0, %0, %3;\n\t"
      "addc.cc.u64 %1, %1, %4;\n\t"
      "addc.u32    %2, %2, 0;"
      : "+l"(acc.lo), "+l"(acc.hi), "+r"(acc.top)
      : "l"(x.lo), "l"(x.hi));
#else
  const unsigned __int128 s =
      ((static_cast<unsigned __int128>(acc.hi) << 64) | acc.lo) +
      ((static_cast<unsigned __int128>(x.hi) << 64) | x.lo);
  acc.top += s < ((static_cast<unsigned __int128>(x.hi) << 64) | x.lo);
  acc.lo = static_cast<uint64_t>(s);
  acc.hi = static_cast<uint64_t>(s >> 64);
#endif
}

// lo + hi * 2^64 + top * 2^128, lazy: top * 2^64 folds into hi as
// top * EPSILON
__device__ __forceinline__ uint64_t reduce160_lazy(u160 x) {
  return reduce128_lazy(x.lo, add_eps(x.hi, x.top));
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  const u128 w = mul_wide(a, b);
  return reduce128(w.lo, w.hi);
}

__device__ __forceinline__ uint64_t mul_lazy(uint64_t a, uint64_t b) {
  const u128 w = mul_wide(a, b);
  return reduce128_lazy(w.lo, w.hi);
}

// b^e, canonical, by square and multiply
__device__ __forceinline__ uint64_t pow_u64(uint64_t b, uint64_t e) {
  uint64_t r = 1;
  while (e) {
    if (e & 1) r = mul(r, b);
    b = mul(b, b);
    e >>= 1;
  }
  return r;
}

// x^(2^k), canonical: k squarings
__device__ __forceinline__ uint64_t sqr_n(uint64_t x, int k) {
  for (int i = 0; i < k; ++i) x = mul(x, x);
  return x;
}

// x^(p - 2): 1/x, and 0 for x = 0. With t_k = x^(2^k - 1) and t_a^(2^b)
// t_b = t_(a+b), p - 2 = (2^31 - 1) 2^33 + 2^32 - 1 is an addition chain
// of 63 squarings and 9 products (square and multiply takes 63 and 62)
__device__ __forceinline__ uint64_t inv(uint64_t x) {
  const uint64_t t2 = mul(sqr_n(x, 1), x);
  const uint64_t t3 = mul(sqr_n(t2, 1), x);
  const uint64_t t6 = mul(sqr_n(t3, 3), t3);
  const uint64_t t12 = mul(sqr_n(t6, 6), t6);
  const uint64_t t24 = mul(sqr_n(t12, 12), t12);
  const uint64_t t30 = mul(sqr_n(t24, 6), t6);
  const uint64_t t31 = mul(sqr_n(t30, 1), x);
  const uint64_t t31_2 = sqr_n(t31, 1);
  const uint64_t t32 = mul(t31_2, x);
  return mul(sqr_n(t31_2, 32), t32);
}

// x^7, lazy
__device__ __forceinline__ uint64_t pow7_lazy(uint64_t x) {
  const uint64_t x2 = mul_lazy(x, x);
  const uint64_t x4 = mul_lazy(x2, x2);
  const uint64_t x3 = mul_lazy(x, x2);
  return mul_lazy(x3, x4);
}

// grid for a grid-stride loop over n items: enough blocks to fill 132 SMs
inline unsigned grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t cap = 132 * 32;
  if (blocks > cap) blocks = cap;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

}  // namespace gl
