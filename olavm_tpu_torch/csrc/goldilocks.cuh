// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) for device code.
//
// Elements are canonical uint64 values (< p). A CUDA thread has a native
// 64-bit multiply (__umul64hi gives the high half), so one element is one
// word; the (lo, hi) u32 pair of olavm_tpu/field/gf.py exists only because
// the TPU has no 64-bit multiply. The reduction is the EPSILON trick of
// olavm_tpu/field/gf.py:_reduce128 (plonky2 goldilocks_field.rs reduce128):
// 2^64 == EPSILON and 2^96 == -1 (mod p).
#pragma once

#include <cstdint>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPSILON = 0xFFFFFFFFull;

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  // a, b < p: on carry, s + EPSILON < p cannot carry again
  s += (s < a) ? EPSILON : 0;
  return s >= P ? s - P : s;
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  // on borrow d = a - b + 2^64 > EPSILON, so d - EPSILON = a - b + p >= 0
  return (a < b) ? d - EPSILON : d;
}

__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  uint64_t hi_hi = hi >> 32;
  uint64_t hi_lo = hi & EPSILON;
  uint64_t t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= EPSILON;  // cannot underflow
  uint64_t t1 = hi_lo * EPSILON;  // < 2^64
  uint64_t t2 = t0 + t1;
  t2 += (t2 < t0) ? EPSILON : 0;  // cannot carry again
  return t2 >= P ? t2 - P : t2;
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  return reduce128(a * b, __umul64hi(a, b));
}

__device__ __forceinline__ uint64_t pow7(uint64_t x) {
  uint64_t x2 = mul(x, x);
  uint64_t x4 = mul(x2, x2);
  uint64_t x3 = mul(x, x2);
  return mul(x3, x4);
}

// grid for a grid-stride loop over n items: enough blocks to fill 132 SMs
inline unsigned grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t cap = 132 * 32;
  if (blocks > cap) blocks = cap;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

}  // namespace gl
