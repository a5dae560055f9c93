// K7: element-wise inversion, x^(p-2) with 0 mapping to 0, in the base
// field (gl_inv) and in the quadratic extension (gl_ext_inv).
//
// Replaces no Pallas kernel: olavm_tpu inverts with jnp, a lax.scan of
// square and multiply over the bits of p - 2 (olavm_tpu/field/gf.py:252
// inv; olavm_tpu/field/gfe.py:115 inv, the norm trick), which the port ran
// as 125 dependent K3 launches an inversion (131 in the extension), each
// reading 16 bytes and writing 8 a point, where the function needs one
// read and one write.
//
// Batch (Montgomery) inversion, as csrc/quotient.cu's selectors: a thread
// takes CHUNK points, i = t + k*T for T threads, so that each of its loads
// and stores is coalesced across the warp; it forms their running product,
// inverts the whole once (gl::inv, 63 squarings and 9 products), and walks
// back, each step giving one inverse as the inverse of the running product
// times the running product before it. A zero enters the running product
// as 1 and is written as 0 (what x^(p-2) gives), so that one zero does
// not turn its chunk's inverses into 0. Three products a point and 72 /
// CHUNK for the exponentiation.
//
// The extension, 1/(a + b phi) = (a - b phi) / (a^2 - 7 b^2) (phi^2 = 7):
// the norm a^2 - 7 b^2 is formed on the load and inverted in the same
// batch (it is 0 only for a = b = 0, which maps to 0), then times a and
// -b: three products a point more. Bound: device memory, 16 bytes a point
// (8 read, 8 written) in the base field, 32 in the extension; the products
// are far below the card's rate.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 128;
// points a thread: the base field's chunk holds the points and their
// running products (64 registers), the extension's both parts, the norms
// and the running products
constexpr int CHUNK = 16;
constexpr int EXT_CHUNK = 8;
constexpr uint64_t W = 7;

__global__ void __launch_bounds__(THREADS)
    inv_kernel(const uint64_t* __restrict__ a, uint64_t* __restrict__ out,
               int64_t n) {
  const int64_t threads = (n + CHUNK - 1) / CHUNK;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= threads) return;
  // x[k] the point (0 past the end), pre[k] the running product of the
  // nonzero points 0..k
  uint64_t x[CHUNK], pre[CHUNK];
  uint64_t acc = 1;
#pragma unroll
  for (int k = 0; k < CHUNK; ++k) {
    const int64_t i = t + k * threads;
    x[k] = i < n ? __ldg(a + i) : 0;
    acc = gl::mul(acc, x[k] ? x[k] : 1);
    pre[k] = acc;
  }
  // inv_acc = 1 / pre[k] for the k of each step below
  uint64_t inv_acc = gl::inv(acc);
#pragma unroll
  for (int k = CHUNK - 1; k >= 0; --k) {
    const int64_t i = t + k * threads;
    const uint64_t r = k ? gl::mul(inv_acc, pre[k - 1]) : inv_acc;
    inv_acc = gl::mul(inv_acc, x[k] ? x[k] : 1);
    if (i < n) out[i] = x[k] ? r : 0;
  }
}

__global__ void __launch_bounds__(THREADS)
    ext_inv_kernel(const uint64_t* __restrict__ re,
                   const uint64_t* __restrict__ im,
                   uint64_t* __restrict__ out_re,
                   uint64_t* __restrict__ out_im, int64_t n) {
  const int64_t threads = (n + EXT_CHUNK - 1) / EXT_CHUNK;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= threads) return;
  uint64_t a[EXT_CHUNK], b[EXT_CHUNK], norm[EXT_CHUNK], pre[EXT_CHUNK];
  uint64_t acc = 1;
#pragma unroll
  for (int k = 0; k < EXT_CHUNK; ++k) {
    const int64_t i = t + k * threads;
    a[k] = i < n ? __ldg(re + i) : 0;
    b[k] = i < n ? __ldg(im + i) : 0;
    norm[k] = gl::sub(gl::mul(a[k], a[k]), gl::mul(gl::mul(b[k], b[k]), W));
    acc = gl::mul(acc, norm[k] ? norm[k] : 1);
    pre[k] = acc;
  }
  uint64_t inv_acc = gl::inv(acc);
#pragma unroll
  for (int k = EXT_CHUNK - 1; k >= 0; --k) {
    const int64_t i = t + k * threads;
    uint64_t r = k ? gl::mul(inv_acc, pre[k - 1]) : inv_acc;
    inv_acc = gl::mul(inv_acc, norm[k] ? norm[k] : 1);
    r = norm[k] ? r : 0;
    if (i < n) {
      out_re[i] = gl::mul(a[k], r);
      out_im[i] = gl::mul(gl::sub(0, b[k]), r);
    }
  }
}

unsigned blocks_for(int64_t n, int chunk) {
  const int64_t threads = (n + chunk - 1) / chunk;
  return static_cast<unsigned>((threads + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" int gl_inv(const void* a, void* out, int64_t n, void* stream) {
  inv_kernel<<<blocks_for(n, CHUNK), THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(a), static_cast<uint64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gl_ext_inv(const void* re, const void* im, void* out_re,
                          void* out_im, int64_t n, void* stream) {
  ext_inv_kernel<<<blocks_for(n, EXT_CHUNK), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(re), static_cast<const uint64_t*>(im),
      static_cast<uint64_t*>(out_re), static_cast<uint64_t*>(out_im), n);
  return static_cast<int>(cudaGetLastError());
}
