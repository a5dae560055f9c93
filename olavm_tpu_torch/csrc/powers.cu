// K13: a power table [1, b, b^2, ..., b^{n-1}] in one launch, in the base
// field (a row of bases: (rows, n)) or in the extension GF(p^2) (one base:
// (2, n), re and im), so that a power table is no log-doubling chain of
// K3, cat and squaring launches (about 10 launches a doubling step in the
// extension, 3 in the base field).
//
// Replaces no Pallas kernel: olavm_tpu builds power tables with jnp by
// log-doubling (olavm_tpu/field/gf.py:275 `powers`, olavm_tpu/field/gfe.py:94
// `powers`), which its `extpows` program runs for the openings
// (olavm_tpu/stark/prover_device.py:458-467 `_ext_power_table`), and which
// the port ran as chains of K3, add, sub and cat launches.
//
// The base is read from the card (a bank or a 0-dim tensor: a captured
// program replays with a new challenge). Lane l of warp w takes the run
// j = w * 32 * RUN + l + 32 r, r < RUN: it raises b to its first j by square and multiply (about
// 1.5 log2(n) products) and steps by b^32 (five squarings), so that each
// of the warp's RUN stores covers 32 consecutive words. Bound: device
// memory, 8 bytes a point written (16 in the extension); a point costs one
// product (four 64x64 products in the extension) and its share of the
// exponentiation, about 1.5 log2(n) / RUN products.
//
// The kernels call only goldilocks.cuh's gl:: helpers, so with the CUDA
// qualifiers stubbed a host compiler builds this namespace and runs every
// thread in turn (tests/test_torch_powers.py).
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace powers {

constexpr int THREADS = 128;
constexpr int WARP = 32;
// steps of one lane: a lane writes RUN points, 32 apart
constexpr int RUN = 32;
// points of one block
constexpr int64_t BLOCK_POINTS = static_cast<int64_t>(THREADS) * RUN;
constexpr uint64_t W = 7;

struct ext {
  uint64_t re, im;
};

// (a0 + a1 phi)(b0 + b1 phi) = a0 b0 + 7 a1 b1 + (a0 b1 + a1 b0) phi, with
// b1 times 7 given (b7 = 7 b1 mod p): two sums of two 64x64 products,
// each reduced once, canonical
__device__ __forceinline__ ext ext_mul7(ext a, ext b, uint64_t b7) {
  gl::u160 re = {0, 0, 0}, im = {0, 0, 0};
  gl::acc_add(re, gl::mul_wide(a.re, b.re));
  gl::acc_add(re, gl::mul_wide(a.im, b7));
  gl::acc_add(im, gl::mul_wide(a.re, b.im));
  gl::acc_add(im, gl::mul_wide(a.im, b.re));
  return {gl::canonical(gl::reduce160_lazy(re)),
          gl::canonical(gl::reduce160_lazy(im))};
}

__device__ __forceinline__ ext ext_mul(ext a, ext b) {
  return ext_mul7(a, b, gl::mul(b.im, W));
}

// b^e in the extension by square and multiply
__device__ __forceinline__ ext ext_pow(ext b, uint64_t e) {
  ext r = {1, 0};
  while (e) {
    if (e & 1) r = ext_mul(r, b);
    b = ext_mul(b, b);
    e >>= 1;
  }
  return r;
}

// the first point of this lane's run
__device__ __forceinline__ int64_t first_point() {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  return (t / WARP) * WARP * RUN + t % WARP;
}

// out[row][j] = bases[row]^j
__global__ void __launch_bounds__(THREADS)
    base_kernel(const uint64_t* __restrict__ bases,
                uint64_t* __restrict__ out, int64_t n) {
  const int64_t row = blockIdx.y;
  const int64_t j0 = first_point();
  if (j0 >= n) return;
  const uint64_t b = __ldg(bases + row);
  const uint64_t step = gl::sqr_n(b, 5);  // b^32
  uint64_t x = gl::pow_u64(b, static_cast<uint64_t>(j0));
  uint64_t* o = out + row * n;
#pragma unroll 4
  for (int r = 0; r < RUN; ++r) {
    const int64_t j = j0 + static_cast<int64_t>(r) * WARP;
    if (j >= n) break;
    o[j] = x;
    x = gl::mul(x, step);
  }
}

// out[0][j] + out[1][j] phi = (re + im phi)^j, the base read from re_ptr
// and im_ptr
__global__ void __launch_bounds__(THREADS)
    ext_kernel(const uint64_t* __restrict__ re_ptr,
               const uint64_t* __restrict__ im_ptr,
               uint64_t* __restrict__ out, int64_t n) {
  const int64_t j0 = first_point();
  if (j0 >= n) return;
  const ext b = {__ldg(re_ptr), __ldg(im_ptr)};
  ext step = b;  // b^32
#pragma unroll
  for (int k = 0; k < 5; ++k) step = ext_mul(step, step);
  const uint64_t step7 = gl::mul(step.im, W);
  ext x = ext_pow(b, static_cast<uint64_t>(j0));
#pragma unroll 4
  for (int r = 0; r < RUN; ++r) {
    const int64_t j = j0 + static_cast<int64_t>(r) * WARP;
    if (j >= n) break;
    out[j] = x.re;
    out[n + j] = x.im;
    x = ext_mul7(x, step, step7);
  }
}

inline unsigned blocks(int64_t n) {
  return static_cast<unsigned>((n + BLOCK_POINTS - 1) / BLOCK_POINTS);
}

}  // namespace powers

// bases: (rows,) on the card; out: (rows, n)
extern "C" int gl_powers(const void* bases, void* out, int64_t rows,
                         int64_t n, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  powers::base_kernel<<<dim3(powers::blocks(n), static_cast<unsigned>(rows)),
                        powers::THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(bases), static_cast<uint64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// re, im: the base's parts on the card; out: (2, n)
extern "C" int gl_ext_powers(const void* re, const void* im, void* out,
                             int64_t n, void* stream) {
  if (n <= 0) return 0;
  powers::ext_kernel<<<powers::blocks(n), powers::THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(re), static_cast<const uint64_t*>(im),
      static_cast<uint64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
