// The quotient's fixed kernels beside K6 (csrc/constraints.cuh): a residue
// class's coset scaling and its selector columns, so that the class runs
// no K3, add or sub launch.
//
// Replace no Pallas kernel: olavm_tpu computes both in its `qvals`
// programs with jnp (olavm_tpu/stark/prover_device.py:155-167, the coset
// FFT's x * shift^i and the Lagrange selectors). The class's shift and
// constants live on the card (quotient_class's `cls`, a program input), so
// they are read there.
//
// gl_scale_powers: out[c][i] = x[c][i] * factor * base^i over (C, n) (the
// factor 1 in a class; a coset iNTT folds its 1/n in), base read from the
// card (a class's shift, a program input) or passed by value (a host
// constant: ntt/ntt.py's coset transforms, and base 1 for intt's 1/n).
// Bound: memory (16 bytes per element); one thread per point i computes
// factor * base^i once (square and multiply, then a product per grid
// stride) and scales the C columns, coalesced across threads.
// gl_quotient_selectors: with x_i = shift * g^i on the class's coset,
// (3, n) columns z_last = x - g^{-1}, lagrange_first = c/n / (x - 1) and
// lagrange_last = c g^{-1}/n / (x - g^{-1}). The inverses by batch
// (Montgomery) inversion: a thread takes SEL_CHUNK points, i = t + k*T for
// T threads, so its stores are coalesced across threads; it forms the
// product q_k = (x_k - 1)(x_k - g^{-1}) of each point's two denominators,
// their prefix products, one inverse x^(p-2) of the whole (gl::inv, as
// K7 in csrc/gf_inv.cu), and walks back
// to each 1/q_k, which times the other denominator gives each inverse.
// About 9 products a point and an exponentiation a thread. No
// denominator is 0: the class's coset shift*H is disjoint from H. Bound:
// memory (24 bytes a point written).
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 256;
// points of gl_quotient_selectors per thread
constexpr int SEL_CHUNK = 16;
constexpr int SEL_THREADS = 128;

__global__ void scale_powers_kernel(const uint64_t* __restrict__ x,
                                    uint64_t* __restrict__ out,
                                    const uint64_t* __restrict__ base_ptr,
                                    int64_t cols, int64_t n,
                                    uint64_t factor = 1,
                                    uint64_t base_value = 1) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const uint64_t base = base_ptr ? __ldg(base_ptr) : base_value;
  const uint64_t step = gl::pow_u64(base, static_cast<uint64_t>(stride));
  uint64_t w =
      gl::mul(factor, gl::pow_u64(base, static_cast<uint64_t>(first)));
  for (int64_t i = first; i < n; i += stride, w = gl::mul(w, step))
    for (int64_t c = 0; c < cols; ++c)
      out[c * n + i] = gl::mul(__ldg(x + c * n + i), w);
}

__global__ void selectors_kernel(const uint64_t* __restrict__ cls,
                                 uint64_t* __restrict__ out, int64_t n,
                                 uint64_t gen, uint64_t gen_inv) {
  const int64_t threads = (n + SEL_CHUNK - 1) / SEL_CHUNK;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= threads) return;
  const uint64_t shift = __ldg(cls), c_n = __ldg(cls + 1),
                 c_n_last = __ldg(cls + 2);
  const uint64_t step = gl::pow_u64(gen, static_cast<uint64_t>(threads));
  uint64_t x = gl::mul(shift, gl::pow_u64(gen, static_cast<uint64_t>(t)));
  // d[k] = x_k - 1, q[k] = (x_k - 1)(x_k - g^{-1}), pre[k] = q_0 ... q_k
  uint64_t d[SEL_CHUNK], q[SEL_CHUNK], pre[SEL_CHUNK];
  uint64_t acc = 1;
#pragma unroll
  for (int k = 0; k < SEL_CHUNK; ++k) {
    const int64_t i = t + k * threads;
    d[k] = gl::sub(x, 1);
    q[k] = 1;
    if (i < n) {
      const uint64_t z_last = gl::sub(x, gen_inv);
      out[i] = z_last;
      q[k] = gl::mul(d[k], z_last);
      acc = gl::mul(acc, q[k]);
    }
    pre[k] = acc;
    x = gl::mul(x, step);
  }
  // inv_acc = 1 / (q_0 ... q_k) for the k of each step below
  uint64_t inv_acc = gl::inv(acc);
#pragma unroll
  for (int k = SEL_CHUNK - 1; k >= 0; --k) {
    const int64_t i = t + k * threads;
    const uint64_t inv_q = k ? gl::mul(inv_acc, pre[k - 1]) : inv_acc;
    inv_acc = gl::mul(inv_acc, q[k]);
    if (i < n) {
      const uint64_t z_last = gl::sub(gl::add(d[k], 1), gen_inv);
      out[n + i] = gl::mul(c_n, gl::mul(inv_q, z_last));
      out[2 * n + i] = gl::mul(c_n_last, gl::mul(inv_q, d[k]));
    }
  }
}

}  // namespace

// base: a one-element device array, or null for base_value; base_value and
// factor: canonical constants
extern "C" int gl_scale_powers(const void* x, void* out, const void* base,
                               uint64_t base_value, uint64_t factor,
                               int64_t cols, int64_t n, void* stream) {
  scale_powers_kernel<<<gl::grid_for(n, THREADS), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(x), static_cast<uint64_t*>(out),
      static_cast<const uint64_t*>(base), cols, n, factor, base_value);
  return static_cast<int>(cudaGetLastError());
}

// cls: [shift, c/n, c g^{-1}/n, ...] on the device; gen the subgroup's
// generator g and gen_inv its inverse
extern "C" int gl_quotient_selectors(const void* cls, void* out, int64_t n,
                                     uint64_t gen, uint64_t gen_inv,
                                     void* stream) {
  const int64_t threads = (n + SEL_CHUNK - 1) / SEL_CHUNK;
  selectors_kernel<<<static_cast<unsigned>((threads + SEL_THREADS - 1) /
                                           SEL_THREADS),
                     SEL_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(cls), static_cast<uint64_t*>(out), n, gen,
      gen_inv);
  return static_cast<int>(cudaGetLastError());
}
