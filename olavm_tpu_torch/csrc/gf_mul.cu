// K3: element-wise Goldilocks multiply, plus add and sub on the same path.
//
// Replaces olavm_tpu/field/pallas_kernels.py:79 mul_pallas (_mul_call :60,
// body _mul_kernel :53), which multiplies (lo, hi) u32 limb pairs in 64K
// blocks held in VMEM. Here one thread computes one canonical product with
// a native 64x64 multiply and the EPSILON reduction (goldilocks.cuh).
//
// Bound: device memory. Each element reads 16 bytes and writes 8 against
// ~10 integer operations, far below the H100's operations-per-byte line,
// so the kernel is a grid-stride loop with coalesced 8-byte accesses and
// no shared memory. A 0-dim operand (a challenge or constant in the AIR
// code) is read through a stride of 0, so no broadcast copy is made.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

enum Op { MUL, ADD, SUB };

template <Op OP>
__global__ void binop_kernel(const uint64_t* __restrict__ a,
                             const uint64_t* __restrict__ b,
                             uint64_t* __restrict__ out, int64_t n,
                             int64_t sa, int64_t sb) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint64_t x = a[i * sa];
    const uint64_t y = b[i * sb];
    uint64_t r;
    if (OP == MUL) r = gl::mul(x, y);
    else if (OP == ADD) r = gl::add(x, y);
    else r = gl::sub(x, y);
    out[i] = r;
  }
}

template <Op OP>
int launch(const void* a, const void* b, void* out, int64_t n, int64_t sa,
           int64_t sb, void* stream) {
  const int threads = 256;
  binop_kernel<OP><<<gl::grid_for(n, threads), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(a), static_cast<const uint64_t*>(b),
      static_cast<uint64_t*>(out), n, sa, sb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sa, sb: 1 for a full operand, 0 for a one-element operand
extern "C" int gl_mul(const void* a, const void* b, void* out, int64_t n,
                      int64_t sa, int64_t sb, void* stream) {
  return launch<MUL>(a, b, out, n, sa, sb, stream);
}

extern "C" int gl_add(const void* a, const void* b, void* out, int64_t n,
                      int64_t sa, int64_t sb, void* stream) {
  return launch<ADD>(a, b, out, n, sa, sb, stream);
}

extern "C" int gl_sub(const void* a, const void* b, void* out, int64_t n,
                      int64_t sa, int64_t sb, void* stream) {
  return launch<SUB>(a, b, out, n, sa, sb, stream);
}
