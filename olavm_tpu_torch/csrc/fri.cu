// K9 and K10: the FRI composition's two passes (stark/fri_kernels.py), so
// that the composition runs K9, one batched K1 forward, K10, K1 inverse and
// the coset scaling (csrc/quotient.cu gl_scale_powers), and no K3, add,
// sub or K7 chain; and K12, the FRI fold, one launch a fold.
//
// Replace no Pallas kernel: olavm_tpu forms the composition with jnp
// programs (olavm_tpu/stark/prover_device.py:733-769 `horner_lde`, the
// alpha-combination of each batch's rows and its coset LDE; :779-786
// `fri_xs`, the coset's points; :794-831 `friquot`, each batch's quotient;
// :834 `frimulx`, the degree bump), which the port ran as chains of K3,
// add, sub, cat and fill launches over whole columns (about 500 a table),
// reading each oracle row once per batch that uses it.
//
// K9 gl_fri_combine: for each batch b and column j < n,
//   out[b][part][j] = shift^j * sum_{rows r of b} alpha_{b,r}[part] c_r[j]
// (part re or im, alpha_{b,r} the bank's power of alpha for row r in batch
// b), and 0 for n <= j < size: the (B, 2, size) input of one batched coset
// LDE (K1 forward). Bound: memory, each row read once for every batch that
// uses it (the trace and Z rows feed batches 0 and 1, the CTL Zs all three)
// and B * 2 * size words written; the products (two a row and batch, some
// 22 instructions each with their sums) come close to it, and on the card
// they hold it (PERF.md). So a thread owns COMBINE_COLS columns,
// neighbouring threads on neighbouring columns (each load coalesced),
// reads each row once, keeps 2 B unreduced 160-bit sums a column
// (gl::acc_add, as csrc/constraints.cuh) and reduces each once; shift^j is
// one exponentiation a thread and one product a column (as
// gl_scale_powers).
// The plan (the oracles' base pointers and each segment of rows with its
// alpha offsets per batch) goes by value in the kernel's parameters, so a
// replayed graph needs no copy; the alpha powers stay in the device bank,
// where the challenges enter, read as uniform loads.
//
// K10 gl_fri_quotient: for each point i of the coset, x_i = shift * w^i,
//   F <- F * alpha^{len_b} + (v_b(x_i) - y_b) / (x_i - z_b)  for b in order,
//   out[part][i] = (F * x_i)[part],
// z_b, y_b and alpha^{len_b} from the bank. With 1/(x - z) =
// (x - z_re + z_im phi) / N_b, the base norm N_b = (x - z_re)^2 - 7 z_im^2,
// and C_b the product of the later batches' alpha^len (F's Horner steps
// unrolled: F = sum_b C_b q_b),
//   F x = x / D * sum_b n_b w_b,  w_b = Q_b C_b (x - z_re + z_im phi),
// n_b = v_b - y_b, D = prod_b N_b and Q_b the product of the other
// batches' norms: one inversion a point (of D) in place of B, and no
// Horner chain. A zero norm enters D and the Q as 1 and zeroes its own
// Q_b, so its batch adds 0 (what gfe.inv gives; the coset misses H, so no
// real denominator is 0). C_b and K_b = z_im phi C_b are a block's
// constants (w_b = u C_b + Q_b K_b, u = Q_b (x - z_re)), in shared memory,
// made once a block by its first thread. A point's sum of B extension
// products goes into three 160-bit sums (re x re, im x im for the 7 phi^2
// term, and im), each reduced once.
// A thread takes QUOTIENT_PAIRS pairs of points (j, j + size / 2), j = t +
// k T for T threads (its loads and stores coalesced across the warp): x_j
// = shift * w^j from K1's twiddles of the coset's size (8 bytes a pair,
// no exponentiation), and x_{j + size/2} = -x_j (w^{size/2} = -1; times
// `half_step` = w^{ceil(size/2)} for any other w, the host tests' ragged
// sizes). A first pass over its points writes each point's sum times x
// (lazily) to `out` and keeps the running product of the D before it and
// D in shared memory; one gl::inv of the thread's product (Montgomery's
// trick over 2 QUOTIENT_PAIRS points); a second pass walks back, giving
// each point 1/D and its canonical value. The loops over the pairs stay
// rolled (a pass's body is one pair), so the code fits the instruction
// cache. Bound: the operations, about 14 products a batch and 3 a point
// (fri_quotient_bound's count), against 16 bytes read a batch and 16
// written a point.
//
// K12 gl_fri_fold: one FRI fold (olavm_tpu/stark/prover_device.py:887-921
// fold_fn, the "frifold" program, which the port ran as arity - 1
// extension products and sums over strided columns: about 244 K3, add, sub
// launches a fold at arity 16),
//   out[part][k] = (sum_{i < A} c_{kA+i} beta^i)[part],  A the arity,
// from the coefficients' re and im vectors and the (2, A) bank of beta's
// powers (beta^0 = 1 is not read: the first coefficient is added as it
// is). With (a + b phi)(c + d phi) = ac + 7 bd + (ad + bc) phi, a thread
// keeps three 160-bit sums an output (re x re, im x im and the im part's
// two products), reduces the im x im sum once and adds it times 7 (W) into
// the re sum, and reduces each part once. A thread's A values of a vector
// are 8 A contiguous bytes, which it reads with 16-byte vector loads, all
// issued before the products (a warp's loads cover 32 x 8 A contiguous
// bytes, each 32-byte sector read by two loads in a row). Bound: device
// memory, 16 A bytes read and 16 written an output; 4 (A - 1) + 1 products.
//
// The kernels call only goldilocks.cuh's gl:: helpers, and K10's first
// thread writes its block's shared constants before any other thread
// reads them, so with the CUDA qualifiers stubbed (shared memory as a
// static array, the barrier as nothing) a host compiler builds this
// namespace and runs every thread in turn (tests/test_torch_fri_kernels.py).
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace fri {

constexpr int MAX_ORACLES = 4;
constexpr int MAX_BATCHES = 4;
constexpr int MAX_SEGMENTS = 64;
constexpr int COMBINE_THREADS = 128;
// columns a thread of K9: 2 B x 2 160-bit sums in registers
constexpr int COMBINE_COLS = 2;
constexpr int QUOTIENT_THREADS = 128;
// pairs of points a thread of K10 (two words a point kept in shared
// memory for the pass back)
constexpr int QUOTIENT_PAIRS = 8;
constexpr int FOLD_THREADS = 128;
// blocks of a K12 launch at most (each thread then folds several outputs
// with beta's powers loaded once)
constexpr int FOLD_MAX_BLOCKS = 132 * 8;
// each batch's constants in K10's shared memory: z_re, z_im, 7 z_im^2, y,
// C (the later batches' alpha^len multiplied) and K = z_im phi C
enum { ZR, ZI, ZZ7, Y0, Y1, CR, CI, KR, KI, CONSTANTS };
constexpr uint64_t W = 7;

// rows [first, first + count) of one oracle and, per batch, the bank offsets
// of the first row's alpha power (re and im parts; row first + k's at + k),
// -1 where the batch does not read them
struct Segment {
  int32_t oracle, first, count;
  int32_t re[MAX_BATCHES], im[MAX_BATCHES];
};

struct CombinePlan {
  const uint64_t* oracles[MAX_ORACLES];
  int32_t segments;
  Segment seg[MAX_SEGMENTS];
};

// per batch, the bank offset of its point z, its reduced opening y and
// alpha^{len}, (re, im) each
struct QuotientPlan {
  int32_t point[MAX_BATCHES];
};

template <int B>
__global__ void __launch_bounds__(COMBINE_THREADS)
    combine_kernel(const CombinePlan plan, const uint64_t* __restrict__ bank,
                   uint64_t* __restrict__ out, int64_t n, int64_t size,
                   uint64_t shift) {
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * COMBINE_THREADS *
                         COMBINE_COLS + threadIdx.x;
  if (j0 >= n) {  // the padding
#pragma unroll
    for (int u = 0; u < COMBINE_COLS; ++u) {
      const int64_t j = j0 + u * COMBINE_THREADS;
      if (j < size)
#pragma unroll
        for (int r = 0; r < 2 * B; ++r) out[r * size + j] = 0;
    }
    return;
  }
  gl::u160 acc[B][2][COMBINE_COLS];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int u = 0; u < COMBINE_COLS; ++u) acc[b][p][u] = {0, 0, 0};
  for (int s = 0; s < plan.segments; ++s) {
    const Segment& sg = plan.seg[s];
    const uint64_t* rows =
        plan.oracles[sg.oracle] + static_cast<int64_t>(sg.first) * n;
    for (int k = 0; k < sg.count; ++k) {
      uint64_t c[COMBINE_COLS];
#pragma unroll
      for (int u = 0; u < COMBINE_COLS; ++u) {
        const int64_t j = j0 + u * COMBINE_THREADS;
        c[u] = j < n ? __ldg(rows + k * n + j) : 0;
      }
#pragma unroll
      for (int b = 0; b < B; ++b) {
        if (sg.re[b] < 0) continue;
        const uint64_t ar = __ldg(bank + sg.re[b] + k);
        const uint64_t ai = __ldg(bank + sg.im[b] + k);
#pragma unroll
        for (int u = 0; u < COMBINE_COLS; ++u) {
          gl::acc_add(acc[b][0][u], gl::mul_wide(c[u], ar));
          gl::acc_add(acc[b][1][u], gl::mul_wide(c[u], ai));
        }
      }
    }
  }
  // shift^j: the thread's first column's power, then shift^THREADS a step
  const uint64_t step = gl::pow_u64(shift, COMBINE_THREADS);
  uint64_t w = gl::pow_u64(shift, static_cast<uint64_t>(j0));
#pragma unroll
  for (int u = 0; u < COMBINE_COLS; ++u) {
    const int64_t j = j0 + u * COMBINE_THREADS;
    if (j < size) {
#pragma unroll
      for (int b = 0; b < B; ++b)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          out[(2 * b + p) * size + j] =
              j < n ? gl::mul(gl::reduce160_lazy(acc[b][p][u]), w) : 0;
    }
    w = gl::mul(w, step);
  }
}

// K10's constants of B batches from the bank, by one thread
template <int B>
__device__ __forceinline__ void quotient_constants(
    const QuotientPlan& plan, const uint64_t* bank,
    uint64_t (*cst)[CONSTANTS]) {
  uint64_t cr = 1, ci = 0;  // C_b, from the last batch down
#pragma unroll
  for (int b = B - 1; b >= 0; --b) {
    const uint64_t* pt = bank + plan.point[b];
    const uint64_t zi = pt[1], zi7 = gl::mul(zi, W);
    cst[b][ZR] = pt[0];
    cst[b][ZI] = zi;
    cst[b][ZZ7] = gl::mul(zi7, zi);
    cst[b][Y0] = pt[2];
    cst[b][Y1] = pt[3];
    cst[b][CR] = cr;
    cst[b][CI] = ci;
    cst[b][KR] = gl::mul(zi7, ci);
    cst[b][KI] = gl::mul(zi, cr);
    // C_{b-1} = C_b alpha_b^len
    const uint64_t c0 = pt[4], c1 = pt[5];
    const uint64_t nr = gl::add(gl::mul(cr, c0), gl::mul(gl::mul(ci, c1), W));
    ci = gl::add(gl::mul(cr, c1), gl::mul(ci, c0));
    cr = nr;
  }
}

// K10's first pass at point i, x = x_i canonical: writes x sum_b n_b w_b
// (lazy) to out[i] and out[size + i] and returns D, the product of the
// nonzero norms
template <int B>
__device__ __forceinline__ uint64_t quotient_point(
    uint64_t (*cst)[CONSTANTS], const uint64_t* __restrict__ values,
    uint64_t* __restrict__ out, int64_t size, int64_t i, uint64_t x) {
  uint64_t a[B], nz[B];
  bool zero[B];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    a[b] = gl::sub(x, cst[b][ZR]);
    const uint64_t norm = gl::sub(gl::mul(a[b], a[b]), cst[b][ZZ7]);
    zero[b] = norm == 0;
    nz[b] = zero[b] ? 1 : norm;
  }
  // q[b] the product of the other batches' norms (prefix times suffix),
  // d all of them
  uint64_t q[B], d;
  if constexpr (B == 1) {
    q[0] = 1;
    d = nz[0];
  } else {
    uint64_t pre[B], suf[B];
    pre[1] = nz[0];
#pragma unroll
    for (int b = 2; b < B; ++b) pre[b] = gl::mul_lazy(pre[b - 1], nz[b - 1]);
    suf[B - 1] = nz[B - 1];
#pragma unroll
    for (int b = B - 2; b >= 1; --b) suf[b] = gl::mul_lazy(suf[b + 1], nz[b]);
    q[0] = suf[1];
    q[B - 1] = pre[B - 1];
#pragma unroll
    for (int b = 1; b < B - 1; ++b) q[b] = gl::mul_lazy(pre[b], suf[b + 1]);
    d = gl::mul_lazy(pre[B - 1], nz[B - 1]);
  }
  gl::u160 s_re = {0, 0, 0}, s_w = {0, 0, 0}, s_im = {0, 0, 0};
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const uint64_t qb = zero[b] ? 0 : q[b];
    const uint64_t u = gl::mul_lazy(qb, a[b]);
    uint64_t wr, wi;
    if (b == B - 1) {  // C = 1, K = z_im phi
      wr = u;
      wi = gl::mul_lazy(qb, cst[b][ZI]);
    } else {
      gl::u160 t = {0, 0, 0};
      gl::acc_add(t, gl::mul_wide(u, cst[b][CR]));
      gl::acc_add(t, gl::mul_wide(qb, cst[b][KR]));
      wr = gl::reduce160_lazy(t);
      t = {0, 0, 0};
      gl::acc_add(t, gl::mul_wide(u, cst[b][CI]));
      gl::acc_add(t, gl::mul_wide(qb, cst[b][KI]));
      wi = gl::reduce160_lazy(t);
    }
    // (n0 + n1 phi)(wr + wi phi) = n0 wr + 7 n1 wi + (n0 wi + n1 wr) phi
    const uint64_t n0 = gl::sub(__ldg(values + (2 * b) * size + i),
                                cst[b][Y0]);
    const uint64_t n1 = gl::sub(__ldg(values + (2 * b + 1) * size + i),
                                cst[b][Y1]);
    gl::acc_add(s_re, gl::mul_wide(n0, wr));
    gl::acc_add(s_w, gl::mul_wide(n1, wi));
    gl::acc_add(s_im, gl::mul_wide(n0, wi));
    gl::acc_add(s_im, gl::mul_wide(n1, wr));
  }
  gl::acc_add(s_re, gl::mul_wide(gl::reduce160_lazy(s_w), W));
  out[i] = gl::mul_lazy(gl::reduce160_lazy(s_re), x);
  out[size + i] = gl::mul_lazy(gl::reduce160_lazy(s_im), x);
  return d;
}

template <int B>
__global__ void __launch_bounds__(QUOTIENT_THREADS)
    quotient_kernel(const QuotientPlan plan,
                    const uint64_t* __restrict__ values,
                    const uint64_t* __restrict__ bank,
                    const uint64_t* __restrict__ tw,
                    uint64_t* __restrict__ out, int64_t size, uint64_t shift,
                    uint64_t half_step) {
  // each batch's constants, made once a block by its first thread
  __shared__ uint64_t cst[B][CONSTANTS];
  // per point p = 2 k + (upper) of each thread: the product of the D of
  // its earlier points (keep[2 p]) and its D (keep[2 p + 1])
  __shared__ uint64_t keep[4 * QUOTIENT_PAIRS][QUOTIENT_THREADS];
  if (threadIdx.x == 0) quotient_constants<B>(plan, bank, cst);
  __syncthreads();
  const int64_t half = (size + 1) / 2;
  const int64_t threads = (half + QUOTIENT_PAIRS - 1) / QUOTIENT_PAIRS;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= threads) return;
  const unsigned me = threadIdx.x;
  const bool negate = half_step == gl::P - 1;
  uint64_t run = 1;
#pragma unroll 1
  for (int k = 0; k < QUOTIENT_PAIRS; ++k) {
    const int64_t j = t + k * threads;
    if (j >= half) break;
    const uint64_t x = gl::mul(shift, __ldg(tw + j));
    uint64_t d = quotient_point<B>(cst, values, out, size, j, x);
    keep[4 * k][me] = run;
    keep[4 * k + 1][me] = d;
    run = gl::mul_lazy(run, d);
    if (j + half < size) {
      const uint64_t xu = negate ? (x ? gl::P - x : 0)
                                 : gl::mul(x, half_step);
      d = quotient_point<B>(cst, values, out, size, j + half, xu);
      keep[4 * k + 2][me] = run;
      keep[4 * k + 3][me] = d;
      run = gl::mul_lazy(run, d);
    }
  }
  // inv_run = 1 / (the product of the D up to the point below), walking
  // back
  uint64_t inv_run = gl::inv(run);
#pragma unroll 1
  for (int k = QUOTIENT_PAIRS - 1; k >= 0; --k) {
    const int64_t j = t + k * threads;
    if (j >= half) continue;
#pragma unroll
    for (int u = 1; u >= 0; --u) {
      const int64_t i = j + u * half;
      if (i >= size) continue;
      const uint64_t inv_d = gl::mul_lazy(inv_run, keep[4 * k + 2 * u][me]);
      inv_run = gl::mul_lazy(inv_run, keep[4 * k + 2 * u + 1][me]);
      out[i] = gl::mul(out[i], inv_d);
      out[size + i] = gl::mul(out[size + i], inv_d);
    }
  }
}

template <int A>
__global__ void __launch_bounds__(FOLD_THREADS)
    fold_kernel(const uint64_t* __restrict__ re,
                const uint64_t* __restrict__ im,
                const uint64_t* __restrict__ bpows,
                uint64_t* __restrict__ out, int64_t m) {
  uint64_t br[A], bi[A];
#pragma unroll
  for (int i = 1; i < A; ++i) {
    br[i] = __ldg(bpows + i);
    bi[i] = __ldg(bpows + A + i);
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * FOLD_THREADS;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * FOLD_THREADS +
                   threadIdx.x;
       k < m; k += stride) {
    const ulonglong2* pr = reinterpret_cast<const ulonglong2*>(re + k * A);
    const ulonglong2* pi = reinterpret_cast<const ulonglong2*>(im + k * A);
    uint64_t r[A], q[A];
#pragma unroll
    for (int i = 0; i < A / 2; ++i) {
      const ulonglong2 a = __ldg(pr + i), b = __ldg(pi + i);
      r[2 * i] = a.x;
      r[2 * i + 1] = a.y;
      q[2 * i] = b.x;
      q[2 * i + 1] = b.y;
    }
    gl::u160 s_re = {r[0], 0, 0}, s_w = {0, 0, 0}, s_im = {q[0], 0, 0};
#pragma unroll
    for (int i = 1; i < A; ++i) {
      gl::acc_add(s_re, gl::mul_wide(r[i], br[i]));
      gl::acc_add(s_w, gl::mul_wide(q[i], bi[i]));
      gl::acc_add(s_im, gl::mul_wide(r[i], bi[i]));
      gl::acc_add(s_im, gl::mul_wide(q[i], br[i]));
    }
    gl::acc_add(s_re, gl::mul_wide(gl::reduce160_lazy(s_w), W));
    out[k] = gl::canonical(gl::reduce160_lazy(s_re));
    out[m + k] = gl::canonical(gl::reduce160_lazy(s_im));
  }
}

inline unsigned fold_blocks(int64_t m) {
  const int64_t b = (m + FOLD_THREADS - 1) / FOLD_THREADS;
  return static_cast<unsigned>(b < 1 ? 1
                                     : (b > FOLD_MAX_BLOCKS ? FOLD_MAX_BLOCKS
                                                            : b));
}

inline unsigned combine_blocks(int64_t size) {
  const int64_t per_block = COMBINE_THREADS * COMBINE_COLS;
  return static_cast<unsigned>((size + per_block - 1) / per_block);
}

inline unsigned quotient_blocks(int64_t size) {
  const int64_t threads =
      ((size + 1) / 2 + QUOTIENT_PAIRS - 1) / QUOTIENT_PAIRS;
  return static_cast<unsigned>((threads + QUOTIENT_THREADS - 1) /
                               QUOTIENT_THREADS);
}

}  // namespace fri

#define FRI_DISPATCH(B_, launch) \
  switch (B_) {                  \
    case 1: launch(1); break;    \
    case 2: launch(2); break;    \
    case 3: launch(3); break;    \
    case 4: launch(4); break;    \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// plan: a host fri::CombinePlan of `batches` batches; out: (batches, 2, size)
extern "C" int gl_fri_combine(const void* plan, int batches, const void* bank,
                              void* out, int64_t n, int64_t size,
                              uint64_t shift, void* stream) {
  const auto& p = *static_cast<const fri::CombinePlan*>(plan);
  const auto s = static_cast<cudaStream_t>(stream);
#define FRI_COMBINE(B)                                                      \
  fri::combine_kernel<B><<<fri::combine_blocks(size), fri::COMBINE_THREADS, \
                           0, s>>>(p, static_cast<const uint64_t*>(bank),   \
                                   static_cast<uint64_t*>(out), n, size,    \
                                   shift)
  FRI_DISPATCH(batches, FRI_COMBINE)
#undef FRI_COMBINE
  return static_cast<int>(cudaGetLastError());
}

// plan: a host fri::QuotientPlan; values: (batches, 2, size); tw: w^j for
// j < ceil(size / 2); half_step: w^ceil(size / 2) (p - 1 for a root of
// unity of order size); out: (2, size)
extern "C" int gl_fri_quotient(const void* plan, int batches,
                               const void* values, const void* bank,
                               const void* tw, void* out, int64_t size,
                               uint64_t shift, uint64_t half_step,
                               void* stream) {
  const auto& p = *static_cast<const fri::QuotientPlan*>(plan);
  const auto s = static_cast<cudaStream_t>(stream);
  if (size <= 0) return 0;
#define FRI_QUOTIENT(B)                                                    \
  fri::quotient_kernel<B><<<fri::quotient_blocks(size),                    \
                            fri::QUOTIENT_THREADS, 0, s>>>(                \
      p, static_cast<const uint64_t*>(values),                             \
      static_cast<const uint64_t*>(bank), static_cast<const uint64_t*>(tw), \
      static_cast<uint64_t*>(out), size, shift, half_step)
  FRI_DISPATCH(batches, FRI_QUOTIENT)
#undef FRI_QUOTIENT
  return static_cast<int>(cudaGetLastError());
}

// re, im: (m A,) each, 16-byte aligned; bpows: (2, A) [re; im]; out: (2, m)
extern "C" int gl_fri_fold(const void* re, const void* im, const void* bpows,
                           void* out, int64_t m, int arity, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (m <= 0) return 0;
#define FRI_FOLD(A)                                                         \
  fri::fold_kernel<A><<<fri::fold_blocks(m), fri::FOLD_THREADS, 0, s>>>(    \
      static_cast<const uint64_t*>(re), static_cast<const uint64_t*>(im),   \
      static_cast<const uint64_t*>(bpows), static_cast<uint64_t*>(out), m)
  switch (arity) {
    case 2: FRI_FOLD(2); break;
    case 4: FRI_FOLD(4); break;
    case 8: FRI_FOLD(8); break;
    case 16: FRI_FOLD(16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FRI_FOLD
  return static_cast<int>(cudaGetLastError());
}
