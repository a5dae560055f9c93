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
// 22 instructions each with their sums) come close to it. So the loads
// must stay in flight while the products run: about 15-20 KB on each SM
// to reach the card's rate, more than a thread's registers hold beside its
// sums.
// - A block owns a strip of COMBINE_STRIP columns, a thread 2 neighbouring
//   columns (one 16-byte word of each row; neighbouring threads on
//   neighbouring words). It walks the plan's rows (its segments in order)
//   through a ring of COMBINE_STAGES stages in shared memory, each
//   COMBINE_ROWS rows of the strip: each thread copies its own word of
//   each row with a 16-byte cp.async (two 8-byte ones where n is odd), a
//   commit group a stage, and sums a stage once cp.async.wait_group says
//   that its own copies of it have landed, while the copies of the next
//   COMBINE_STAGES - 1 stages are in flight (24 KB a block). A thread reads
//   only the words it copied, so a stage needs no block barrier and no
//   mbarrier; a TMA bulk copy of a row's strip would need an issuing
//   thread and a full and an empty barrier a stage for the same bytes.
// - The bank (the alpha powers, the plan's offsets into it unchanged) is
//   copied into shared memory once a block, before the first barrier:
//   every row reads its batches' powers there.
// - A thread keeps 2 B x 2 unreduced 160-bit sums (gl::acc_add, as
//   csrc/constraints.cuh) and reduces each once. Where the plan is nested
//   (CombinePlan: prover_device.composition_bank gives batches 0 and 1 one
//   copy of the trace and Z rows' powers) a row that batches 0 and 1 share
//   goes into batch 1's sums only, which batch 0 adds once at the end:
//   CpuStark's 434 row products a column become 262. shift^j is one
//   exponentiation a block (its strip's first column, in shared memory), a
//   short one a thread (shift^(2 t)) and a product a column.
// - The padding columns past the last strip are zeroed by the strips'
//   blocks, each its share, 16 bytes a store, while its first stages load
//   (blocks of their own would write them after the strips' loads, not
//   beside them).
// The plan (the oracles' base pointers and each segment of rows with its
// alpha offsets per batch) goes by value in the kernel's parameters, so a
// replayed graph needs no copy; the alpha powers stay in the device bank,
// where the challenges enter.
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
// The kernels call only goldilocks.cuh's gl:: helpers and K9's copy
// helpers, each with a host twin (the copies synchronous), so with the
// CUDA qualifiers and the barrier stubbed (shared memory as a static
// array) a host compiler builds this namespace and runs a launch's blocks
// in turn, each block's threads side by side
// (tests/test_torch_fri_kernels.py, tests/torch_host_block.py).
#include <cuda_runtime.h>

#include <cstring>

#include "goldilocks.cuh"

namespace fri {

constexpr int MAX_ORACLES = 4;
constexpr int MAX_BATCHES = 4;
constexpr int MAX_SEGMENTS = 64;
constexpr int COMBINE_THREADS = 128;
// columns a thread of K9 (one 16-byte word of a row): 2 B x 2 160-bit sums
// in registers
constexpr int COMBINE_COLS = 2;
constexpr int COMBINE_STRIP = COMBINE_THREADS * COMBINE_COLS;
// rows a stage of K9's ring, and its stages: a stage is summed while the
// next COMBINE_STAGES - 1 are copied (30 KB of shared memory a block, 24 KB
// of it in flight; 4 x 4, 4 x 3, 2 x 6 and 2 x 8 ran slower on an H100)
constexpr int COMBINE_ROWS = 3;
constexpr int COMBINE_STAGES = 5;
// the bank words K9 holds in shared memory (8 KB; CpuStark's plan, the
// widest, has 542)
constexpr int COMBINE_BANK = 1024;
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

// nested: every segment that batch 1 reads, batch 0 reads with the same
// bank words (the FRI plan: batch 1 the trace and Z rows of batch 0), so
// those rows go into batch 1's sums only and batch 0 adds them at the end
struct CombinePlan {
  const uint64_t* oracles[MAX_ORACLES];
  int32_t segments;
  int32_t nested;
  Segment seg[MAX_SEGMENTS];
};

// per batch, the bank offset of its point z, its reduced opening y and
// alpha^{len}, (re, im) each
struct QuotientPlan {
  int32_t point[MAX_BATCHES];
};

// two neighbouring words, one 16-byte load or store
struct alignas(16) Pair {
  uint64_t a, b;
};

// cp.async: 16 (or 8) bytes from device memory into shared memory, in the
// thread's current commit group; copy_wait<N> waits until at most N of the
// thread's groups are in flight, and the thread's copies of the others
// are then visible to it. The host twins copy at once.
__device__ __forceinline__ void copy_async16(void* smem, const void* gmem) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
#else
  std::memcpy(smem, gmem, 16);
#endif
}

__device__ __forceinline__ void copy_async8(void* smem, const void* gmem) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
#else
  std::memcpy(smem, gmem, 8);
#endif
}

__device__ __forceinline__ void copy_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;" ::: "memory");
#endif
}

template <int N>
__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
#endif
}

// the cursor of a walk over the plan's rows: segment s, its row k
struct RowCursor {
  int s = 0, k = 0;
  __device__ __forceinline__ void next(const CombinePlan& plan) {
    if (++k == plan.seg[s].count) {
      ++s;
      k = 0;
    }
  }
};

// the padding columns [from, to) of the (rows, size) output zeroed by a
// block's threads, 16 bytes a store where VEC
template <bool VEC>
__device__ __forceinline__ void zero_columns(uint64_t* out, int rows,
                                             int64_t size, int64_t from,
                                             int64_t to) {
  for (int r = 0; r < rows; ++r) {
    uint64_t* const o = out + r * size;
    if constexpr (VEC) {
      for (int64_t j = from + 2 * threadIdx.x; j < to;
           j += 2 * COMBINE_THREADS)
        *reinterpret_cast<Pair*>(o + j) = {0, 0};
    } else {
      for (int64_t j = from + threadIdx.x; j < to; j += COMBINE_THREADS)
        o[j] = 0;
    }
  }
}

// VEC: n even and every pointer 16-byte aligned (rows move as Pairs).
// Block b owns the strip of columns [b STRIP, (b + 1) STRIP) and zeroes its
// share of the padding past the last strip (an even number of columns a
// block) while its first stages load. The plan is read where the launch
// put it (__grid_constant__: the walks over its segments take references
// into it, which would otherwise copy it to each thread's local memory).
template <int B, bool VEC>
__global__ void __launch_bounds__(COMBINE_THREADS)
    combine_kernel(const __grid_constant__ CombinePlan plan,
                   const uint64_t* __restrict__ bank,
                   int bank_words, uint64_t* __restrict__ out, int64_t n,
                   int64_t size, uint64_t shift) {
  __shared__ Pair ring[COMBINE_STAGES][COMBINE_ROWS][COMBINE_THREADS];
  __shared__ uint64_t alphas[COMBINE_BANK];
  const int tid = threadIdx.x;
  const int64_t j0 =
      static_cast<int64_t>(blockIdx.x) * COMBINE_STRIP + 2 * tid;
  const bool in0 = j0 < n, in1 = j0 + 1 < n;
  RowCursor copied, summed;
  // copy the thread's word of the next COMBINE_ROWS rows into a stage
  auto fill = [&](int stage) {
#pragma unroll
    for (int r = 0; r < COMBINE_ROWS; ++r) {
      if (copied.s < plan.segments) {
        const Segment& sg = plan.seg[copied.s];
        const uint64_t* src = plan.oracles[sg.oracle] +
                              static_cast<int64_t>(sg.first + copied.k) * n +
                              j0;
        Pair* const dst = &ring[stage][r][tid];
        if constexpr (VEC) {
          if (in0) copy_async16(dst, src);
        } else {
          if (in0) copy_async8(&dst->a, src);
          if (in1) copy_async8(&dst->b, src + 1);
        }
        copied.next(plan);
      }
    }
    copy_commit();
  };
#pragma unroll
  for (int st = 0; st < COMBINE_STAGES - 1; ++st) fill(st);
  const int64_t strips = static_cast<int64_t>(gridDim.x) * COMBINE_STRIP;
  if (size > strips) {
    const int64_t share =
        ((size - strips + gridDim.x - 1) / gridDim.x + 1) & ~int64_t{1};
    const int64_t from = strips + blockIdx.x * share;
    const int64_t to = from + share < size ? from + share : size;
    if (from < to) zero_columns<VEC>(out, 2 * B, size, from, to);
  }
  for (int i = tid; i < bank_words; i += COMBINE_THREADS)
    alphas[i] = __ldg(bank + i);
  // shift^(the strip's first column), one exponentiation a block
  __shared__ uint64_t strip_shift;
  if (tid == 0)
    strip_shift = gl::pow_u64(
        shift, static_cast<uint64_t>(blockIdx.x) * COMBINE_STRIP);
  __syncthreads();

  const bool nested = B > 1 && plan.nested;
  gl::u160 acc[B][2][COMBINE_COLS];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int u = 0; u < COMBINE_COLS; ++u) acc[b][p][u] = {0, 0, 0};
  for (int stage = 0; summed.s < plan.segments; ++stage) {
    // the stage summed last is refilled with the rows COMBINE_STAGES - 1
    // stages on
    fill((stage + COMBINE_STAGES - 1) % COMBINE_STAGES);
    copy_wait<COMBINE_STAGES - 1>();
    const int slot = stage % COMBINE_STAGES;
#pragma unroll
    for (int r = 0; r < COMBINE_ROWS; ++r) {
      if (summed.s < plan.segments) {
        const Segment& sg = plan.seg[summed.s];
        const Pair c = ring[slot][r][tid];
#pragma unroll
        for (int b = 0; b < B; ++b) {
          if (sg.re[b] < 0) continue;
          // a row that nests goes into batch 1's sums only
          if (B > 1 && b == 0 && nested && sg.re[1] >= 0) continue;
          const uint64_t ar = alphas[sg.re[b] + summed.k];
          const uint64_t ai = alphas[sg.im[b] + summed.k];
          gl::acc_add(acc[b][0][0], gl::mul_wide(c.a, ar));
          gl::acc_add(acc[b][1][0], gl::mul_wide(c.a, ai));
          gl::acc_add(acc[b][0][1], gl::mul_wide(c.b, ar));
          gl::acc_add(acc[b][1][1], gl::mul_wide(c.b, ai));
        }
        summed.next(plan);
      }
    }
  }
  // shift^j0 and shift^(j0 + 1); columns at or past n are 0
  const uint64_t w0 =
      in0 ? gl::mul(strip_shift, gl::pow_u64(shift, 2 * tid)) : 0;
  const uint64_t w1 = gl::mul(w0, shift);
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint64_t s0 = gl::reduce160_lazy(acc[b][p][0]);
      uint64_t s1 = gl::reduce160_lazy(acc[b][p][1]);
      if (B > 1 && b == 0 && nested) {  // batch 1's rows, folded in
        s0 = gl::add(s0, gl::canonical(gl::reduce160_lazy(acc[1][p][0])));
        s1 = gl::add(s1, gl::canonical(gl::reduce160_lazy(acc[1][p][1])));
      }
      const uint64_t v0 = in0 ? gl::mul(s0, w0) : 0;
      const uint64_t v1 = in1 ? gl::mul(s1, w1) : 0;
      uint64_t* const o = out + (2 * b + p) * size + j0;
      if constexpr (VEC) {
        if (j0 < size) *reinterpret_cast<Pair*>(o) = {v0, v1};
      } else {
        if (j0 < size) o[0] = v0;
        if (j0 + 1 < size) o[1] = v1;
      }
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

// K9's blocks: a strip of columns each over [0, n)
inline unsigned combine_blocks(int64_t n) {
  return static_cast<unsigned>((n + COMBINE_STRIP - 1) / COMBINE_STRIP);
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

// plan: a host fri::CombinePlan of `batches` batches; bank: bank_words
// words (at most fri::COMBINE_BANK); out: (batches, 2, size)
extern "C" int gl_fri_combine(const void* plan, int batches, const void* bank,
                              int bank_words, void* out, int64_t n,
                              int64_t size, uint64_t shift, void* stream) {
  const auto& p = *static_cast<const fri::CombinePlan*>(plan);
  const auto s = static_cast<cudaStream_t>(stream);
  if (bank_words < 0 || bank_words > fri::COMBINE_BANK || n < 0 || size < n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (size == 0) return 0;
  bool vec = n % 2 == 0 && size % 2 == 0 &&
             reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int i = 0; i < p.segments; ++i)
    vec = vec &&
          reinterpret_cast<uintptr_t>(p.oracles[p.seg[i].oracle]) % 16 == 0;
  const unsigned blocks = fri::combine_blocks(n);
#define FRI_COMBINE(B)                                                    \
  if (vec)                                                                \
    fri::combine_kernel<B, true><<<blocks, fri::COMBINE_THREADS, 0, s>>>( \
        p, static_cast<const uint64_t*>(bank), bank_words,                \
        static_cast<uint64_t*>(out), n, size, shift);                     \
  else                                                                    \
    fri::combine_kernel<B, false><<<blocks, fri::COMBINE_THREADS, 0, s>>>( \
        p, static_cast<const uint64_t*>(bank), bank_words,                \
        static_cast<uint64_t*>(out), n, size, shift)
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
