// Native batched Goldilocks NTT for the host-side prover paths (the analogue
// of the reference's rayon fft + CUDA NTT offload,
// plonky2/field/src/fft.rs and field/src/cfft/ntt/).
// The TPU device NTT (olavm_tpu/ntt/ntt.py) is the accelerator path; this
// covers host boxes and small/odd shapes without paying XLA-CPU compiles.
//
// Layout: data is a row-major (batch, n) array of canonical u64 field
// elements; the transform runs independently per row (radix-2 DIT, in-place,
// bit-reversal first). Twiddles are passed in flattened per-stage
// (1 + 2 + ... + n/2 = n-1 elements), precomputed/cached on the Python side.

#include <cstdint>
#include <thread>
#include <vector>

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef uint32_t u32;

static const u64 P = 0xFFFFFFFF00000001ULL;
static const u64 EPSILON = 0xFFFFFFFFULL;

static inline u64 gl_add(u64 a, u64 b) {
    u64 s = a + b;
    if (s < a) s += EPSILON;
    if (s >= P) s -= P;
    return s;
}

static inline u64 gl_sub(u64 a, u64 b) {
    // a, b canonical (< p): on borrow, a-b+2^64-EPSILON == a-b+p, in [0,p)
    u64 d = a - b;
    if (a < b) d -= EPSILON;
    return d;
}

static inline u64 gl_reduce128(u128 x) {
    u64 lo = (u64)x;
    u64 hi = (u64)(x >> 64);
    u64 hi_hi = hi >> 32;
    u64 hi_lo = hi & EPSILON;
    u64 t0 = lo - hi_hi;
    if (lo < hi_hi) t0 -= EPSILON;
    u64 t1 = hi_lo * EPSILON;
    u64 t2 = t0 + t1;
    if (t2 < t0) t2 += EPSILON;
    if (t2 >= P) t2 -= P;
    return t2;
}

static inline u64 gl_mul(u64 a, u64 b) {
    return gl_reduce128((u128)a * (u128)b);
}

static int hw_threads() {
    unsigned n = std::thread::hardware_concurrency();
    return n ? (int)n : 2;
}

// one row, in place; rev: precomputed bit-reversal permutation
static void ntt_row(u64* a, u64 n, const u32* rev, const u64* twiddles) {
    for (u64 i = 0; i < n; i++) {
        u32 j = rev[i];
        if (i < j) { u64 t = a[i]; a[i] = a[j]; a[j] = t; }
    }
    const u64* tw = twiddles;
    for (u64 half = 1; half < n; half <<= 1) {
        for (u64 blk = 0; blk < n; blk += half << 1) {
            u64* lo = a + blk;
            u64* hi = a + blk + half;
            for (u64 k = 0; k < half; k++) {
                u64 v = gl_mul(hi[k], tw[k]);
                u64 u = lo[k];
                lo[k] = gl_add(u, v);
                hi[k] = gl_sub(u, v);
            }
        }
        tw += half;
    }
}

extern "C" void ntt_batch(u64* data, u64 batch, u64 n, const u64* twiddles) {
    if (n <= 1) return;
    std::vector<u32> rev(n);
    u64 log_n = 0;
    while ((1ULL << log_n) < n) log_n++;
    rev[0] = 0;
    for (u64 i = 1; i < n; i++)
        rev[i] = (rev[i >> 1] >> 1) | (u32)((i & 1) << (log_n - 1));

    int nt = hw_threads();
    if (batch <= 1 || nt <= 1) {
        for (u64 b = 0; b < batch; b++) ntt_row(data + b * n, n, rev.data(), twiddles);
        return;
    }
    std::vector<std::thread> ts;
    u64 per = (batch + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
        u64 lo = t * per, hi = lo + per > batch ? batch : lo + per;
        if (lo >= hi) break;
        ts.emplace_back([=]() {
            for (u64 b = lo; b < hi; b++)
                ntt_row(data + b * n, n, rev.data(), twiddles);
        });
    }
    for (auto& th : ts) th.join();
}

// data[b][j] *= powers[j] for every row b (coset shift / n^-1 scaling)
extern "C" void scale_rows(u64* data, u64 batch, u64 n, const u64* powers) {
    int nt = hw_threads();
    std::vector<std::thread> ts;
    u64 per = (batch + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
        u64 lo = t * per, hi = lo + per > batch ? batch : lo + per;
        if (lo >= hi) break;
        ts.emplace_back([=]() {
            for (u64 b = lo; b < hi; b++) {
                u64* row = data + b * n;
                for (u64 j = 0; j < n; j++) row[j] = gl_mul(row[j], powers[j]);
            }
        });
    }
    for (auto& th : ts) th.join();
}

extern "C" void mul_scalar(u64* data, u64 count, u64 c) {
    for (u64 i = 0; i < count; i++) data[i] = gl_mul(data[i], c);
}

// out[b][j] = sum_k data[k][j] * coeffs[b][k]  (small matrix combine; unused
// fallback for batched alpha-reductions)
extern "C" void mul_arrays(u64* a, const u64* b, u64 count) {
    for (u64 i = 0; i < count; i++) a[i] = gl_mul(a[i], b[i]);
}

extern "C" void add_arrays(u64* a, const u64* b, u64 count) {
    for (u64 i = 0; i < count; i++) a[i] = gl_add(a[i], b[i]);
}

extern "C" void sub_arrays(u64* a, const u64* b, u64 count) {
    for (u64 i = 0; i < count; i++) a[i] = gl_sub(a[i], b[i]);
}

static u64 gl_exp(u64 base, u64 e) {
    u64 result = 1;
    while (e) {
        if (e & 1) result = gl_mul(result, base);
        base = gl_mul(base, base);
        e >>= 1;
    }
    return result;
}

extern "C" u64 gl_inv(u64 a) { return gl_exp(a, P - 2); }

// out[i] = base^i for i in [0, n)
extern "C" void gl_powers(u64 base, u64 n, u64* out) {
    u64 acc = 1;
    for (u64 i = 0; i < n; i++) { out[i] = acc; acc = gl_mul(acc, base); }
}

// In-place Montgomery batch inversion; zeros map to zero.
extern "C" void batch_inv(u64* a, u64 n) {
    if (!n) return;
    std::vector<u64> prefix(n);
    u64 acc = 1;
    for (u64 i = 0; i < n; i++) {
        prefix[i] = acc;
        u64 v = a[i] ? a[i] : 1;
        acc = gl_mul(acc, v);
    }
    u64 inv = gl_exp(acc, P - 2);
    for (u64 i = n; i-- > 0;) {
        u64 v = a[i] ? a[i] : 1;
        u64 res = gl_mul(inv, prefix[i]);
        inv = gl_mul(inv, v);
        a[i] = a[i] ? res : 0;
    }
}

// acc = acc * m + c over parallel arrays (constraint-accumulator fma)
extern "C" void fma_arrays(u64* acc, const u64* m, const u64* c, u64 count) {
    for (u64 i = 0; i < count; i++)
        acc[i] = gl_add(gl_mul(acc[i], m[i]), c[i]);
}

// acc = acc * s + c (scalar multiplier)
extern "C" void fma_scalar(u64* acc, u64 s, const u64* c, u64 count) {
    for (u64 i = 0; i < count; i++)
        acc[i] = gl_add(gl_mul(acc[i], s), c[i]);
}

// out[k] = sum_j data[k][j] * vec[j]  (per-row modular dot product; the
// prover's opening evaluations sum_i c_i z^i over many polynomials)
extern "C" void dot_rows(const u64* data, u64 batch, u64 n, const u64* vec,
                         u64* out) {
    int hw = (int)std::thread::hardware_concurrency();
    int nt = hw ? hw : 2;
    std::vector<std::thread> ts;
    u64 per = (batch + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
        u64 lo = t * per, hi = lo + per > batch ? batch : lo + per;
        if (lo >= hi) break;
        ts.emplace_back([=]() {
            for (u64 b = lo; b < hi; b++) {
                const u64* row = data + b * n;
                u64 acc = 0;
                for (u64 j = 0; j < n; j++)
                    acc = gl_add(acc, gl_mul(row[j], vec[j]));
                out[b] = acc;
            }
        });
    }
    for (auto& th : ts) th.join();
}
