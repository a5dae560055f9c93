// Native Goldilocks + Poseidon kernels for the host-side runtime:
// challenger duplexing, sponge hashing over long streams, PoW grinding,
// Merkle compression, and batched permutations with intermediate-trace
// capture. The TPU handles the batched prover math; this covers the
// sequential host paths the reference runs on rayon threads.
//
// Field: p = 2^64 - 2^32 + 1, EPSILON reduction (same trick as
// plonky2/field/src/goldilocks_field.rs:296-326).
// Poseidon: width 12, 4+4 full rounds, 22 fast partial rounds
// (plonky2/plonky2/src/hash/poseidon.rs); constants injected at init from
// the Python side (poseidon_constants.json).

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef uint32_t u32;

static const u64 P = 0xFFFFFFFF00000001ULL;
static const u64 EPSILON = 0xFFFFFFFFULL;

static inline u64 gl_add(u64 a, u64 b) {
    u64 s = a + b;
    int carry = s < a;
    if (carry) s += EPSILON;
    if (s >= P) s -= P;
    return s;
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

// ----- Poseidon constants (set once via init) -----
static u64 ALL_ROUND_CONSTANTS[360];
static u64 MDS_CIRC[12];
static u64 MDS_DIAG[12];
static u64 FP_FIRST[12];
static u64 FP_CONST[22];
static u64 FP_VS[22][11];
static u64 FP_WHATS[22][11];
static u64 FP_INIT[11][11];

extern "C" void init_poseidon(const u64* arc, const u64* circ, const u64* diag,
                              const u64* fp_first, const u64* fp_const,
                              const u64* fp_vs, const u64* fp_whats,
                              const u64* fp_init) {
    memcpy(ALL_ROUND_CONSTANTS, arc, sizeof(ALL_ROUND_CONSTANTS));
    memcpy(MDS_CIRC, circ, sizeof(MDS_CIRC));
    memcpy(MDS_DIAG, diag, sizeof(MDS_DIAG));
    memcpy(FP_FIRST, fp_first, sizeof(FP_FIRST));
    memcpy(FP_CONST, fp_const, sizeof(FP_CONST));
    memcpy(FP_VS, fp_vs, sizeof(FP_VS));
    memcpy(FP_WHATS, fp_whats, sizeof(FP_WHATS));
    memcpy(FP_INIT, fp_init, sizeof(FP_INIT));
}

static inline u64 sbox(u64 x) {
    u64 x2 = gl_mul(x, x);
    u64 x4 = gl_mul(x2, x2);
    u64 x3 = gl_mul(x, x2);
    return gl_mul(x3, x4);
}

static void mds_layer(const u64* in, u64* out) {
    for (int r = 0; r < 12; r++) {
        u128 acc = 0;
        for (int i = 0; i < 12; i++) {
            acc += (u128)in[(i + r) % 12] * (u128)MDS_CIRC[i];
        }
        acc += (u128)in[r] * (u128)MDS_DIAG[r];
        out[r] = gl_reduce128(acc);
    }
}

// Full permutation; if trace != nullptr, captures the PoseidonRow
// intermediate states: full_0_1..3 (12 each), partial (22), full_1_0..3
// (12 each) -> 22 + 7*12 = 106 values.
static void poseidon_permute(u64* state, u64* trace) {
    u64 tmp[12];
    int tpos_full = 0;
    // first 4 full rounds
    for (int r = 0; r < 4; r++) {
        for (int i = 0; i < 12; i++)
            state[i] = gl_add(state[i], ALL_ROUND_CONSTANTS[i + 12 * r]);
        if (trace && r >= 1) {
            memcpy(trace + (r - 1) * 12, state, 12 * sizeof(u64));
        }
        for (int i = 0; i < 12; i++) state[i] = sbox(state[i]);
        mds_layer(state, tmp);
        memcpy(state, tmp, sizeof(tmp));
    }
    // partial rounds
    for (int i = 0; i < 12; i++) state[i] = gl_add(state[i], FP_FIRST[i]);
    {
        // mds_partial_layer_init (NB: sums of full 64x64 products overflow
        // u128, so reduce each product before accumulating)
        u64 res[12];
        res[0] = state[0];
        for (int c = 1; c < 12; c++) {
            u64 acc = 0;
            for (int r = 1; r < 12; r++)
                acc = gl_add(acc, gl_mul(state[r], FP_INIT[r - 1][c - 1]));
            res[c] = acc;
        }
        memcpy(state, res, sizeof(res));
    }
    for (int r = 0; r < 22; r++) {
        if (trace) trace[36 + r] = state[0];
        u64 s0 = sbox(state[0]);
        if (r < 21) s0 = gl_add(s0, FP_CONST[r]);
        // fast partial layer (reduce per product; see init-layer note)
        u64 d = gl_mul(s0, MDS_CIRC[0] + MDS_DIAG[0]);
        for (int i = 1; i < 12; i++)
            d = gl_add(d, gl_mul(state[i], FP_WHATS[r][i - 1]));
        u64 res0 = d;
        for (int i = 1; i < 12; i++)
            state[i] = gl_add(gl_mul(s0, FP_VS[r][i - 1]), state[i]);
        state[0] = res0;
    }
    // last 4 full rounds
    for (int r = 0; r < 4; r++) {
        for (int i = 0; i < 12; i++)
            state[i] = gl_add(state[i], ALL_ROUND_CONSTANTS[i + 12 * (26 + r)]);
        if (trace) memcpy(trace + 58 + r * 12, state, 12 * sizeof(u64));
        for (int i = 0; i < 12; i++) state[i] = sbox(state[i]);
        mds_layer(state, tmp);
        memcpy(state, tmp, sizeof(tmp));
    }
}

#include <thread>
#include <vector>

// run fn(lo, hi) over [0, n) split across hardware threads
template <typename F>
static void par_range(u64 n, F fn) {
    unsigned hw = std::thread::hardware_concurrency();
    int nt = hw ? (int)hw : 2;
    if (n < 4096 || nt <= 1) { fn((u64)0, n); return; }
    std::vector<std::thread> ts;
    u64 per = (n + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
        u64 lo = t * per, hi = lo + per > n ? n : lo + per;
        if (lo >= hi) break;
        ts.emplace_back([=]() { fn(lo, hi); });
    }
    for (auto& th : ts) th.join();
}

extern "C" void permute_batch(u64* states, u64 n) {
    par_range(n, [&](u64 lo, u64 hi) {
        for (u64 i = lo; i < hi; i++) poseidon_permute(states + 12 * i, nullptr);
    });
}

// trace layout per state: 106 u64 (full_0_1..3, partial[22], full_1_0..3)
extern "C" void permute_batch_trace(u64* states, u64* traces, u64 n) {
    par_range(n, [&](u64 lo, u64 hi) {
        for (u64 i = lo; i < hi; i++)
            poseidon_permute(states + 12 * i, traces + 106 * i);
    });
}

// Challenger-style absorb (overwrite mode, rate 8) of a stream; state is
// 12 wide, buffered count passed in/out to allow chunked streaming.
extern "C" u64 absorb_stream(u64* state, u64 buffered, const u64* data, u64 n) {
    u64 buf = buffered;
    for (u64 i = 0; i < n; i++) {
        state[buf++] = data[i] >= P ? data[i] - P : data[i];
        if (buf == 8) {
            poseidon_permute(state, nullptr);
            buf = 0;
        }
    }
    return buf;
}

// hash_n_to_m_no_pad over a stream, output 4 (plonky2 hashing.rs:87-107)
extern "C" void hash_no_pad(const u64* data, u64 n, u64* out4) {
    u64 state[12] = {0};
    u64 i = 0;
    while (i < n) {
        u64 chunk = n - i < 8 ? n - i : 8;
        for (u64 j = 0; j < chunk; j++) state[j] = data[i + j];
        poseidon_permute(state, nullptr);
        i += chunk;
    }
    memcpy(out4, state, 4 * sizeof(u64));
}

// two-to-one Merkle compression over n pairs: left (n,4), right (n,4)
extern "C" void compress_batch(const u64* left, const u64* right, u64* out,
                               u64 n) {
    par_range(n, [&](u64 lo, u64 hi) {
        for (u64 i = lo; i < hi; i++) {
            u64 state[12] = {0};
            memcpy(state, left + 4 * i, 4 * sizeof(u64));
            memcpy(state + 4, right + 4 * i, 4 * sizeof(u64));
            poseidon_permute(state, nullptr);
            memcpy(out + 4 * i, state, 4 * sizeof(u64));
        }
    });
}

// sponge-hash rows of a (n, width) matrix into (n, 4) digests; width > 4
extern "C" void hash_leaves(const u64* leaves, u64 n, u64 width, u64* out) {
    par_range(n, [&](u64 lo, u64 hi) {
        for (u64 i = lo; i < hi; i++) {
            const u64* row = leaves + i * width;
            u64 state[12] = {0};
            u64 j = 0;
            while (j < width) {
                u64 chunk = width - j < 8 ? width - j : 8;
                for (u64 k = 0; k < chunk; k++) state[k] = row[j + k];
                poseidon_permute(state, nullptr);
                j += chunk;
            }
            memcpy(out + 4 * i, state, 4 * sizeof(u64));
        }
    });
}

// find the lowest nonce whose hash_no_pad([h0..h3, nonce]) first element
// has >= pow_bits leading zeros
extern "C" u64 pow_grind(const u64* hash4, u64 pow_bits) {
    u64 threshold = 1ULL << (64 - pow_bits);
    for (u64 nonce = 0;; nonce++) {
        u64 state[12] = {0};
        memcpy(state, hash4, 4 * sizeof(u64));
        state[4] = nonce;
        poseidon_permute(state, nullptr);
        if (state[0] < threshold) return nonce;
    }
}

// arbitrary-length sponge with reuse of previous state (the VM's POSEIDON
// opcode / program hash, core/src/crypto/poseidon_trace.rs:167-185):
// returns number of permutation rows written. rows layout per chunk:
// input[12], then the 106 trace values, then output[12] => 130 u64.
extern "C" u64 arbitrary_sponge_trace(const u64* data, u64 n, u64* rows,
                                      u64* out4) {
    u64 state[12] = {0};
    u64 nrows = 0;
    u64 i = 0;
    while (i < n) {
        u64 chunk = n - i < 8 ? n - i : 8;
        for (u64 j = 0; j < chunk; j++) state[j] = data[i + j];
        u64* row = rows + nrows * 130;
        memcpy(row, state, 12 * sizeof(u64));
        poseidon_permute(state, row + 12);
        memcpy(row + 118, state, 12 * sizeof(u64));
        nrows++;
        i += chunk;
    }
    memcpy(out4, state, 4 * sizeof(u64));
    return nrows;
}
