// Portable BLAKE3 for Merkle commitments — the reference's bench-config
// hasher (plonky2/plonky2/src/hash/blake3.rs,
// plonk/config.rs Blake3GoldilocksConfig). Leaf hash = blake3 over the
// little-endian bytes of the row's u64 field elements; two-to-one =
// blake3 over the 64 concatenated digest bytes.
//
// Only 32-byte outputs are needed (BytesHash<32>), no XOF, no keying.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

typedef uint64_t u64;
typedef uint32_t u32;
typedef uint8_t u8;

static const u32 B3_IV[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};

// message word permutation applied between rounds
static const u8 B3_PERM[16] = {2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8};

static const u32 CHUNK_START = 1 << 0;
static const u32 CHUNK_END = 1 << 1;
static const u32 PARENT = 1 << 2;
static const u32 ROOT = 1 << 3;

static inline u32 rotr(u32 x, int n) { return (x >> n) | (x << (32 - n)); }

static inline void g(u32* s, int a, int b, int c, int d, u32 x, u32 y) {
    s[a] = s[a] + s[b] + x;
    s[d] = rotr(s[d] ^ s[a], 16);
    s[c] = s[c] + s[d];
    s[b] = rotr(s[b] ^ s[c], 12);
    s[a] = s[a] + s[b] + y;
    s[d] = rotr(s[d] ^ s[a], 8);
    s[c] = s[c] + s[d];
    s[b] = rotr(s[b] ^ s[c], 7);
}

static void b3_compress(const u32 cv[8], const u32 block[16], u64 counter,
                        u32 block_len, u32 flags, u32 out_cv[8]) {
    u32 s[16];
    memcpy(s, cv, 32);
    s[8] = B3_IV[0]; s[9] = B3_IV[1]; s[10] = B3_IV[2]; s[11] = B3_IV[3];
    s[12] = (u32)counter;
    s[13] = (u32)(counter >> 32);
    s[14] = block_len;
    s[15] = flags;
    u32 m[16], mp[16];
    memcpy(m, block, 64);
    for (int r = 0; r < 7; r++) {
        g(s, 0, 4, 8, 12, m[0], m[1]);
        g(s, 1, 5, 9, 13, m[2], m[3]);
        g(s, 2, 6, 10, 14, m[4], m[5]);
        g(s, 3, 7, 11, 15, m[6], m[7]);
        g(s, 0, 5, 10, 15, m[8], m[9]);
        g(s, 1, 6, 11, 12, m[10], m[11]);
        g(s, 2, 7, 8, 13, m[12], m[13]);
        g(s, 3, 4, 9, 14, m[14], m[15]);
        if (r < 6) {
            for (int i = 0; i < 16; i++) mp[i] = m[B3_PERM[i]];
            memcpy(m, mp, 64);
        }
    }
    for (int i = 0; i < 8; i++) out_cv[i] = s[i] ^ s[i + 8];
}

static void load_block(const u8* data, u64 len, u32 block[16]) {
    u8 buf[64] = {0};
    memcpy(buf, data, len);
    for (int i = 0; i < 16; i++) {
        block[i] = (u32)buf[4 * i] | ((u32)buf[4 * i + 1] << 8) |
                   ((u32)buf[4 * i + 2] << 16) | ((u32)buf[4 * i + 3] << 24);
    }
}

// chunk of <= 1024 bytes -> chaining value; is_root only if whole msg = chunk
static void b3_chunk_cv(const u8* data, u64 len, u64 chunk_counter, int is_root,
                        u32 cv_out[8]) {
    u32 cv[8];
    memcpy(cv, B3_IV, 32);
    u64 nblocks = len ? (len + 63) / 64 : 1;
    for (u64 b = 0; b < nblocks; b++) {
        u64 off = b * 64;
        u32 blen = (u32)(len - off < 64 ? len - off : 64);
        u32 block[16];
        load_block(data + off, blen, block);
        u32 flags = 0;
        if (b == 0) flags |= CHUNK_START;
        if (b == nblocks - 1) {
            flags |= CHUNK_END;
            if (is_root) flags |= ROOT;
        }
        u32 next[8];
        b3_compress(cv, block, chunk_counter, blen, flags, next);
        memcpy(cv, next, 32);
    }
    memcpy(cv_out, cv, 32);
}

// subtree over chunks [chunk0, chunk0+nchunks), data covers those chunks
static void b3_subtree_cv(const u8* data, u64 len, u64 chunk0, u32 cv_out[8]) {
    u64 nchunks = (len + 1023) / 1024;
    if (nchunks <= 1) {
        b3_chunk_cv(data, len, chunk0, 0, cv_out);
        return;
    }
    // left = largest power of two strictly less than nchunks
    u64 left = 1;
    while (left * 2 < nchunks) left *= 2;
    u32 lcv[8], rcv[8];
    b3_subtree_cv(data, left * 1024, chunk0, lcv);
    b3_subtree_cv(data + left * 1024, len - left * 1024, chunk0 + left, rcv);
    u32 block[16];
    memcpy(block, lcv, 32);
    memcpy(block + 8, rcv, 32);
    b3_compress(B3_IV, block, 0, 64, PARENT, cv_out);
}

static void b3_hash(const u8* data, u64 len, u8 out[32]) {
    u64 nchunks = len ? (len + 1023) / 1024 : 1;
    u32 cv[8];
    if (nchunks <= 1) {
        b3_chunk_cv(data, len, 0, 1, cv);
    } else {
        u64 left = 1;
        while (left * 2 < nchunks) left *= 2;
        u32 lcv[8], rcv[8];
        b3_subtree_cv(data, left * 1024, 0, lcv);
        b3_subtree_cv(data + left * 1024, len - left * 1024, left, rcv);
        u32 block[16];
        memcpy(block, lcv, 32);
        memcpy(block + 8, rcv, 32);
        b3_compress(B3_IV, block, 0, 64, PARENT | ROOT, cv);
    }
    memcpy(out, cv, 32);
}

extern "C" void blake3_hash(const u8* data, u64 len, u8* out32) {
    b3_hash(data, len, out32);
}

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

// rows of (n, width) u64 matrix -> (n, 4) u64-word digests (LE bytes)
extern "C" void blake3_hash_leaves(const u64* leaves, u64 n, u64 width, u64* out) {
    par_range(n, [&](u64 lo, u64 hi) {
        for (u64 i = lo; i < hi; i++) {
            b3_hash((const u8*)(leaves + i * width), width * 8,
                    (u8*)(out + 4 * i));
        }
    });
}

// two_to_one over n digest pairs: blake3 of the 64 concatenated bytes
extern "C" void blake3_compress_batch(const u64* left, const u64* right,
                                      u64* out, u64 n) {
    par_range(n, [&](u64 lo, u64 hi) {
        for (u64 i = lo; i < hi; i++) {
            u8 buf[64];
            memcpy(buf, left + 4 * i, 32);
            memcpy(buf + 32, right + 4 * i, 32);
            b3_hash(buf, 64, (u8*)(out + 4 * i));
        }
    });
}
