"""BLAKE3 for the blake3 Merkle configuration; counterpart of
olavm_tpu/hash/blake3.py.

Two halves:

- the torch half: the plain compression over u32 word lanes held in int64
  tensors (`compress`, `two_to_one_words`; counterpart of `compress` :58 and
  `two_to_one_words` :152). torch has no uint32 arithmetic, so each u32 word
  is an int64 value below 2^32, masked after every add and left shift. A
  message batch is word-major, (16, n) for n parallel 64-byte blocks, and a
  chaining value is (8, n). The four column G functions of a round run as
  one (4, n) step, and the four diagonal ones as another after rotating rows
  (the message schedule and output are the reference's exactly). It is the
  plain version of the K4 kernels (csrc/blake3.cu), which merkle/device.py
  launches on CUDA tensors;
- the numpy half, carried from olavm_tpu/hash/blake3.py (its code unchanged
  but for the `xp` argument, which is always numpy here): `blake3_hash_np`,
  `hash_leaves_np`, `compress_batch_np`, the host fallback of
  native/blake3_native.py.
"""

from __future__ import annotations

import numpy as np
import torch

IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)

# message word permutation applied between rounds
PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

M32 = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# torch: plain compression over (k, n) int64 word lanes
# ---------------------------------------------------------------------------

# message words of the 4 column and 4 diagonal G calls, per round
_COL_X, _COL_Y = [0, 2, 4, 6], [1, 3, 5, 7]
_DIAG_X, _DIAG_Y = [8, 10, 12, 14], [9, 11, 13, 15]


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x >> n) | ((x << (32 - n)) & M32)


def _g(a, b, c, d, x, y):
    a = (a + b + x) & M32
    d = _rotr(d ^ a, 16)
    c = (c + d) & M32
    b = _rotr(b ^ c, 12)
    a = (a + b + y) & M32
    d = _rotr(d ^ a, 8)
    c = (c + d) & M32
    b = _rotr(b ^ c, 7)
    return a, b, c, d


def iv_lanes(n: int, device) -> torch.Tensor:
    """(8, n) chaining value of the IV."""
    iv = torch.tensor(IV, dtype=torch.int64, device=device)
    return iv[:, None].expand(8, n).contiguous()


def compress(cv: torch.Tensor, m: torch.Tensor, block_len: int, flags: int,
             counter: int = 0) -> torch.Tensor:
    """One compression of n blocks: cv (8, n), m (16, n) -> (8, n).
    block_len, flags and counter are host ints shared by the whole batch."""
    n = cv.shape[1]
    dev = cv.device
    tail = torch.tensor([IV[0], IV[1], IV[2], IV[3], counter & M32,
                         (counter >> 32) & M32, block_len, flags],
                        dtype=torch.int64, device=dev)
    s = torch.cat([cv, tail[:, None].expand(8, n)])
    a, b, c, d = s[0:4], s[4:8], s[8:12], s[12:16]
    perm = list(range(16))
    for r in range(7):
        a, b, c, d = _g(a, b, c, d, m[[perm[i] for i in _COL_X]],
                        m[[perm[i] for i in _COL_Y]])
        # diagonals: G(0,5,10,15), G(1,6,11,12), G(2,7,8,13), G(3,4,9,14)
        b, c, d = b.roll(-1, 0), c.roll(-2, 0), d.roll(-3, 0)
        a, b, c, d = _g(a, b, c, d, m[[perm[i] for i in _DIAG_X]],
                        m[[perm[i] for i in _DIAG_Y]])
        b, c, d = b.roll(1, 0), c.roll(2, 0), d.roll(3, 0)
        if r < 6:
            perm = [perm[PERM[i]] for i in range(16)]
    return torch.cat([a ^ c, b ^ d])


def two_to_one_words(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Digest pairs -> parent digests: BLAKE3 of the 64 concatenated bytes as
    one single-block chunk (the reference two_to_one, not the BLAKE3 parent
    mode). left, right: (8, n) word lanes."""
    n = left.shape[1]
    m = torch.cat([left, right])
    return compress(iv_lanes(n, left.device), m, 64,
                    CHUNK_START | CHUNK_END | ROOT)


# ---------------------------------------------------------------------------
# numpy: vectorized BLAKE3 over u32 word lanes (carried)
# ---------------------------------------------------------------------------


def _rotr_np(x, n):
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def _g_np(s, a, b, c, d, x, y):
    s[a] = s[a] + s[b] + x
    s[d] = _rotr_np(s[d] ^ s[a], 16)
    s[c] = s[c] + s[d]
    s[b] = _rotr_np(s[b] ^ s[c], 12)
    s[a] = s[a] + s[b] + y
    s[d] = _rotr_np(s[d] ^ s[a], 8)
    s[c] = s[c] + s[d]
    s[b] = _rotr_np(s[b] ^ s[c], 7)


def _iv_np(shape):
    return [np.full(shape, IV[i], np.uint32) for i in range(8)]


def _compress_np(cv, m, block_len: int, flags: int, shape, counter: int = 0):
    """One compression: cv = 8 lanes, m = 16 lanes, returns 8 lanes.

    Lanes are uint32 arrays of `shape`. counter is the chunk counter (0 for
    single-chunk messages / parent nodes)."""
    u = np.uint32
    s = list(cv) + _iv_np(shape)[:4] + [
        np.full(shape, counter & 0xFFFFFFFF, u), np.full(shape, counter >> 32, u),
        np.full(shape, block_len, u), np.full(shape, flags, u),
    ]
    m = list(m)
    for r in range(7):
        _g_np(s, 0, 4, 8, 12, m[0], m[1])
        _g_np(s, 1, 5, 9, 13, m[2], m[3])
        _g_np(s, 2, 6, 10, 14, m[4], m[5])
        _g_np(s, 3, 7, 11, 15, m[6], m[7])
        _g_np(s, 0, 5, 10, 15, m[8], m[9])
        _g_np(s, 1, 6, 11, 12, m[10], m[11])
        _g_np(s, 2, 7, 8, 13, m[12], m[13])
        _g_np(s, 3, 4, 9, 14, m[14], m[15])
        if r < 6:
            m = [m[PERM[i]] for i in range(16)]
    return [s[i] ^ s[i + 8] for i in range(8)]


def _chunk_cv_np(words, byte_len: int, chunk_counter: int, is_root: bool,
                 shape):
    """One <=1024-byte chunk -> chaining value (8 lanes)."""
    zero = np.zeros(shape, np.uint32)
    nblocks = max(1, (byte_len + 63) // 64)
    cv = _iv_np(shape)
    for b in range(nblocks):
        m = [words[16 * b + w] if 16 * b + w < len(words) else zero
             for w in range(16)]
        blen = min(64, byte_len - 64 * b)
        flags = (CHUNK_START if b == 0 else 0) | (
            (CHUNK_END | (ROOT if is_root else 0)) if b == nblocks - 1 else 0
        )
        cv = _compress_np(cv, m, blen, flags, shape, counter=chunk_counter)
    return cv


def _subtree_cv_np(words, byte_len: int, chunk0: int, shape):
    """Subtree chaining value (never root), mirroring gl_blake3.cpp
    b3_subtree_cv."""
    nchunks = (byte_len + 1023) // 1024
    if nchunks <= 1:
        return _chunk_cv_np(words, byte_len, chunk0, False, shape)
    left = 1
    while left * 2 < nchunks:
        left *= 2
    lcv = _subtree_cv_np(words[: left * 256], left * 1024, chunk0, shape)
    rcv = _subtree_cv_np(words[left * 256:], byte_len - left * 1024,
                         chunk0 + left, shape)
    return _compress_np(_iv_np(shape), lcv + rcv, 64, PARENT, shape)


def hash_words_np(words, byte_len: int | None = None):
    """BLAKE3 of n parallel messages (vectorized over the lane shape).

    words: sequence of W uint32 lanes (each an array of identical shape; the
    whole batch is one message of W*4 bytes). Returns 8 digest lanes.
    byte_len defaults to W*4. Multi-chunk messages (>1024 bytes, e.g. the
    poseidon table's wide rows) use the chunk-tree exactly as the native
    kernel (gl_blake3.cpp:124-141).
    """
    W = len(words)
    if byte_len is None:
        byte_len = W * 4
    shape = words[0].shape if hasattr(words[0], "shape") else ()
    nchunks = max(1, (byte_len + 1023) // 1024)
    if nchunks == 1:
        return _chunk_cv_np(words, byte_len, 0, True, shape)
    left = 1
    while left * 2 < nchunks:
        left *= 2
    lcv = _subtree_cv_np(words[: left * 256], left * 1024, 0, shape)
    rcv = _subtree_cv_np(words[left * 256:], byte_len - left * 1024, left,
                         shape)
    return _compress_np(_iv_np(shape), lcv + rcv, 64, PARENT | ROOT, shape)


def hash_leaves_np(leaves: np.ndarray) -> np.ndarray:
    """(n, width) u64 rows -> (n, 4) u64-word digests (numpy fallback)."""
    leaves = np.ascontiguousarray(leaves, dtype=np.uint64)
    n, width = leaves.shape
    w32 = leaves.view(np.uint32).reshape(n, 2 * width)
    words = [np.ascontiguousarray(w32[:, i]) for i in range(2 * width)]
    digs = hash_words_np(words)
    out32 = np.stack(digs, axis=1)  # (n, 8) u32
    return np.ascontiguousarray(out32).view(np.uint64).reshape(n, 4)


def compress_batch_np(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """(n, 4) u64 digest pairs -> (n, 4) parents (numpy fallback)."""
    both = np.concatenate(
        [np.ascontiguousarray(left, np.uint64), np.ascontiguousarray(right, np.uint64)],
        axis=1,
    )
    return hash_leaves_np(both)


def blake3_hash_np(data: bytes) -> bytes:
    """One message of <= 1024 bytes -> 32-byte digest (numpy fallback)."""
    buf = np.frombuffer(data.ljust((max(len(data), 1) + 3) // 4 * 4, b"\0"),
                        dtype="<u4")
    # (1,)-shaped lanes: numpy scalar uint32 adds warn on wrap, arrays don't
    words = [np.full((1,), w, np.uint32) for w in buf]
    digs = hash_words_np(words, byte_len=len(data))
    return np.stack([np.asarray(d, np.uint32) for d in digs]).astype("<u4").tobytes()
