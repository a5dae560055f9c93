"""BLAKE3 compression over u32 word lanes held in int64 tensors; counterpart
of olavm_tpu/hash/blake3.py (`compress` :58, `two_to_one_words` :152).

torch has no uint32 arithmetic, so each u32 word is an int64 tensor with
values < 2^32, masked after every add and left shift. A message batch is
word-major, (16, n) for n parallel 64-byte blocks, and a chaining value is
(8, n). The four column G functions of a round run as one (4, n) step, and
the four diagonal ones as another after rotating rows (the message schedule
and output are the reference's exactly).

Plain torch in this version: a hand-written kernel for the leaf absorb and
tree levels is later work.
"""

from __future__ import annotations

import torch

from olavm_tpu.hash.blake3 import CHUNK_END, CHUNK_START, IV, PARENT, PERM, ROOT

__all__ = ["CHUNK_END", "CHUNK_START", "PARENT", "ROOT", "compress",
           "iv_lanes", "two_to_one_words"]

M32 = 0xFFFFFFFF

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
