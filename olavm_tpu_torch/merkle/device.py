"""Merkle commitment on torch tensors, blake3 or Poseidon hasher;
counterpart of olavm_tpu/merkle/device.py:42-238.

A batch of n leaves of C field elements is a (C, n) int64 tensor (column i of
the LDE matrix is leaf i); digests are (8, n) tensors of u32 words, for both
hashers (a Poseidon digest's 4 elements as lo, hi pairs). Leaves of <= 4
elements are their own zero-padded digests (hash_or_noop), for both hashers.

`leaf_digests` and `compress_level` take the hasher's name:
- "blake3": the leaf message of C u64 values is hashed as 8*C little-endian
  bytes, absorbed 8 columns (one 64-byte block) at a time into running
  per-leaf chaining values, with a fresh chunk every 128 columns and one
  parent compression for two-chunk leaves (the chunk tree of
  olavm_tpu/stark/oracle_device.py:198-240); at most 256 columns. On CUDA
  tensors the K4 kernels run (csrc/blake3.cu); on CPU tensors their plain
  versions, `leaf_digests_plain` and `compress_level_plain`, chains of int64
  torch ops over hash/blake3.py's `compress`;
- "poseidon": the rate-8 overwrite sponge of any width and two_to_one
  (hash/poseidon.py `leaves` and `level`: the Poseidon kernels of
  csrc/poseidon.cu on CUDA tensors, their plain versions on CPU tensors);
- any other name (keccak) raises NotImplementedError: the host prover
  (stark/prover.py) runs those configurations.

`LeafStream` computes the same leaf digests from blocks of at most 16
columns given in turn, so that a commit never holds its whole LDE
(stark/oracle_device.py): `blake3_absorb` (gl_blake3_absorb in
csrc/blake3.cu) and hash/poseidon.py `absorb` (gl_poseidon_absorb) carry
the per-leaf hash states from block to block, each with its plain version
for CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..hash import blake3 as b3
from ..hash import poseidon as pos

M32 = 0xFFFFFFFF
NOOP_MAX = 4
# one blake3 chunk is 1024 bytes = 128 u64 columns
CHUNK_COLS = 128
# columns per streamed block: two blake3 message blocks, two Poseidon rates
STREAM_BLOCK_COLS = 16
HASHERS = ("blake3", "poseidon")


def check_hasher(hasher_kind: str) -> None:
    """Raise for a Merkle hasher that has no device path."""
    if hasher_kind not in HASHERS:
        raise NotImplementedError(
            f"merkle hasher {hasher_kind!r} has no device path (only "
            f"{', '.join(HASHERS)}); the host prover, "
            f"olavm_tpu_torch.stark.prover.prove_with_traces, runs it")


def absorb_block_meta(total_cols: int):
    """Per-64-byte-block (flags, blen, counter) for a blake3 message of
    total_cols u64 columns, following the blake3 chunk structure (ROOT only
    on a single-chunk message; a two-chunk message gets a parent node).
    Carried from olavm_tpu/merkle/device.py:115."""
    total_bytes = 8 * total_cols
    nblocks = max(1, (total_bytes + 63) // 64)
    nchunks = max(1, (total_bytes + 1023) // 1024)
    flags = np.zeros(nblocks, dtype=np.uint32)
    blen = np.full(nblocks, 64, dtype=np.uint32)
    counter = np.zeros(nblocks, dtype=np.uint32)
    blen[-1] = total_bytes - 64 * (nblocks - 1)
    for b in range(nblocks):
        chunk = b // 16
        counter[b] = chunk
        if b % 16 == 0:
            flags[b] |= b3.CHUNK_START
        if b == nblocks - 1 or b % 16 == 15:
            flags[b] |= b3.CHUNK_END
            if nchunks == 1:
                flags[b] |= b3.ROOT
    return flags, blen, counter


def _words(cols: torch.Tensor) -> torch.Tensor:
    """(k, n) u64 columns -> (16, n) message words (lo, hi per column),
    zero-padded to one 64-byte block."""
    k, n = cols.shape
    words = torch.stack([cols & M32, (cols >> 32) & M32], dim=1).reshape(2 * k, n)
    if k < 8:
        words = torch.cat([words, words.new_zeros(16 - 2 * k, n)])
    return words


def leaf_digests(cols: torch.Tensor, hasher_kind: str = "blake3"
                 ) -> torch.Tensor:
    """Hash n leaves given as (C, n) u64 columns -> (8, n) digest words."""
    check_hasher(hasher_kind)
    C, n = cols.shape
    if C <= NOOP_MAX:
        # the leaf is its own digest: each column's lo and hi words, then
        # zeros (written into the (8, n) digest itself: a quotient commit
        # of 2^26 leaves would otherwise make an 8 GiB padded block)
        out = cols.new_zeros(8, n)
        out[0:2 * C:2] = cols & M32
        out[1:2 * C:2] = (cols >> 32) & M32
        return out
    if hasher_kind == "poseidon":
        return pos.leaves(cols)
    if C > 2 * CHUNK_COLS:
        raise ValueError(f"leaves over {2 * CHUNK_COLS} columns not supported")
    if cols.device.type != "cuda":
        return leaf_digests_plain(cols)
    kernels.require_cuda_int64(cols)
    out = torch.empty((8, n), dtype=torch.int64, device=cols.device)
    if n == 0:
        return out
    rc = kernels.lib("blake3").gl_blake3_leaves(
        cols.data_ptr(), out.data_ptr(), n, C, kernels.stream_ptr(cols))
    kernels.check(rc, "blake3_leaves")
    kernels.count("blake3_leaves")
    return out


def leaf_digests_plain(cols: torch.Tensor) -> torch.Tensor:
    """Plain version of the leaf kernel: 4 < C <= 256 columns, absorbed one
    64-byte block at a time, each 128-column chunk from the IV."""
    C = cols.shape[0]
    meta = absorb_block_meta(C)
    cv = blake3_absorb_plain(cols[:CHUNK_COLS], None, None,
                             *(m[:CHUNK_COLS // 8] for m in meta))
    if C <= CHUNK_COLS:
        return cv
    return blake3_absorb_plain(cols[CHUNK_COLS:], None, cv,
                               *(m[CHUNK_COLS // 8:] for m in meta))


def blake3_absorb(block: torch.Tensor, state, chunk0, flags, blen,
                  counter) -> torch.Tensor:
    """Absorb a (W, n) block of leaf columns, W <= 16, into the (8, n)
    chaining values `state` (None: a chunk's first block, from the IV), one
    64-byte message block per 8 columns with these flags, byte lengths and
    chunk counters; given `chunk0`, the first chunk's chaining values, end a
    two-chunk leaf with one PARENT | ROOT compression. Returns the new
    chaining values, in `state` itself on the card (gl_blake3_absorb), by
    the plain version on a CPU tensor."""
    W, n = block.shape
    if not 1 <= W <= STREAM_BLOCK_COLS:
        raise ValueError(f"an absorbed block has 1 to {STREAM_BLOCK_COLS} "
                         f"columns, got {W}")
    if block.device.type != "cuda":
        return blake3_absorb_plain(block, state, chunk0, flags, blen, counter)
    fresh = state is None
    if fresh:
        state = torch.empty((8, n), dtype=torch.int64, device=block.device)
    kernels.require_cuda_int64(block, state,
                               *(() if chunk0 is None else (chunk0,)))
    nb = (W + 7) // 8
    meta = (ctypes.c_uint32 * 6)()
    for b in range(nb):
        meta[b], meta[2 + b], meta[4 + b] = int(flags[b]), int(blen[b]), \
            int(counter[b])
    rc = kernels.lib("blake3").gl_blake3_absorb(
        block.data_ptr(), state.data_ptr(),
        None if chunk0 is None else chunk0.data_ptr(), n, W, int(fresh), meta,
        kernels.stream_ptr(block))
    kernels.check(rc, "blake3_absorb")
    kernels.count("blake3_absorb")
    return state


def blake3_absorb_plain(block: torch.Tensor, state, chunk0, flags, blen,
                        counter) -> torch.Tensor:
    """Plain version of the absorb kernel (any number of columns, one
    message block per 8 of them)."""
    n = block.shape[1]
    cv = b3.iv_lanes(n, block.device) if state is None else state
    for j, start in enumerate(range(0, block.shape[0], 8)):
        cv = b3.compress(cv, _words(block[start:start + 8]), int(blen[j]),
                         int(flags[j]), int(counter[j]))
    if chunk0 is None:
        return cv
    # two chunks: parent = compress(IV, cv0 || cv1, 64, PARENT | ROOT)
    return b3.compress(b3.iv_lanes(n, block.device), torch.cat([chunk0, cv]),
                       64, b3.PARENT | b3.ROOT)


class LeafStream:
    """The digests of n leaves of C > 4 columns, absorbed a block of
    columns at a time, so that the (C, n) leaf matrix (a commit's LDE) never
    exists whole: the counterpart of olavm_tpu/merkle/device.py:106-183
    (leaf_stream_init, absorb_block_meta, leaf_stream_absorb,
    leaf_stream_finalize) with the chunk tree of
    olavm_tpu/stark/oracle_device.py:198-240.

    Blocks come in column order, each of at most 16 columns, starting on an
    8-column boundary (one blake3 message block, one Poseidon rate); only
    the last may hold a number of columns that is not a multiple of 8.
    blake3 keeps (8, n) chaining values; at column 128 a second chunk starts
    from the IV, the first chunk's values are kept, and the last block joins
    the two. Poseidon keeps the (12, n) sponge states. The digests are equal
    to `leaf_digests` of the whole matrix."""

    def __init__(self, C: int, n: int, hasher_kind: str = "blake3"):
        check_hasher(hasher_kind)
        if C <= NOOP_MAX:
            raise ValueError(f"leaves of {C} <= {NOOP_MAX} columns are their "
                             f"own digests: use leaf_digests")
        if hasher_kind == "blake3" and C > 2 * CHUNK_COLS:
            raise ValueError(f"leaves over {2 * CHUNK_COLS} columns not "
                             f"supported")
        self.C, self.n, self.hasher_kind = C, n, hasher_kind
        self.pos = 0
        self.state = None
        self.chunk0 = None
        self.digests = None
        if hasher_kind == "blake3":
            self.meta = absorb_block_meta(C)

    def absorb(self, block: torch.Tensor) -> None:
        """Absorb the next (W, n) block of columns."""
        W = block.shape[0]
        start, end = self.pos, self.pos + W
        if block.shape[1] != self.n or end > self.C or W > STREAM_BLOCK_COLS:
            raise ValueError(f"block {tuple(block.shape)} at column {start} "
                             f"of ({self.C}, {self.n}) leaves")
        if end < self.C and W % 8:
            raise ValueError("only the last block may end off an 8-column "
                             "boundary")
        last = end == self.C
        if self.hasher_kind == "poseidon":
            out = pos.absorb(block, self.state, last)
            self.state, self.digests = (None, out) if last else (out, None)
        else:
            if start // CHUNK_COLS != (end - 1) // CHUNK_COLS:
                raise ValueError("a block may not cross a blake3 chunk")
            if start and start % CHUNK_COLS == 0:
                self.chunk0, self.state = self.state, None
            j, nb = start // 8, (W + 7) // 8
            self.state = blake3_absorb(
                block, self.state, self.chunk0 if last else None,
                *(m[j:j + nb] for m in self.meta))
            if last:
                self.digests, self.state, self.chunk0 = self.state, None, None
        self.pos = end

    def finalize(self) -> torch.Tensor:
        """The (8, n) digest words, once every column is absorbed."""
        if self.pos != self.C:
            raise ValueError(f"{self.pos} of {self.C} columns absorbed")
        return self.digests


def compress_level(digests: torch.Tensor, hasher_kind: str = "blake3"
                   ) -> torch.Tensor:
    """One tree level: pairs (2i, 2i+1) of (8, n) digests -> (8, n/2)."""
    check_hasher(hasher_kind)
    if hasher_kind == "poseidon":
        return pos.level(digests)
    if digests.device.type != "cuda":
        return compress_level_plain(digests)
    kernels.require_cuda_int64(digests)
    n = digests.shape[1]
    if digests.shape[0] != 8 or n < 2 or n % 2:
        raise ValueError(f"digest level must be (8, even n), got "
                         f"{tuple(digests.shape)}")
    if digests.data_ptr() % 16:
        raise ValueError("digest level must be 16-byte aligned")
    out = torch.empty((8, n // 2), dtype=torch.int64, device=digests.device)
    rc = kernels.lib("blake3").gl_blake3_level(
        digests.data_ptr(), out.data_ptr(), n, kernels.stream_ptr(digests))
    kernels.check(rc, "blake3_level")
    kernels.count("blake3_level")
    return out


def compress_level_plain(digests: torch.Tensor) -> torch.Tensor:
    """Plain version of the level kernel."""
    return b3.two_to_one_words(digests[:, 0::2], digests[:, 1::2])


def digests_to_u64(digests: torch.Tensor) -> np.ndarray:
    """(8, n) u32 word lanes -> host (n, 4) u64 digest rows."""
    w = digests.detach().cpu().numpy().astype(np.uint64)
    return np.ascontiguousarray((w[0::2] | (w[1::2] << np.uint64(32))).T)


def paths_to_host(paths: torch.Tensor) -> list[list[list[int]]]:
    """(k, L, 8) word tensor -> [k][level][4 u64] path lists."""
    w = paths.detach().cpu().numpy().astype(np.uint64)
    u64 = w[..., 0::2] | (w[..., 1::2] << np.uint64(32))
    return [[[int(v) for v in lvl] for lvl in q] for q in u64]
