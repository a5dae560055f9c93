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
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..hash import blake3 as b3
from ..hash import poseidon as pos

M32 = 0xFFFFFFFF
NOOP_MAX = 4
# one blake3 chunk is 1024 bytes = 128 u64 columns
CHUNK_COLS = 128
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
        return _words(torch.cat([cols, cols.new_zeros(4 - C, n)]))[:8]
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
    kernels.LAUNCHES["blake3_leaves"] += 1
    return out


def leaf_digests_plain(cols: torch.Tensor) -> torch.Tensor:
    """Plain version of the leaf kernel: 4 < C <= 256 columns, absorbed one
    64-byte block at a time."""
    C, n = cols.shape
    flags, blen, counter = absorb_block_meta(C)
    chunk_cvs = []
    cv = b3.iv_lanes(n, cols.device)
    for j, start in enumerate(range(0, C, 8)):
        if start and start % CHUNK_COLS == 0:
            chunk_cvs.append(cv)
            cv = b3.iv_lanes(n, cols.device)
        cv = b3.compress(cv, _words(cols[start:start + 8]), int(blen[j]),
                         int(flags[j]), int(counter[j]))
    if not chunk_cvs:
        return cv
    # two chunks: parent = compress(IV, cv0 || cv1, 64, PARENT | ROOT)
    return b3.compress(b3.iv_lanes(n, cols.device),
                       torch.cat([chunk_cvs[0], cv]), 64, b3.PARENT | b3.ROOT)


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
    kernels.LAUNCHES["blake3_level"] += 1
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
