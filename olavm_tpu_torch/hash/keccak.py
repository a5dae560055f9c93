"""Carried from olavm_tpu/hash/keccak.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

Keccak-256 (legacy pre-NIST padding 0x01) with a batched numpy core.

Parity component for the reference's KeccakGoldilocksConfig
(plonky2/plonky2/src/plonk/config.rs:141-152,
hash/keccak.rs). The reference truncates digests to 25 bytes
(`KeccakHash<25>`); this build keeps the full 32-byte digest so Merkle caps
retain the uniform (4,)-u64 digest layout shared by every hasher config —
a deliberate deviation, documented here (keccak is not used by any olavm
prove path; it exists for config parity only).

The permutation is keccak-f[1600] over a (n, 25)-u64 numpy state, fully
vectorized over the batch axis, so batched Merkle levels hash at numpy
speed. Constants are the published Keccak spec values.
"""

from __future__ import annotations

import numpy as np

_ROUND_CONSTANTS = np.array([
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
], dtype=np.uint64)

# rotation offsets r[x][y], flattened index = x + 5*y
_ROTATIONS = np.array([
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
], dtype=np.uint64)

_RATE_BYTES = 136  # keccak-256: 1088-bit rate


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    r = int(r) % 64
    if r == 0:
        return x
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def keccak_f1600(state: np.ndarray) -> np.ndarray:
    """(n, 25) u64 lanes (index = x + 5*y) -> permuted state, batched."""
    A = [state[:, i].copy() for i in range(25)]
    for rc in _ROUND_CONSTANTS:
        # theta
        C = [A[x] ^ A[x + 5] ^ A[x + 10] ^ A[x + 15] ^ A[x + 20]
             for x in range(5)]
        D = [C[(x + 4) % 5] ^ _rotl(C[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                A[x + 5 * y] ^= D[x]
        # rho + pi
        B = [None] * 25
        for x in range(5):
            for y in range(5):
                B[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(
                    A[x + 5 * y], _ROTATIONS[x + 5 * y]
                )
        # chi
        for x in range(5):
            for y in range(5):
                A[x + 5 * y] = B[x + 5 * y] ^ (
                    (~B[(x + 1) % 5 + 5 * y]) & B[(x + 2) % 5 + 5 * y]
                )
        # iota
        A[0] = A[0] ^ rc
    return np.stack(A, axis=1)


def keccak256_batch(data: np.ndarray) -> np.ndarray:
    """Hash n equal-length byte rows: (n, L) u8 -> (n, 32) u8 digests."""
    data = np.asarray(data, dtype=np.uint8)
    n, L = data.shape
    # pad10*1 with keccak domain byte 0x01
    pad_len = _RATE_BYTES - (L % _RATE_BYTES)
    padded = np.zeros((n, L + pad_len), dtype=np.uint8)
    padded[:, :L] = data
    padded[:, L] = 0x01
    padded[:, -1] ^= 0x80
    state = np.zeros((n, 25), dtype=np.uint64)
    nblocks = padded.shape[1] // _RATE_BYTES
    for b in range(nblocks):
        block = padded[:, b * _RATE_BYTES : (b + 1) * _RATE_BYTES]
        lanes = np.ascontiguousarray(block).view("<u8").reshape(n, -1)
        state[:, : lanes.shape[1]] ^= lanes
        state = keccak_f1600(state)
    return np.ascontiguousarray(
        state[:, :4].astype("<u8").view(np.uint8)
    ).reshape(n, 32)


def keccak256(data: bytes) -> bytes:
    arr = np.frombuffer(bytes(data), dtype=np.uint8).reshape(1, -1) \
        if data else np.zeros((1, 0), dtype=np.uint8)
    return keccak256_batch(arr).tobytes()
