"""Carried from olavm_tpu/utils/bits.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

Bit-twiddling helpers (reverse_index_bits etc.), mirroring the behavior of
the reference utilities (plonky2/util/src/lib.rs)."""

from __future__ import annotations

import numpy as np


def log2_strict(n: int) -> int:
    L = n.bit_length() - 1
    if 1 << L != n:
        raise ValueError(f"{n} is not a power of two")
    return L


def reverse_bits(x: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (x & 1)
        x >>= 1
    return out


def bit_reversal_perm(n: int) -> np.ndarray:
    """Permutation array r with r[i] = reverse_bits(i, log2(n))."""
    bits = log2_strict(n)
    idx = np.arange(n, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    x = idx.copy()
    for _ in range(bits):
        out = (out << 1) | (x & 1)
        x >>= 1
    return out


def reverse_index_bits(arr, axis: int = -1):
    """Reorder an array along `axis` by bit-reversing indices."""
    perm = bit_reversal_perm(arr.shape[axis])
    return np.take(arr, perm, axis=axis)
