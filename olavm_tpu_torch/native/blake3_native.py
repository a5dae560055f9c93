"""Carried from olavm_tpu/native/blake3_native.py. It compiles the port's own
copy of the C++ source (native/gl_blake3.cpp) through hostlib.build; its code
is otherwise unchanged.

ctypes loader for the native BLAKE3 kernels (gl_blake3.cpp)."""

from __future__ import annotations

import ctypes

import numpy as np

from . import hostlib

available = False
_lib = None


def _u64p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _load():
    global _lib, available
    lib = ctypes.CDLL(hostlib.build("gl_blake3", pthread=True))
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.blake3_hash.argtypes = [u8p, ctypes.c_uint64, u8p]
    lib.blake3_hash_leaves.argtypes = [u64p, ctypes.c_uint64, ctypes.c_uint64, u64p]
    lib.blake3_compress_batch.argtypes = [u64p, u64p, u64p, ctypes.c_uint64]
    _lib = lib
    available = True


try:
    _load()
except Exception as _e:  # pragma: no cover
    import warnings

    warnings.warn(
        f"native gl_blake3 unavailable ({_e}); falling back to the "
        "vectorized-numpy BLAKE3 (hash/blake3.py) — slower but "
        "bit-identical"
    )


def blake3_hash(data: bytes) -> bytes:
    if _lib is None:
        from ..hash.blake3 import blake3_hash_np

        return blake3_hash_np(data)
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data) if data else (
        ctypes.c_uint8 * 1)()
    out = (ctypes.c_uint8 * 32)()
    _lib.blake3_hash(buf, len(data), out)
    return bytes(out)


def hash_leaves(leaves: np.ndarray) -> np.ndarray:
    """(n, width) u64 rows -> (n, 4) u64-word digests."""
    if _lib is None:
        from ..hash.blake3 import hash_leaves_np

        return hash_leaves_np(leaves)
    leaves = np.ascontiguousarray(leaves, dtype=np.uint64)
    n, width = leaves.shape
    out = np.zeros((n, 4), dtype=np.uint64)
    _lib.blake3_hash_leaves(_u64p(leaves), n, width, _u64p(out))
    return out


def compress_batch(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    if _lib is None:
        from ..hash.blake3 import compress_batch_np

        return compress_batch_np(left, right)
    left = np.ascontiguousarray(left, dtype=np.uint64)
    right = np.ascontiguousarray(right, dtype=np.uint64)
    n = left.shape[0]
    out = np.zeros((n, 4), dtype=np.uint64)
    _lib.blake3_compress_batch(_u64p(left), _u64p(right), _u64p(out), n)
    return out
