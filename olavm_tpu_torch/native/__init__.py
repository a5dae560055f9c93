"""Carried from olavm_tpu/native/__init__.py: the original reads the Poseidon
constants through olavm_tpu.hash.poseidon, which imports jax. This copy reads
them through the port's hash/poseidon and compiles the port's own copy of the
C++ source (native/gl_poseidon.cpp) through hostlib.build. Its code is
otherwise unchanged.

ctypes bindings for the native Goldilocks/Poseidon kernels.

Builds libgl_poseidon.so on first import (g++ -O3) and
injects the Poseidon constants. Falls back gracefully: callers should check
`available` and use the numpy paths otherwise.
"""

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
    lib = ctypes.CDLL(hostlib.build("gl_poseidon"))
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.init_poseidon.argtypes = [u64p] * 8
    lib.permute_batch.argtypes = [u64p, ctypes.c_uint64]
    lib.permute_batch_trace.argtypes = [u64p, u64p, ctypes.c_uint64]
    lib.absorb_stream.argtypes = [u64p, ctypes.c_uint64, u64p, ctypes.c_uint64]
    lib.absorb_stream.restype = ctypes.c_uint64
    lib.hash_no_pad.argtypes = [u64p, ctypes.c_uint64, u64p]
    lib.compress_batch.argtypes = [u64p, u64p, u64p, ctypes.c_uint64]
    lib.hash_leaves.argtypes = [u64p, ctypes.c_uint64, ctypes.c_uint64, u64p]
    lib.pow_grind.argtypes = [u64p, ctypes.c_uint64]
    lib.pow_grind.restype = ctypes.c_uint64
    lib.arbitrary_sponge_trace.argtypes = [u64p, ctypes.c_uint64, u64p, u64p]
    lib.arbitrary_sponge_trace.restype = ctypes.c_uint64

    from ..hash import poseidon as pos

    def flat(x):
        return np.ascontiguousarray(np.asarray(x, dtype=np.uint64).reshape(-1))

    lib.init_poseidon(
        _u64p(flat(pos.ALL_ROUND_CONSTANTS)),
        _u64p(flat(pos.MDS_CIRC)),
        _u64p(flat(pos.MDS_DIAG)),
        _u64p(flat(pos.FAST_PARTIAL_FIRST_ROUND_CONSTANT)),
        _u64p(flat(pos.FAST_PARTIAL_ROUND_CONSTANTS)),
        _u64p(flat(pos.FAST_PARTIAL_ROUND_VS)),
        _u64p(flat(pos.FAST_PARTIAL_ROUND_W_HATS)),
        _u64p(flat(pos.FAST_PARTIAL_ROUND_INITIAL_MATRIX)),
    )
    _lib = lib
    available = True


try:
    _load()
except Exception as _e:  # pragma: no cover - build environments without g++
    import warnings

    warnings.warn(f"native gl_poseidon unavailable, using numpy paths: {_e}")


def permute_batch(states: np.ndarray) -> np.ndarray:
    """(n, 12) uint64 in, permuted out (copy)."""
    out = np.ascontiguousarray(states, dtype=np.uint64).copy()
    flatv = out.reshape(-1, 12)
    _lib.permute_batch(_u64p(flatv), flatv.shape[0])
    return out.reshape(states.shape)


def permute_batch_trace(states: np.ndarray):
    """(n, 12) -> (out_states (n,12), traces (n,106))."""
    out = np.ascontiguousarray(states, dtype=np.uint64).copy().reshape(-1, 12)
    traces = np.zeros((out.shape[0], 106), dtype=np.uint64)
    _lib.permute_batch_trace(_u64p(out), _u64p(traces), out.shape[0])
    return out, traces


def absorb_stream(state: np.ndarray, buffered: int, data: np.ndarray) -> int:
    data = np.ascontiguousarray(data, dtype=np.uint64).reshape(-1)
    return int(_lib.absorb_stream(_u64p(state), buffered, _u64p(data), data.size))


def hash_no_pad(data) -> np.ndarray:
    data = np.ascontiguousarray(data, dtype=np.uint64).reshape(-1)
    out = np.zeros(4, dtype=np.uint64)
    _lib.hash_no_pad(_u64p(data), data.size, _u64p(out))
    return out


def compress_batch(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    left = np.ascontiguousarray(left, dtype=np.uint64)
    right = np.ascontiguousarray(right, dtype=np.uint64)
    n = left.shape[0]
    out = np.zeros((n, 4), dtype=np.uint64)
    _lib.compress_batch(_u64p(left), _u64p(right), _u64p(out), n)
    return out


def hash_leaves(leaves: np.ndarray) -> np.ndarray:
    leaves = np.ascontiguousarray(leaves, dtype=np.uint64)
    n, width = leaves.shape
    out = np.zeros((n, 4), dtype=np.uint64)
    _lib.hash_leaves(_u64p(leaves), n, width, _u64p(out))
    return out


def pow_grind(hash4, pow_bits: int) -> int:
    h = np.ascontiguousarray(hash4, dtype=np.uint64)
    return int(_lib.pow_grind(_u64p(h), pow_bits))


def arbitrary_sponge_trace(data):
    data = np.ascontiguousarray(data, dtype=np.uint64).reshape(-1)
    nrows = (data.size + 7) // 8 if data.size else 0
    rows = np.zeros((max(nrows, 1), 130), dtype=np.uint64)
    out4 = np.zeros(4, dtype=np.uint64)
    n = _lib.arbitrary_sponge_trace(_u64p(data), data.size, _u64p(rows), _u64p(out4))
    return out4, rows[: int(n)]
