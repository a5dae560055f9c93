"""Carried from olavm_tpu/native/ntt_native.py: the port imports nothing of olavm_tpu, so it
keeps its own copy, built from native/gl_ntt.cpp through hostlib.build; the
code is otherwise unchanged.

ctypes loader for the native batched Goldilocks NTT (gl_ntt.cpp).

Used by olavm_tpu.ntt.host for large transforms when running on a host CPU;
the TPU device NTT (olavm_tpu/ntt/ntt.py) is the accelerator path.
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
    lib = ctypes.CDLL(hostlib.build("gl_ntt", pthread=True))
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.ntt_batch.argtypes = [u64p, ctypes.c_uint64, ctypes.c_uint64, u64p]
    lib.scale_rows.argtypes = [u64p, ctypes.c_uint64, ctypes.c_uint64, u64p]
    lib.mul_scalar.argtypes = [u64p, ctypes.c_uint64, ctypes.c_uint64]
    for name in ("mul_arrays", "add_arrays", "sub_arrays"):
        getattr(lib, name).argtypes = [u64p, u64p, ctypes.c_uint64]
    lib.gl_inv.argtypes = [ctypes.c_uint64]
    lib.gl_inv.restype = ctypes.c_uint64
    lib.gl_powers.argtypes = [ctypes.c_uint64, ctypes.c_uint64, u64p]
    lib.batch_inv.argtypes = [u64p, ctypes.c_uint64]
    lib.fma_arrays.argtypes = [u64p, u64p, u64p, ctypes.c_uint64]
    lib.fma_scalar.argtypes = [u64p, ctypes.c_uint64, u64p, ctypes.c_uint64]
    lib.dot_rows.argtypes = [u64p, ctypes.c_uint64, ctypes.c_uint64, u64p, u64p]
    _lib = lib
    available = True


try:
    _load()
except Exception as _e:  # pragma: no cover
    import warnings

    warnings.warn(f"native gl_ntt unavailable, using numpy path: {_e}")


def ntt_batch(data: np.ndarray, flat_twiddles: np.ndarray) -> np.ndarray:
    """(batch..., n) uint64 -> transformed copy. flat_twiddles: concatenated
    per-stage twiddles (n-1 elements, stage order half=1,2,4,...)."""
    shape = data.shape
    n = shape[-1]
    out = np.ascontiguousarray(data, dtype=np.uint64).reshape(-1, n).copy()
    tw = np.ascontiguousarray(flat_twiddles, dtype=np.uint64)
    _lib.ntt_batch(_u64p(out), out.shape[0], n, _u64p(tw))
    return out.reshape(shape)


def scale_rows(data: np.ndarray, powers: np.ndarray) -> np.ndarray:
    shape = data.shape
    n = shape[-1]
    out = np.ascontiguousarray(data, dtype=np.uint64).reshape(-1, n).copy()
    pw = np.ascontiguousarray(powers, dtype=np.uint64)
    _lib.scale_rows(_u64p(out), out.shape[0], n, _u64p(pw))
    return out.reshape(shape)


def _cc(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint64)


def mul_arrays(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = _cc(a).copy()
    _lib.mul_arrays(_u64p(out), _u64p(_cc(b)), out.size)
    return out


def mul_scalar(a: np.ndarray, c: int) -> np.ndarray:
    out = _cc(a).copy()
    _lib.mul_scalar(_u64p(out), out.size, int(c))
    return out


def add_arrays(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = _cc(a).copy()
    _lib.add_arrays(_u64p(out), _u64p(_cc(b)), out.size)
    return out


def sub_arrays(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = _cc(a).copy()
    _lib.sub_arrays(_u64p(out), _u64p(_cc(b)), out.size)
    return out


def gl_powers(base: int, n: int) -> np.ndarray:
    out = np.empty(n, dtype=np.uint64)
    _lib.gl_powers(int(base), n, _u64p(out))
    return out


def batch_inv(a: np.ndarray) -> np.ndarray:
    out = _cc(a).copy()
    _lib.batch_inv(_u64p(out), out.size)
    return out


def fma_arrays(acc: np.ndarray, m: np.ndarray, c: np.ndarray) -> np.ndarray:
    """acc*m + c elementwise (same shapes)."""
    out = _cc(acc).copy()
    _lib.fma_arrays(_u64p(out), _u64p(_cc(m)), _u64p(_cc(c)), out.size)
    return out


def fma_scalar(acc: np.ndarray, s: int, c: np.ndarray) -> np.ndarray:
    out = _cc(acc).copy()
    _lib.fma_scalar(_u64p(out), int(s), _u64p(_cc(c)), out.size)
    return out


def dot_rows(data: np.ndarray, vec: np.ndarray) -> np.ndarray:
    """(k, n) x (n,) -> (k,) modular dot products."""
    data = _cc(data)
    k, n = data.shape
    out = np.zeros(k, dtype=np.uint64)
    _lib.dot_rows(_u64p(data), k, n, _u64p(_cc(vec)), _u64p(out))
    return out
