"""Carried from olavm_tpu/native/lookup_native.py: the port imports nothing of olavm_tpu, so it
keeps its own copy, built from native/gl_lookup.cpp through hostlib.build;
the code is otherwise unchanged.

ctypes loader for the exact permuted-columns kernel (gl_lookup.cpp)."""

from __future__ import annotations

import ctypes

import numpy as np

from . import hostlib

available = False
_lib = None


def _load():
    global _lib, available
    lib = ctypes.CDLL(hostlib.build("gl_lookup"))
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.permuted_cols.argtypes = [u64p, u64p, ctypes.c_uint64, u64p, u64p]
    lib.permuted_cols.restype = ctypes.c_int
    _lib = lib
    available = True


try:
    _load()
except Exception as _e:  # pragma: no cover
    import warnings

    warnings.warn(f"native gl_lookup unavailable, using python path: {_e}")


def permuted_cols(inputs: np.ndarray, table: np.ndarray):
    n = len(inputs)
    inputs = np.ascontiguousarray(inputs, dtype=np.uint64)
    table = np.ascontiguousarray(table, dtype=np.uint64)
    si = np.empty(n, dtype=np.uint64)
    pt = np.empty(n, dtype=np.uint64)
    rc = _lib.permuted_cols(
        inputs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        table.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n,
        si.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        pt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if rc != 0:
        raise ValueError("permuted_cols: unused inds/vals mismatch")
    return si, pt
