"""Carried from olavm_tpu/ntt/host.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

Host (numpy) batched NTT — same algorithm/conventions as ntt.ntt but on
uint64 arrays. Used for correctness paths and small sizes; the device version
takes over for large commits."""

from __future__ import annotations

import numpy as np

from ..field import goldilocks as g
from ..utils.bits import bit_reversal_perm, log2_strict

_TWIDDLE_CACHE: dict = {}
_PERM_CACHE: dict = {}


def _twiddles(log_n: int, inverse: bool):
    key = (log_n, inverse)
    if key not in _TWIDDLE_CACHE:
        n = 1 << log_n
        root = g.primitive_root_of_unity(log_n)
        if inverse:
            root = g.inv(root)
        stages = []
        for s in range(1, log_n + 1):
            m = 1 << s
            stages.append(g.powers(pow(root, n // m, g.P), m // 2))
        _TWIDDLE_CACHE[key] = stages
    return _TWIDDLE_CACHE[key]


def _perm(log_n: int):
    if log_n not in _PERM_CACHE:
        _PERM_CACHE[log_n] = bit_reversal_perm(1 << log_n)
    return _PERM_CACHE[log_n]


_FLAT_TWIDDLE_CACHE: dict = {}


def _flat_twiddles(log_n: int, inverse: bool) -> np.ndarray:
    key = (log_n, inverse)
    if key not in _FLAT_TWIDDLE_CACHE:
        _FLAT_TWIDDLE_CACHE[key] = np.concatenate(_twiddles(log_n, inverse))
    return _FLAT_TWIDDLE_CACHE[key]


# native C++ kernel takes over above this size (threaded, __int128 mul)
_NATIVE_MIN_N = 1 << 10


def _transform(x: np.ndarray, inverse: bool) -> np.ndarray:
    n = x.shape[-1]
    log_n = log2_strict(n)
    if n == 1:
        return x.copy()
    from ..native import ntt_native

    if ntt_native.available and n >= _NATIVE_MIN_N:
        return ntt_native.ntt_batch(
            np.asarray(x, dtype=np.uint64), _flat_twiddles(log_n, inverse)
        )
    batch_shape = x.shape[:-1]
    x = np.take(x, _perm(log_n), axis=-1)
    tw = _twiddles(log_n, inverse)
    for s in range(1, log_n + 1):
        half = 1 << (s - 1)
        xv = x.reshape(*batch_shape, n >> s, 2, half)
        u = xv[..., 0, :]
        v = g.mul_arr(xv[..., 1, :], tw[s - 1])
        x = np.concatenate(
            [g.add_arr(u, v)[..., None, :], g.sub_arr(u, v)[..., None, :]], axis=-2
        ).reshape(*batch_shape, n)
    return x


def ntt(x: np.ndarray) -> np.ndarray:
    """coeffs -> values p(g^i), natural order, last axis."""
    return _transform(np.asarray(x, dtype=np.uint64), inverse=False)


def intt(x: np.ndarray) -> np.ndarray:
    n = x.shape[-1]
    out = _transform(np.asarray(x, dtype=np.uint64), inverse=True)
    return g.mul_arr(out, np.uint64(g.inv(n)))


def scale_by_powers(x: np.ndarray, base: int) -> np.ndarray:
    return g.mul_arr(np.asarray(x, dtype=np.uint64), g.powers(base, x.shape[-1]))


def coset_fft(coeffs: np.ndarray, shift: int = g.MULTIPLICATIVE_GROUP_GENERATOR):
    return ntt(scale_by_powers(coeffs, shift))


def coset_ifft(values: np.ndarray, shift: int = g.MULTIPLICATIVE_GROUP_GENERATOR):
    return scale_by_powers(intt(values), g.inv(shift))


def coset_lde(
    coeffs: np.ndarray, rate_bits: int, shift: int = g.MULTIPLICATIVE_GROUP_GENERATOR
) -> np.ndarray:
    n = coeffs.shape[-1]
    big = n << rate_bits
    padded = np.zeros(coeffs.shape[:-1] + (big,), dtype=np.uint64)
    padded[..., :n] = coeffs
    return ntt(scale_by_powers(padded, shift))
