"""Carried from olavm_tpu/field/extension.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

Quadratic extension of Goldilocks: F_p[X]/(X^2 - 7).

Matches the reference extension (plonky2/field/src/goldilocks_extensions.rs:19,
W = 7). Elements are (a0, a1) pairs of canonical u64; batched ops take numpy
arrays of shape (..., 2).
"""

from __future__ import annotations

import numpy as np

from . import goldilocks as g

W = 7


def from_base(a):
    """Base field scalar/array -> extension with zero imaginary part."""
    if isinstance(a, (int, np.integer)):
        return np.array([int(a), 0], dtype=np.uint64)
    a = np.asarray(a, dtype=np.uint64)
    out = np.zeros(a.shape + (2,), dtype=np.uint64)
    out[..., 0] = a
    return out


def add(a, b):
    return g.add_arr(np.asarray(a, dtype=np.uint64), np.asarray(b, dtype=np.uint64))


def sub(a, b):
    return g.sub_arr(np.asarray(a, dtype=np.uint64), np.asarray(b, dtype=np.uint64))


def neg(a):
    return g.neg_arr(np.asarray(a, dtype=np.uint64))


def mul(a, b):
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    a0, a1 = a[..., 0], a[..., 1]
    b0, b1 = b[..., 0], b[..., 1]
    c0 = g.add_arr(g.mul_arr(a0, b0), g.mul_arr(np.uint64(W), g.mul_arr(a1, b1)))
    c1 = g.add_arr(g.mul_arr(a0, b1), g.mul_arr(a1, b0))
    return np.stack([c0, c1], axis=-1)


def scalar_mul(a, s):
    """Multiply extension element(s) by base-field scalar(s)."""
    a = np.asarray(a, dtype=np.uint64)
    s = np.asarray(g.to_gf(s))
    return np.stack(
        [g.mul_arr(a[..., 0], s), g.mul_arr(a[..., 1], s)], axis=-1
    )


def square(a):
    return mul(a, a)


def inv(a):
    """(a0 + a1 φ)^-1 = (a0 - a1 φ) / (a0^2 - W a1^2)."""
    a = np.asarray(a, dtype=np.uint64)
    a0, a1 = a[..., 0], a[..., 1]
    norm = g.sub_arr(g.mul_arr(a0, a0), g.mul_arr(np.uint64(W), g.mul_arr(a1, a1)))
    if norm.ndim == 0:
        ninv = np.uint64(g.inv(int(norm)))
    else:
        ninv = g.batch_inv(norm)
    return np.stack(
        [g.mul_arr(a0, ninv), g.mul_arr(g.neg_arr(a1), ninv)], axis=-1
    )


def exp_pow2(a, k: int):
    """a^(2^k)."""
    for _ in range(k):
        a = square(a)
    return a


def exp_u64(a, e: int):
    result = from_base(1)
    base = a
    while e:
        if e & 1:
            result = mul(result, base)
        base = square(base)
        e >>= 1
    return result


def is_one(a) -> bool:
    a = np.asarray(a)
    return int(a[..., 0]) == 1 and int(a[..., 1]) == 0


def eq(a, b) -> bool:
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


def powers(a, n: int):
    """[1, a, a^2, ..., a^(n-1)] as (n, 2) array."""
    out = np.zeros((n, 2), dtype=np.uint64)
    acc = from_base(1)
    for i in range(n):
        out[i] = acc
        acc = mul(acc, a)
    return out


# ---------------------------------------------------------------------------
# Python-int tuple ops — fast scalar path for verifier-side loops, where
# numpy's per-call overhead (microseconds) dwarfs the arithmetic.
# ---------------------------------------------------------------------------

_P = g.P


def t(a) -> tuple:
    """Coerce an extension value ((2,) array / tuple / base int) to a tuple."""
    if isinstance(a, tuple):
        return a
    if isinstance(a, (int, np.integer)):
        return (int(a), 0)
    arr = np.asarray(a).reshape(-1)
    return (int(arr[0]), int(arr[1]))


def t_add(a, b):
    return ((a[0] + b[0]) % _P, (a[1] + b[1]) % _P)


def t_sub(a, b):
    return ((a[0] - b[0]) % _P, (a[1] - b[1]) % _P)


def t_mul(a, b):
    return (
        (a[0] * b[0] + W * a[1] * b[1]) % _P,
        (a[0] * b[1] + a[1] * b[0]) % _P,
    )


def t_scalar(a, s: int):
    return ((a[0] * s) % _P, (a[1] * s) % _P)


def t_inv(a):
    norm = (a[0] * a[0] - W * a[1] * a[1]) % _P
    ninv = pow(norm, _P - 2, _P)
    return ((a[0] * ninv) % _P, (-a[1] * ninv) % _P)


def t_exp(a, e: int):
    result = (1, 0)
    base = a
    while e:
        if e & 1:
            result = t_mul(result, base)
        base = t_mul(base, base)
        e >>= 1
    return result


def t_arr(a) -> np.ndarray:
    return np.array(a, dtype=np.uint64)
