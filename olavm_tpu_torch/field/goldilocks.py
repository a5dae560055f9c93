"""Carried from olavm_tpu/field/goldilocks.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

Host-side Goldilocks field arithmetic (p = 2^64 - 2^32 + 1).

Scalar ops use Python ints; batched ops use numpy uint64 arrays with
explicit 128-bit product handling via 32-bit limb splits.

Semantics match the reference field implementation
(plonky2/field/src/goldilocks_field.rs:14-326): the
EPSILON = 2^32 - 1 reduction trick, TWO_ADICITY = 32, multiplicative
group generator 7, 2^32-order subgroup generator 1753635133440165772.
All values here are kept canonical (in [0, p)).
"""

from __future__ import annotations

import numpy as np

P = 0xFFFFFFFF00000001  # 2^64 - 2^32 + 1
EPSILON = 0xFFFFFFFF  # 2^32 - 1 == 2^64 mod p
TWO_ADICITY = 32
MULTIPLICATIVE_GROUP_GENERATOR = 7
POWER_OF_TWO_GENERATOR = 1753635133440165772  # order 2^32

MASK64 = (1 << 64) - 1
MASK32 = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# Scalar ops (Python ints)
# ---------------------------------------------------------------------------


def add(a: int, b: int) -> int:
    s = a + b
    return s - P if s >= P else s


def sub(a: int, b: int) -> int:
    d = a - b
    return d + P if d < 0 else d


def neg(a: int) -> int:
    return 0 if a == 0 else P - a


def mul(a: int, b: int) -> int:
    return (a * b) % P


def exp(a: int, e: int) -> int:
    return pow(a, e, P)


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("inverse of zero in Goldilocks field")
    return pow(a, P - 2, P)


def primitive_root_of_unity(n_log: int) -> int:
    """g with g^(2^n_log) = 1, matching reference two-adic generator chain."""
    assert 0 <= n_log <= TWO_ADICITY
    g = POWER_OF_TWO_GENERATOR
    for _ in range(TWO_ADICITY - n_log):
        g = mul(g, g)
    return g


def two_adic_subgroup(n_log: int) -> list[int]:
    g = primitive_root_of_unity(n_log)
    out = [1]
    for _ in range((1 << n_log) - 1):
        out.append(mul(out[-1], g))
    return out


# ---------------------------------------------------------------------------
# Batched ops (numpy uint64). All arrays canonical.
# ---------------------------------------------------------------------------

_U64 = np.uint64



def to_gf(x) -> np.ndarray:
    """Coerce ints / array-likes (possibly signed or >= p) to canonical u64."""
    if isinstance(x, (int, np.integer)):
        return _U64(int(x) % P)
    a = np.asarray(x)
    if a.dtype == np.uint64:
        return np.where(a >= _U64(P), a - _U64(P), a)
    # go through python ints to avoid overflow surprises
    flat = [int(v) % P for v in a.reshape(-1).tolist()]
    return np.array(flat, dtype=np.uint64).reshape(a.shape)


def add_arr(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    nat = _native()
    if (nat is not None and isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
            and a.shape == b.shape and a.size >= _NATIVE_MIN):
        return nat.add_arrays(a, b)
    with np.errstate(over="ignore"):
        s = a + b  # wraps mod 2^64
        carry = s < a
        s = s + np.where(carry, _U64(EPSILON), _U64(0))
        return np.where(s >= _U64(P), s - _U64(P), s)


def sub_arr(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    nat = _native()
    if (nat is not None and isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
            and a.shape == b.shape and a.size >= _NATIVE_MIN):
        return nat.sub_arrays(a, b)
    with np.errstate(over="ignore"):
        d = a - b
        borrow = a < b
        return d - np.where(borrow, _U64(EPSILON), _U64(0))


def neg_arr(a: np.ndarray) -> np.ndarray:
    return np.where(a == 0, _U64(0), _U64(P) - a)


def _mul_wide(a: np.ndarray, b: np.ndarray):
    """64x64 -> 128-bit product as (lo64, hi64) uint64 arrays."""
    with np.errstate(over="ignore"):
        a_lo = a & _U64(MASK32)
        a_hi = a >> _U64(32)
        b_lo = b & _U64(MASK32)
        b_hi = b >> _U64(32)
        ll = a_lo * b_lo
        lh = a_lo * b_hi
        hl = a_hi * b_lo
        hh = a_hi * b_hi
        # mid accumulation: ll>>32 + lo32(lh) + lo32(hl) fits in 64 bits
        mid = (ll >> _U64(32)) + (lh & _U64(MASK32)) + (hl & _U64(MASK32))
        lo = (ll & _U64(MASK32)) | (mid << _U64(32))
        hi = hh + (lh >> _U64(32)) + (hl >> _U64(32)) + (mid >> _U64(32))
        return lo, hi


def reduce128(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Reduce a 128-bit value mod p (reference reduce128 trick), canonical out."""
    with np.errstate(over="ignore"):
        hi_hi = hi >> _U64(32)
        hi_lo = hi & _U64(MASK32)
        # t0 = lo - hi_hi (mod p): borrow-correct with EPSILON
        t0 = lo - hi_hi
        borrow = lo < hi_hi
        t0 = t0 - np.where(borrow, _U64(EPSILON), _U64(0))
        # t1 = hi_lo * EPSILON  (fits in 64 bits)
        t1 = (hi_lo << _U64(32)) - hi_lo
        t2 = t0 + t1
        carry = t2 < t0
        t2 = t2 + np.where(carry, _U64(EPSILON), _U64(0))
        return np.where(t2 >= _U64(P), t2 - _U64(P), t2)


_NATIVE_MIN = 1 << 15
_native_mod = None


def _native():
    """The native array-kernel module, or None (lazy import, cached)."""
    global _native_mod
    if _native_mod is None:
        try:
            from ..native import ntt_native

            _native_mod = ntt_native if ntt_native.available else False
        except Exception:
            _native_mod = False
    return _native_mod or None


def mul_arr(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    nat = _native()
    if nat is not None:
        a_arr = isinstance(a, np.ndarray) and a.ndim > 0
        b_arr = isinstance(b, np.ndarray) and b.ndim > 0
        if a_arr and b_arr and a.shape == b.shape and a.size >= _NATIVE_MIN:
            return nat.mul_arrays(a, b)
        if a_arr and not b_arr and a.size >= _NATIVE_MIN:
            return nat.mul_scalar(a, int(b))
        if b_arr and not a_arr and b.size >= _NATIVE_MIN:
            return nat.mul_scalar(b, int(a))
        # row-broadcast: (..., n) * (n,)
        if (a_arr and b_arr and b.ndim == 1 and a.ndim >= 2
                and a.shape[-1] == b.shape[0] and a.size >= _NATIVE_MIN):
            return nat.scale_rows(a, b)
        if (a_arr and b_arr and a.ndim == 1 and b.ndim >= 2
                and b.shape[-1] == a.shape[0] and b.size >= _NATIVE_MIN):
            return nat.scale_rows(b, a)
    lo, hi = _mul_wide(a, b)
    return reduce128(lo, hi)


def square_arr(a: np.ndarray) -> np.ndarray:
    return mul_arr(a, a)


def exp_arr(a: np.ndarray, e: int) -> np.ndarray:
    result = np.full_like(np.asarray(a), 1, dtype=np.uint64)
    base = a
    while e > 0:
        if e & 1:
            result = mul_arr(result, base)
        base = mul_arr(base, base)
        e >>= 1
    return result


def inv_arr(a: np.ndarray) -> np.ndarray:
    return exp_arr(a, P - 2)


def batch_inv(a: np.ndarray) -> np.ndarray:
    """Montgomery batch inversion over the flattened array (zeros -> zero)."""
    nat = _native()
    if nat is not None and a.size > 64:
        return nat.batch_inv(a).reshape(a.shape)
    flat = a.reshape(-1)
    n = flat.shape[0]
    nz = np.where(flat == 0, _U64(1), flat)
    prefix = np.empty(n, dtype=np.uint64)
    acc = _U64(1)
    for i in range(n):
        prefix[i] = acc
        acc = mul_arr(acc, nz[i])
    inv_acc = _U64(inv(int(acc)))
    out = np.empty(n, dtype=np.uint64)
    for i in range(n - 1, -1, -1):
        out[i] = mul_arr(inv_acc, prefix[i])
        inv_acc = mul_arr(inv_acc, nz[i])
    out = np.where(flat == 0, _U64(0), out)
    return out.reshape(a.shape)


def powers(base: int, n: int) -> np.ndarray:
    nat = _native()
    if nat is not None and n > 256:
        return nat.gl_powers(int(base) % P, n)
    out = np.empty(n, dtype=np.uint64)
    acc = 1
    for i in range(n):
        out[i] = acc
        acc = mul(acc, base)
    return out


def sum_mod(a: np.ndarray, axis: int = -1) -> np.ndarray:
    """Modular sum along an axis via pairwise log-tree of add_arr."""
    a = np.asarray(a, dtype=np.uint64)
    a = np.moveaxis(a, axis, 0)
    n = a.shape[0]
    while n > 1:
        half = n // 2
        s = add_arr(a[:half], a[half : 2 * half])
        if n % 2:
            a = np.concatenate([s, a[2 * half :]], axis=0)
            n = half + 1
        else:
            a = s
            n = half
    return a[0]


def prefix_sum_mod(a: np.ndarray) -> np.ndarray:
    """Inclusive modular prefix sum along the last axis (Hillis-Steele)."""
    a = np.array(a, dtype=np.uint64, copy=True)
    n = a.shape[-1]
    shift = 1
    while shift < n:
        a[..., shift:] = add_arr(a[..., shift:], a[..., :-shift])
        shift <<= 1
    return a


def prefix_prod_mod(a: np.ndarray) -> np.ndarray:
    """Inclusive modular prefix product along the last axis."""
    a = np.array(a, dtype=np.uint64, copy=True)
    n = a.shape[-1]
    shift = 1
    while shift < n:
        a[..., shift:] = mul_arr(a[..., shift:], a[..., :-shift])
        shift <<= 1
    return a
