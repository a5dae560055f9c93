"""Carried from olavm_tpu/stark/polynomial.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

Polynomial utilities for the STARK prover/verifier: extension-field
evaluation, synthetic division, zero-poly-on-coset, Lagrange selectors.

Vectorized equivalents of the reference polynomial layer
(plonky2/field/src/polynomial/mod.rs, zero_poly_coset.rs). Sequential
recurrences (Horner, synthetic division) are reformulated as prefix scans so
they vectorize.
"""

from __future__ import annotations

import numpy as np

from ..field import extension as ge
from ..field import goldilocks as g
from ..ntt import host as ntt


def ext_powers_block(z, n: int) -> np.ndarray:
    """[1, z, ..., z^(n-1)] as (n, 2) via log-doubling of blocks."""
    out = np.zeros((max(n, 1), 2), dtype=np.uint64)
    out[0] = ge.from_base(1)
    ln = 1
    while ln < n:
        take = min(ln, n - ln)
        zl = ge.exp_u64(z, ln)
        out[ln : ln + take] = ge.mul(np.broadcast_to(zl, (take, 2)), out[:take])
        ln *= 2
    return out


def eval_ext_many(coeff_matrix: np.ndarray, z) -> np.ndarray:
    """Evaluate many base-field polynomials (k, n) at extension point z.

    Returns (k, 2). Uses f(z) = sum_i c_i z^i with precomputed powers.
    """
    k, n = coeff_matrix.shape
    zpow = ext_powers_block(z, n)  # (n, 2)
    nat = g._native()
    if nat is not None and coeff_matrix.size >= 1 << 12:
        out = np.zeros((k, 2), dtype=np.uint64)
        out[:, 0] = nat.dot_rows(coeff_matrix, np.ascontiguousarray(zpow[:, 0]))
        out[:, 1] = nat.dot_rows(coeff_matrix, np.ascontiguousarray(zpow[:, 1]))
        return out
    # sum over i of c[k,i] * zpow[i], componentwise scalar mul
    out = np.zeros((k, 2), dtype=np.uint64)
    chunk = max(1, (1 << 22) // max(k, 1))
    for start in range(0, n, chunk):
        end = min(n, start + chunk)
        c = coeff_matrix[:, start:end]  # (k, m)
        zp = zpow[start:end]  # (m, 2)
        t0 = g.mul_arr(c, zp[None, :, 0])
        t1 = g.mul_arr(c, zp[None, :, 1])
        out[:, 0] = g.add_arr(out[:, 0], g.sum_mod(t0, axis=1))
        out[:, 1] = g.add_arr(out[:, 1], g.sum_mod(t1, axis=1))
    return out


def eval_base_many(coeff_matrix: np.ndarray, z: int) -> np.ndarray:
    """Evaluate many base polynomials (k, n) at base point z. Returns (k,)."""
    k, n = coeff_matrix.shape
    zpow = g.powers(z, n)
    nat = g._native()
    if nat is not None and coeff_matrix.size >= 1 << 12:
        return nat.dot_rows(coeff_matrix, zpow)
    prods = g.mul_arr(coeff_matrix, zpow[None, :])
    return g.sum_mod(prods, axis=1)


def ext_poly_eval(coeffs_ext: np.ndarray, z) -> np.ndarray:
    """Evaluate an extension polynomial (n, 2) at extension z -> (2,)."""
    n = coeffs_ext.shape[0]
    zpow = ext_powers_block(z, n)
    prods = ge.mul(coeffs_ext, zpow)
    return np.stack(
        [g.sum_mod(prods[:, 0], axis=0), g.sum_mod(prods[:, 1], axis=0)]
    )


def divide_by_linear(coeffs_ext: np.ndarray, z) -> tuple[np.ndarray, np.ndarray]:
    """(f(X) - f(z)) / (X - z) for an extension poly (n, 2).

    Returns (quotient (n,2) with last coeff zero, f(z)).
    Sequential synthetic division is restated as
    b_i = (f(z) - S_i) * z^{-(i+1)}, S_i = sum_{j<=i} c_j z^j.
    """
    n = coeffs_ext.shape[0]
    zpow = ext_powers_block(z, n)
    t = ge.mul(coeffs_ext, zpow)  # c_j z^j
    s0 = g.prefix_sum_mod(t[:, 0])
    s1 = g.prefix_sum_mod(t[:, 1])
    fz = np.stack([s0[-1], s1[-1]])
    zinv = ge.inv(z)
    zinv_pows = ext_powers_block(zinv, n + 1)  # z^-(i+1) = zinv_pows[i+1]
    diff = ge.sub(np.broadcast_to(fz, (n, 2)), np.stack([s0, s1], axis=-1))
    q = ge.mul(diff, zinv_pows[1 : n + 1])
    q[-1] = 0  # b_{n-1} = 0 (degree drops by one)
    return q, fz


class ZeroPolyOnCoset:
    """Z_H(x) = x^n - 1 evaluated on the coset shift*H', |H'| = n * 2^qdb.

    The values repeat with period 2^qdb (plonky2/field/src/zero_poly_coset.rs).
    """

    def __init__(self, degree_bits: int, quotient_degree_bits: int):
        n = 1 << degree_bits
        rate = 1 << quotient_degree_bits
        shift_pow_n = pow(g.MULTIPLICATIVE_GROUP_GENERATOR, n, g.P)
        gq = g.primitive_root_of_unity(quotient_degree_bits)
        evals = np.array(
            [(shift_pow_n * pow(gq, i, g.P) - 1) % g.P for i in range(rate)],
            dtype=np.uint64,
        )
        self.evals = evals
        self.inverses = g.batch_inv(evals)
        self.rate = rate

    def eval_inverse_all(self, size: int) -> np.ndarray:
        reps = size // self.rate
        return np.tile(self.inverses, reps)


def lagrange_selector_on_coset(
    degree: int, index: int, quotient_degree_bits: int
) -> np.ndarray:
    """Values over the coset of the Lagrange basis poly L_index for H."""
    sel = np.zeros(degree, dtype=np.uint64)
    sel[index] = 1
    coeffs = ntt.intt(sel)
    return ntt.coset_lde(coeffs, quotient_degree_bits)


def ext_coset_fft(coeffs_ext: np.ndarray, shift: int) -> np.ndarray:
    """Coset FFT of an extension polynomial (componentwise base NTT)."""
    v0 = ntt.coset_fft(coeffs_ext[:, 0], shift)
    v1 = ntt.coset_fft(coeffs_ext[:, 1], shift)
    return np.stack([v0, v1], axis=-1)
