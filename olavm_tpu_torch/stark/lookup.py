"""Carried from olavm_tpu/stark/lookup.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

Halo2-style in-table lookups (circuits/src/stark/lookup.rs)."""

from __future__ import annotations

import numpy as np

from ..field import goldilocks as g


def permuted_cols(inputs: np.ndarray, table: np.ndarray):
    """Generate (sorted_inputs, permuted_table) for the halo2-style lookup,
    reproducing the reference's stack-based merge-walk EXACTLY
    (lookup.rs:69-134) so the committed bitwise/rangecheck/program columns
    — and therefore caps and the whole Fiat-Shamir transcript — match the
    reference bit-for-bit. C++ kernel with a same-algorithm Python fallback.
    """
    from ..native import lookup_native

    if lookup_native.available:
        return lookup_native.permuted_cols(inputs, table)
    return _permuted_cols_py(inputs, table)


def _permuted_cols_py(inputs: np.ndarray, table: np.ndarray):
    """Pure-Python transliteration of the reference merge (lookup.rs:69-134)."""
    n = len(inputs)
    si = np.sort(np.asarray(inputs, dtype=np.uint64)).tolist()
    st = np.sort(np.asarray(table, dtype=np.uint64)).tolist()
    permuted_table = [0] * n
    unused_inds: list[int] = []
    unused_vals: list[int] = []
    i = j = 0
    while i < n and j < n:
        if si[i] > st[j]:
            unused_vals.append(st[j])
            j += 1
        elif si[i] < st[j]:
            if unused_vals:
                permuted_table[i] = unused_vals.pop()
            else:
                unused_inds.append(i)
            i += 1
        else:
            permuted_table[i] = st[j]
            i += 1
            j += 1
    unused_vals.extend(st[j:])
    unused_inds.extend(range(i, n))
    if len(unused_inds) != len(unused_vals):
        raise ValueError("permuted_cols: unused inds/vals mismatch")
    for ind, val in zip(unused_inds, unused_vals):
        permuted_table[ind] = val
    return (
        np.array(si, dtype=np.uint64),
        np.array(permuted_table, dtype=np.uint64),
    )


def eval_lookups(local, nxt, consumer, col_permuted_input, col_permuted_table):
    """Lookup constraints (lookup.rs:13-34)."""
    F = consumer.F
    diff_input_prev = F.sub(nxt[col_permuted_input], local[col_permuted_input])
    diff_input_table = F.sub(nxt[col_permuted_input], nxt[col_permuted_table])
    consumer.constraint(F.mul(diff_input_prev, diff_input_table))
    consumer.constraint_last_row(diff_input_table)
