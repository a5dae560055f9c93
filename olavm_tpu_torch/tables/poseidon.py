"""Carried from olavm_tpu/tables/poseidon.py: the card has no jax, so this copy imports
only jax-free modules; its code is unchanged.

Poseidon table (circuits/src/builtins/poseidon/poseidon_stark.rs,
generation/poseidon.rs): one row per permutation, constraining every round
by re-evaluating the permutation symbolically with witness S-box inputs."""

from __future__ import annotations

import numpy as np

from ..hash import poseidon as pos
from ..stark.cross_table_lookup import Column
from ..stark.stark_base import Stark

FILTER_LOOKED_NORMAL = 0
FILTER_LOOKED_TREEKEY = 1
FILTER_LOOKED_STORAGE_LEAF = 2
FILTER_LOOKED_STORAGE_BRANCH = 3
COL_POSEIDON_INPUT = list(range(4, 16))
COL_POSEIDON_OUTPUT = list(range(16, 28))
COL_FULL_0_1 = list(range(28, 40))
COL_FULL_0_2 = list(range(40, 52))
COL_FULL_0_3 = list(range(52, 64))
COL_PARTIAL = list(range(64, 86))
COL_FULL_1_0 = list(range(86, 98))
COL_FULL_1_1 = list(range(98, 110))
COL_FULL_1_2 = list(range(110, 122))
COL_FULL_1_3 = list(range(122, 134))
NUM_POSEIDON_COLS = 134

_FULL_0 = {1: COL_FULL_0_1, 2: COL_FULL_0_2, 3: COL_FULL_0_3}
_FULL_1 = {0: COL_FULL_1_0, 1: COL_FULL_1_1, 2: COL_FULL_1_2, 3: COL_FULL_1_3}

_ZERO_ROW = None


def _zero_hash_row():
    """Padding row: the zero-input permutation with all filters off."""
    global _ZERO_ROW
    if _ZERO_ROW is None:
        out, tr = pos.permute_np(np.zeros(12, dtype=np.uint64), with_trace=True)
        _ZERO_ROW = (out, tr)
    return _ZERO_ROW


def generate_poseidon_trace(rows) -> np.ndarray:
    n = len(rows)
    ext = max(2, 1 << (n - 1).bit_length()) if n >= 2 else 2
    tr = np.zeros((NUM_POSEIDON_COLS, ext), dtype=np.uint64)
    for i, c in enumerate(rows):
        tr[FILTER_LOOKED_NORMAL][i] = 1 if c.filter_looked_normal else 0
        tr[FILTER_LOOKED_TREEKEY][i] = 1 if c.filter_looked_treekey else 0
        tr[FILTER_LOOKED_STORAGE_LEAF][i] = 1 if c.filter_looked_storage else 0
        tr[FILTER_LOOKED_STORAGE_BRANCH][i] = (
            1 if c.filter_looked_storage_branch else 0
        )
        for j in range(12):
            tr[COL_POSEIDON_INPUT[j]][i] = c.input[j]
            tr[COL_POSEIDON_OUTPUT[j]][i] = c.output[j]
            tr[COL_FULL_0_1[j]][i] = c.full_0_1[j]
            tr[COL_FULL_0_2[j]][i] = c.full_0_2[j]
            tr[COL_FULL_0_3[j]][i] = c.full_0_3[j]
            tr[COL_FULL_1_0[j]][i] = c.full_1_0[j]
            tr[COL_FULL_1_1[j]][i] = c.full_1_1[j]
            tr[COL_FULL_1_2[j]][i] = c.full_1_2[j]
            tr[COL_FULL_1_3[j]][i] = c.full_1_3[j]
        for j in range(22):
            tr[COL_PARTIAL[j]][i] = c.partial[j]
    if n != ext:
        out, ztr = _zero_hash_row()
        for i in range(n, ext):
            for j in range(12):
                tr[COL_POSEIDON_OUTPUT[j]][i] = out[j]
                tr[COL_FULL_0_1[j]][i] = ztr["full_0_1"][j]
                tr[COL_FULL_0_2[j]][i] = ztr["full_0_2"][j]
                tr[COL_FULL_0_3[j]][i] = ztr["full_0_3"][j]
                tr[COL_FULL_1_0[j]][i] = ztr["full_1_0"][j]
                tr[COL_FULL_1_1[j]][i] = ztr["full_1_1"][j]
                tr[COL_FULL_1_2[j]][i] = ztr["full_1_2"][j]
                tr[COL_FULL_1_3[j]][i] = ztr["full_1_3"][j]
            for j in range(22):
                tr[COL_PARTIAL[j]][i] = ztr["partial"][j]
    return tr


class PoseidonStark(Stark):
    COLUMNS = NUM_POSEIDON_COLS

    def constraint_degree(self):
        return 7

    def eval_packed(self, lv, nv, c):
        F = c.F
        one = F.constant(1)

        # tree-key / storage hashes have zero cap lanes (input 9..11);
        # leaf hashes carry 1 in input[8] (poseidon_stark.rs:70-88)
        for col in COL_POSEIDON_INPUT[9:12]:
            c.constraint(F.mul(lv[FILTER_LOOKED_TREEKEY], lv[col]))
            c.constraint(F.mul(lv[FILTER_LOOKED_STORAGE_LEAF], lv[col]))
            c.constraint(F.mul(lv[FILTER_LOOKED_STORAGE_BRANCH], lv[col]))
        c.constraint(
            F.mul(lv[FILTER_LOOKED_STORAGE_LEAF],
                  F.sub(one, lv[COL_POSEIDON_INPUT[8]]))
        )

        def sbox(x):
            x2 = F.mul(x, x)
            x4 = F.mul(x2, x2)
            return F.mul(F.mul(x, x2), x4)

        def mds(state):
            out = []
            for r in range(12):
                acc = F.constant(0)
                for i in range(12):
                    acc = F.add(
                        acc, F.scalar_mul(state[(i + r) % 12], pos.MDS_CIRC[i])
                    )
                acc = F.add(acc, F.scalar_mul(state[r], pos.MDS_DIAG[r]))
                out.append(acc)
            return out

        state = [lv[col] for col in COL_POSEIDON_INPUT]
        round_ctr = 0
        for r in range(4):
            state = [
                F.add(state[i], F.constant(pos.ALL_ROUND_CONSTANTS[i + 12 * round_ctr]))
                for i in range(12)
            ]
            if r != 0:
                for i in range(12):
                    witness = lv[_FULL_0[r][i]]
                    c.constraint(F.sub(state[i], witness))
                    state[i] = witness
            state = [sbox(x) for x in state]
            state = mds(state)
            round_ctr += 1

        state = [
            F.add(state[i], F.constant(pos.FAST_PARTIAL_FIRST_ROUND_CONSTANT[i]))
            for i in range(12)
        ]
        # mds_partial_layer_init
        new_state = [state[0]]
        for col in range(1, 12):
            acc = F.constant(0)
            for r in range(1, 12):
                acc = F.add(
                    acc,
                    F.scalar_mul(
                        state[r],
                        pos.FAST_PARTIAL_ROUND_INITIAL_MATRIX[r - 1][col - 1],
                    ),
                )
            new_state.append(acc)
        state = new_state
        for r in range(22):
            witness = lv[COL_PARTIAL[r]]
            c.constraint(F.sub(state[0], witness))
            s0 = sbox(witness)
            if r < 21:
                s0 = F.add(s0, F.constant(pos.FAST_PARTIAL_ROUND_CONSTANTS[r]))
            d = F.scalar_mul(s0, pos.MDS_CIRC[0] + pos.MDS_DIAG[0])
            for i in range(1, 12):
                d = F.add(
                    d,
                    F.scalar_mul(state[i], pos.FAST_PARTIAL_ROUND_W_HATS[r][i - 1]),
                )
            state = [d] + [
                F.add(F.scalar_mul(s0, pos.FAST_PARTIAL_ROUND_VS[r][i - 1]), state[i])
                for i in range(1, 12)
            ]
        round_ctr += 22

        for r in range(4):
            state = [
                F.add(state[i], F.constant(pos.ALL_ROUND_CONSTANTS[i + 12 * round_ctr]))
                for i in range(12)
            ]
            for i in range(12):
                witness = lv[_FULL_1[r][i]]
                c.constraint(F.sub(state[i], witness))
                state[i] = witness
            state = [sbox(x) for x in state]
            state = mds(state)
            round_ctr += 1

        for i in range(12):
            c.constraint(F.sub(state[i], lv[COL_POSEIDON_OUTPUT[i]]))


# CTL views (poseidon_stark.rs:153-180)

def ctl_data_cpu_tree_key():
    return Column.singles(COL_POSEIDON_INPUT + COL_POSEIDON_OUTPUT[:4])


def ctl_filter_cpu_tree_key():
    return Column.single(FILTER_LOOKED_TREEKEY)


def ctl_data_with_poseidon_chunk():
    return Column.singles(COL_POSEIDON_INPUT + COL_POSEIDON_OUTPUT)


def ctl_filter_with_poseidon_chunk():
    return Column.single(FILTER_LOOKED_NORMAL)


def ctl_data_with_storage():
    return Column.singles(
        COL_POSEIDON_INPUT + COL_POSEIDON_OUTPUT[:4]
        + [FILTER_LOOKED_STORAGE_LEAF, FILTER_LOOKED_STORAGE_BRANCH]
    )


def ctl_filter_with_storage():
    return Column(
        [(FILTER_LOOKED_STORAGE_LEAF, 1), (FILTER_LOOKED_STORAGE_BRANCH, 1)]
    )
