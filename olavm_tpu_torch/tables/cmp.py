"""Carried from olavm_tpu/tables/cmp.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

Cmp table (circuits/src/builtins/cmp/): gte via abs_diff + rangecheck CTL."""

from __future__ import annotations

import numpy as np

from ..stark.cross_table_lookup import Column
from ..stark.stark_base import Stark

COL_CMP_OP0 = 0
COL_CMP_OP1 = 1
COL_CMP_GTE = 2
COL_CMP_ABS_DIFF = 3
COL_CMP_ABS_DIFF_INV = 4
COL_CMP_FILTER_LOOKING_RC = 5
COL_NUM_CMP = 6


def generate_cmp_trace(rows) -> np.ndarray:
    n = len(rows)
    ext = max(2, 1 << (n - 1).bit_length()) if n >= 2 else 2
    tr = np.zeros((COL_NUM_CMP, ext), dtype=np.uint64)
    for i, c in enumerate(rows):
        tr[COL_CMP_OP0][i] = c.op0
        tr[COL_CMP_OP1][i] = c.op1
        tr[COL_CMP_GTE][i] = c.gte
        tr[COL_CMP_ABS_DIFF][i] = c.abs_diff
        tr[COL_CMP_ABS_DIFF_INV][i] = c.abs_diff_inv
        tr[COL_CMP_FILTER_LOOKING_RC][i] = c.filter_looking_rc
    if n != ext:
        tr[COL_CMP_OP0][n:] = 1
        tr[COL_CMP_GTE][n:] = 1
        tr[COL_CMP_ABS_DIFF][n:] = 1
        tr[COL_CMP_ABS_DIFF_INV][n:] = 1
    return tr


class CmpStark(Stark):
    COLUMNS = COL_NUM_CMP

    def constraint_degree(self):
        return 3

    def eval_packed(self, lv, nv, c):
        F = c.F
        one = F.constant(1)
        op0, op1 = lv[COL_CMP_OP0], lv[COL_CMP_OP1]
        gte = lv[COL_CMP_GTE]
        abs_diff = lv[COL_CMP_ABS_DIFF]
        abs_diff_inv = lv[COL_CMP_ABS_DIFF_INV]
        c.constraint(F.mul(gte, F.sub(one, gte)))
        c.constraint(F.mul(gte, F.sub(F.sub(op0, op1), abs_diff)))
        c.constraint(F.mul(F.sub(one, gte), F.sub(F.sub(op1, op0), abs_diff)))
        c.constraint(
            F.mul(F.sub(one, gte), F.sub(one, F.mul(abs_diff, abs_diff_inv)))
        )


def ctl_data_with_cpu():
    return Column.singles([COL_CMP_OP0, COL_CMP_OP1, COL_CMP_GTE])


def ctl_filter_with_cpu():
    return Column.single(COL_CMP_FILTER_LOOKING_RC)


def ctl_data_with_rangecheck():
    return [Column.single(COL_CMP_ABS_DIFF)]


def ctl_filter_with_rangecheck():
    return Column.single(COL_CMP_FILTER_LOOKING_RC)
