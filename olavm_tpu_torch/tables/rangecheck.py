"""Carried from olavm_tpu/tables/rangecheck.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

RangeCheck table (circuits/src/builtins/rangecheck/): u32 values split
into 2 x u16 limbs, checked against a fixed u16 table via in-table lookups.
The table is always >= 2^16 rows (the fixed table)."""

from __future__ import annotations

import numpy as np

from ..stark.cross_table_lookup import Column
from ..stark.lookup import eval_lookups, permuted_cols
from ..stark.stark_base import PermutationPair, Stark

CPU_FILTER = 0
MEMORY_SORT_FILTER = 1
MEMORY_REGION_FILTER = 2
CMP_FILTER = 3
VAL = 4
LIMB_LO = 5
LIMB_HI = 6
LIMB_LO_PERMUTED = 7
LIMB_HI_PERMUTED = 8
FIX_RANGE_CHECK_U16 = 9
FIX_RANGE_CHECK_U16_PERMUTED_LO = 10
FIX_RANGE_CHECK_U16_PERMUTED_HI = 11
COL_NUM_RC = 12

RANGE_CHECK_U16_SIZE = 1 << 16


def generate_rc_trace(rows) -> np.ndarray:
    n = len(rows)
    max_len = max(n, RANGE_CHECK_U16_SIZE)
    ext = max(2, 1 << (max_len - 1).bit_length())
    tr = np.zeros((COL_NUM_RC, ext), dtype=np.uint64)
    for i, c in enumerate(rows):
        tr[CPU_FILTER][i] = c.filter_looked_for_cpu
        tr[MEMORY_SORT_FILTER][i] = c.filter_looked_for_mem_sort
        tr[MEMORY_REGION_FILTER][i] = c.filter_looked_for_mem_region
        tr[CMP_FILTER][i] = c.filter_looked_for_comparison
        tr[VAL][i] = c.val
        tr[LIMB_LO][i] = c.limb_lo
        tr[LIMB_HI][i] = c.limb_hi
    fix = np.arange(ext, dtype=np.uint64)
    fix[RANGE_CHECK_U16_SIZE:] = RANGE_CHECK_U16_SIZE - 1
    tr[FIX_RANGE_CHECK_U16] = fix
    tr[LIMB_LO_PERMUTED], tr[FIX_RANGE_CHECK_U16_PERMUTED_LO] = permuted_cols(
        tr[LIMB_LO], tr[FIX_RANGE_CHECK_U16]
    )
    tr[LIMB_HI_PERMUTED], tr[FIX_RANGE_CHECK_U16_PERMUTED_HI] = permuted_cols(
        tr[LIMB_HI], tr[FIX_RANGE_CHECK_U16]
    )
    return tr


class RangeCheckStark(Stark):
    COLUMNS = COL_NUM_RC

    def constraint_degree(self):
        return 3

    def eval_packed(self, lv, nv, c):
        F = c.F
        s = F.add(lv[LIMB_LO], F.scalar_mul(lv[LIMB_HI], 1 << 16))
        c.constraint(F.sub(lv[VAL], s))
        eval_lookups(lv, nv, c, LIMB_LO_PERMUTED, FIX_RANGE_CHECK_U16_PERMUTED_LO)
        eval_lookups(lv, nv, c, LIMB_HI_PERMUTED, FIX_RANGE_CHECK_U16_PERMUTED_HI)

    def permutation_pairs(self):
        return [
            PermutationPair.singletons(LIMB_LO, LIMB_LO_PERMUTED),
            PermutationPair.singletons(LIMB_HI, LIMB_HI_PERMUTED),
            PermutationPair.singletons(FIX_RANGE_CHECK_U16, FIX_RANGE_CHECK_U16_PERMUTED_LO),
            PermutationPair.singletons(FIX_RANGE_CHECK_U16, FIX_RANGE_CHECK_U16_PERMUTED_HI),
        ]


def ctl_data_memory():
    return [Column.single(VAL)]


def ctl_filter_memory_sort():
    return Column.single(MEMORY_SORT_FILTER)


def ctl_filter_memory_region():
    return Column.single(MEMORY_REGION_FILTER)


def ctl_data_with_cmp():
    return [Column.single(VAL)]


def ctl_filter_with_cmp():
    return Column.single(CMP_FILTER)


def ctl_data_with_cpu():
    return [Column.single(VAL)]


def ctl_filter_with_cpu():
    return Column.single(CPU_FILTER)
