"""Carried from olavm_tpu/tables/sccall.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

SCCall table (circuits/src/builtins/sccall/): caller/callee env links."""

from __future__ import annotations

import numpy as np

from ..stark.cross_table_lookup import Column
from ..stark.stark_base import Stark

COL_SCCALL_TX_IDX = 0
COL_SCCALL_CALLER_ENV_IDX = 1
COL_SCCALL_CALLER_EXE_CTX = list(range(2, 6))
COL_SCCALL_CALLER_CODE_CTX = list(range(6, 10))
COL_SCCALL_CALLER_OP1_IMM = 10
COL_SCCALL_CLK_CALLER_CALL = 11
COL_SCCALL_CLK_CALLER_RET = 12
COL_SCCALL_CALLER_REG = list(range(13, 23))
COL_SCCALL_CALLEE_ENV_IDX = 23
COL_SCCALL_CLK_CALLEE_END = 24
COL_SCCALL_IS_PADDING = 25
NUM_COL_SCCALL = 26


def generate_sccall_trace(rows) -> np.ndarray:
    n = len(rows)
    ext = max(2, 1 << (n - 1).bit_length()) if n >= 2 else 2
    tr = np.zeros((NUM_COL_SCCALL, ext), dtype=np.uint64)
    for i, c in enumerate(rows):
        tr[COL_SCCALL_CALLER_ENV_IDX][i] = c.caller_env_idx
        for j in range(4):
            tr[COL_SCCALL_CALLER_EXE_CTX[j]][i] = c.addr_storage[j]
            tr[COL_SCCALL_CALLER_CODE_CTX[j]][i] = c.addr_code[j]
        tr[COL_SCCALL_CALLER_OP1_IMM][i] = c.caller_op1_imm
        tr[COL_SCCALL_CLK_CALLER_CALL][i] = c.clk_caller_call
        tr[COL_SCCALL_CLK_CALLER_RET][i] = c.clk_caller_ret
        for j in range(10):
            tr[COL_SCCALL_CALLER_REG[j]][i] = c.regs[j]
        tr[COL_SCCALL_CALLEE_ENV_IDX][i] = c.callee_env_idx
        tr[COL_SCCALL_CLK_CALLEE_END][i] = c.clk_callee_end
    if n != ext:
        tr[COL_SCCALL_IS_PADDING][n:] = 1
    return tr


class SCCallStark(Stark):
    COLUMNS = NUM_COL_SCCALL

    def constraint_degree(self):
        return 1

    def eval_packed(self, lv, nv, c):
        F = c.F
        c.constraint(
            F.sub(
                F.sub(lv[COL_SCCALL_CLK_CALLER_RET], lv[COL_SCCALL_CLK_CALLER_CALL]),
                lv[COL_SCCALL_CALLER_OP1_IMM],
            )
        )


def ctl_data_sccall():
    cols = [COL_SCCALL_TX_IDX, COL_SCCALL_CALLER_ENV_IDX]
    cols += COL_SCCALL_CALLER_EXE_CTX + COL_SCCALL_CALLER_CODE_CTX
    cols += [COL_SCCALL_CLK_CALLER_CALL, COL_SCCALL_CALLER_OP1_IMM]
    cols += COL_SCCALL_CALLER_REG
    cols += [COL_SCCALL_CALLEE_ENV_IDX]
    return Column.singles(cols)


def ctl_filter_sccall():
    return Column.linear_combination_with_constant(
        [(COL_SCCALL_IS_PADDING, -1)], 1
    )


def ctl_data_sccall_end():
    cols = [COL_SCCALL_TX_IDX, COL_SCCALL_CALLER_ENV_IDX]
    cols += COL_SCCALL_CALLER_EXE_CTX + COL_SCCALL_CALLER_CODE_CTX
    cols += [COL_SCCALL_CLK_CALLER_CALL]
    cols += COL_SCCALL_CALLER_REG
    cols += [COL_SCCALL_CALLEE_ENV_IDX, COL_SCCALL_CLK_CALLEE_END]
    return Column.singles(cols)


def ctl_filter_sccall_end():
    return Column.linear_combination_with_constant(
        [(COL_SCCALL_IS_PADDING, -1)], 1
    )
