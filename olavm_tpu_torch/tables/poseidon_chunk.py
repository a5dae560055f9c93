"""Carried from olavm_tpu/tables/poseidon_chunk.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

PoseidonChunk table (circuits/src/builtins/poseidon/poseidon_chunk_stark.rs,
generation/poseidon_chunk.rs): sponge chunking (rate 8) of the VM's POSEIDON
opcode, with CTLs to memory (input reads, output writes) and Poseidon."""

from __future__ import annotations

import numpy as np

from ..stark.cross_table_lookup import Column
from ..stark.stark_base import Stark

COL_PC_TX_IDX = 0
COL_PC_ENV_IDX = 1
COL_PC_CLK = 2
COL_PC_OPCODE = 3
COL_PC_OP0 = 4
COL_PC_OP1 = 5
COL_PC_DST = 6
COL_PC_ACC_CNT = 7
COL_PC_VALUE = list(range(8, 16))
COL_PC_CAP = list(range(16, 20))
COL_PC_HASH = list(range(20, 32))
COL_PC_IS_EXT_LINE = 32
COL_PC_IS_RESULT_LINE = 33
COL_PC_IS_FIRST_PADDING = list(range(34, 42))
COL_PC_FILTER_LOOKED_CPU = 42
COL_PC_FILTER_LOOKING_MEM = list(range(43, 51))
COL_PC_FILTER_LOOKING_POSEIDON = 51
COL_PC_IS_PADDING_LINE = 52
NUM_POSEIDON_CHUNK_COLS = 53


def generate_poseidon_chunk_trace(rows) -> np.ndarray:
    n = len(rows)
    ext = max(2, 1 << (n - 1).bit_length()) if n >= 2 else 2
    tr = np.zeros((NUM_POSEIDON_CHUNK_COLS, ext), dtype=np.uint64)
    for i, c in enumerate(rows):
        tr[COL_PC_ENV_IDX][i] = c.env_idx
        tr[COL_PC_CLK][i] = c.clk
        tr[COL_PC_OPCODE][i] = c.opcode
        tr[COL_PC_OP0][i] = c.op0
        tr[COL_PC_OP1][i] = c.op1
        tr[COL_PC_DST][i] = c.dst
        tr[COL_PC_ACC_CNT][i] = c.acc_cnt
        for j in range(8):
            tr[COL_PC_VALUE[j]][i] = c.value[j]
        for j in range(4):
            tr[COL_PC_CAP[j]][i] = c.cap[j]
        for j in range(12):
            tr[COL_PC_HASH[j]][i] = c.hash[j]
        tr[COL_PC_IS_EXT_LINE][i] = c.is_ext_line
        is_result = c.op1 == c.acc_cnt
        tr[COL_PC_IS_RESULT_LINE][i] = 1 if is_result else 0
        if is_result:
            first_padding = c.op1 % 8
            if first_padding != 0:
                tr[COL_PC_IS_FIRST_PADDING[first_padding]][i] = 1
        tr[COL_PC_FILTER_LOOKED_CPU][i] = 1 if c.is_ext_line == 0 else 0
        if c.is_ext_line == 1:
            for j in range(8):
                tr[COL_PC_FILTER_LOOKING_MEM[j]][i] = 1
            if is_result:
                first_padding = c.op1 % 8
                if first_padding != 0:
                    for j in range(first_padding, 8):
                        tr[COL_PC_FILTER_LOOKING_MEM[j]][i] = 0
        tr[COL_PC_FILTER_LOOKING_POSEIDON][i] = c.is_ext_line
    if n != ext:
        tr[COL_PC_IS_PADDING_LINE][n:] = 1
    return tr


class PoseidonChunkStark(Stark):
    COLUMNS = NUM_POSEIDON_CHUNK_COLS

    def constraint_degree(self):
        return 3

    def eval_packed(self, lv, nv, c):
        F = c.F
        one = F.constant(1)

        def m(*terms):
            acc = terms[0]
            for t in terms[1:]:
                acc = F.mul(acc, t)
            return acc

        lp = lv[COL_PC_IS_PADDING_LINE]
        np_ = nv[COL_PC_IS_PADDING_LINE]
        lext = lv[COL_PC_IS_EXT_LINE]
        next_ = nv[COL_PC_IS_EXT_LINE]

        c.constraint(m(lp, F.sub(one, lp)))
        d = F.sub(np_, lp)
        c.constraint_transition(m(d, F.sub(d, one)))
        c.constraint(m(lext, F.sub(one, lext)))
        for col in (COL_PC_TX_IDX, COL_PC_ENV_IDX, COL_PC_CLK, COL_PC_OPCODE,
                    COL_PC_OP1, COL_PC_DST):
            c.constraint(m(next_, F.sub(nv[col], lv[col])))
        c.constraint_first_row(m(F.sub(one, lp), lext))
        for col in COL_PC_IS_FIRST_PADDING:
            c.constraint(m(lv[col], F.sub(one, lv[col])))
        sum_fp = F.add_many([lv[col] for col in COL_PC_IS_FIRST_PADDING])
        c.constraint(m(sum_fp, F.sub(one, sum_fp)))

        # line-acc addends: 1 - prefix_sum(is_first_padding)
        def addends(vals):
            out = []
            acc = F.constant(0)
            for v in vals:
                acc = F.add(acc, v)
                out.append(F.sub(one, acc))
            return out

        v_addends = addends([lv[col] for col in COL_PC_IS_FIRST_PADDING])
        n_addends = addends([nv[col] for col in COL_PC_IS_FIRST_PADDING])
        n_total = F.add_many(n_addends)
        c.constraint(
            m(next_, F.sub(F.sub(nv[COL_PC_ACC_CNT], lv[COL_PC_ACC_CNT]), n_total))
        )
        c.constraint(m(sum_fp, next_))
        c.constraint(m(sum_fp, F.sub(one, lv[COL_PC_IS_RESULT_LINE])))
        c.constraint(m(sum_fp, F.sub(lv[COL_PC_ACC_CNT], lv[COL_PC_OP1])))
        c.constraint(
            m(F.sub(lv[COL_PC_ACC_CNT], lv[COL_PC_OP1]), F.sub(one, next_))
        )
        for col in COL_PC_HASH:
            c.constraint(m(F.sub(one, lext), lv[col]))
        for j in range(4):
            c.constraint(
                m(next_, F.sub(nv[COL_PC_CAP[j]], lv[COL_PC_HASH[8 + j]]))
            )
        c.constraint(
            m(F.sub(one, lext), next_, F.sub(nv[COL_PC_OP0], lv[COL_PC_OP0]))
        )
        c.constraint(
            m(lext, next_,
              F.sub(F.sub(nv[COL_PC_OP0], lv[COL_PC_OP0]), F.constant(8)))
        )
        flc = lv[COL_PC_FILTER_LOOKED_CPU]
        c.constraint(m(F.sub(one, lp), F.sub(one, lext), F.sub(one, flc)))
        c.constraint(m(F.sub(one, lp), lext, flc))
        c.constraint(m(lp, flc))
        for j, col in enumerate(COL_PC_FILTER_LOOKING_MEM):
            c.constraint(m(F.sub(one, lext), lv[col]))
            c.constraint(m(lext, F.sub(lv[col], v_addends[j])))
        flp = lv[COL_PC_FILTER_LOOKING_POSEIDON]
        c.constraint(m(F.sub(one, lp), lext, F.sub(one, flp)))
        c.constraint(m(F.sub(one, lp), F.sub(one, lext), flp))


# CTL views (poseidon_chunk_stark.rs:23-90)

def ctl_data_with_cpu():
    return Column.singles([
        COL_PC_TX_IDX, COL_PC_ENV_IDX, COL_PC_CLK, COL_PC_OPCODE,
        COL_PC_OP0, COL_PC_OP1, COL_PC_DST,
    ])


def ctl_filter_with_cpu():
    return Column.single(COL_PC_FILTER_LOOKED_CPU)


def ctl_data_with_mem_src(i: int):
    cols = Column.singles([COL_PC_TX_IDX, COL_PC_ENV_IDX, COL_PC_CLK, COL_PC_OPCODE])
    cols.append(Column.linear_combination_with_constant([(COL_PC_OP0, 1)], i))
    cols.append(Column.single(COL_PC_VALUE[i]))
    cols.append(Column.zero())
    return cols


def ctl_filter_with_mem_src(i: int):
    return Column.single(COL_PC_FILTER_LOOKING_MEM[i])


def ctl_data_with_mem_dst(i: int):
    cols = Column.singles([COL_PC_TX_IDX, COL_PC_ENV_IDX, COL_PC_CLK, COL_PC_OPCODE])
    cols.append(Column.linear_combination_with_constant([(COL_PC_DST, 1)], i))
    cols.append(Column.single(COL_PC_HASH[i]))
    cols.append(Column.one())
    return cols


def ctl_filter_with_mem_dst():
    return Column.single(COL_PC_IS_RESULT_LINE)


def ctl_data_with_poseidon():
    return Column.singles(COL_PC_VALUE + COL_PC_CAP + COL_PC_HASH)


def ctl_filter_with_poseidon():
    return Column.single(COL_PC_FILTER_LOOKING_POSEIDON)
