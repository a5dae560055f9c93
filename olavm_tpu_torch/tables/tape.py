"""Carried from olavm_tpu/tables/tape.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

Tape table (circuits/src/builtins/tape/): calldata/returndata tape
read/write consistency."""

from __future__ import annotations

import numpy as np

from ..isa.opcodes import Opcode
from ..stark.cross_table_lookup import Column
from ..stark.stark_base import Stark

COL_TAPE_TX_IDX = 0
COL_TAPE_IS_INIT_SEG = 1
COL_TAPE_OPCODE = 2
COL_TAPE_ADDR = 3
COL_TAPE_VALUE = 4
COL_FILTER_LOOKED = 5
NUM_COL_TAPE = 6


def generate_tape_trace(rows) -> np.ndarray:
    n = len(rows)
    ext = max(2, 1 << (n - 1).bit_length()) if n >= 2 else 2
    tr = np.zeros((NUM_COL_TAPE, ext), dtype=np.uint64)
    for i, c in enumerate(rows):
        tr[COL_TAPE_IS_INIT_SEG][i] = 1 if c.is_init else 0
        tr[COL_TAPE_OPCODE][i] = c.opcode
        tr[COL_TAPE_ADDR][i] = c.addr
        tr[COL_TAPE_VALUE][i] = c.value
        tr[COL_FILTER_LOOKED][i] = c.filter_looked
    if n and n != ext:
        tr[COL_TAPE_TX_IDX][n:] = tr[COL_TAPE_TX_IDX][n - 1]
        tr[COL_TAPE_IS_INIT_SEG][n:] = tr[COL_TAPE_IS_INIT_SEG][n - 1]
        tr[COL_TAPE_OPCODE][n:] = Opcode.TLOAD.mask
        tr[COL_TAPE_ADDR][n:] = tr[COL_TAPE_ADDR][n - 1]
        tr[COL_TAPE_VALUE][n:] = tr[COL_TAPE_VALUE][n - 1]
    elif n == 0:
        tr[COL_TAPE_OPCODE][:] = Opcode.TLOAD.mask
    return tr


class TapeStark(Stark):
    COLUMNS = NUM_COL_TAPE

    def constraint_degree(self):
        return 5

    def eval_packed(self, lv, nv, c):
        F = c.F
        one = F.constant(1)
        tload = F.constant(Opcode.TLOAD.mask)
        tstore = F.constant(Opcode.TSTORE.mask)
        sccall = F.constant(Opcode.SCCALL.mask)

        def m(*terms):
            acc = terms[0]
            for t in terms[1:]:
                acc = F.mul(acc, t)
            return acc

        op = lv[COL_TAPE_OPCODE]
        c.constraint(m(op, F.sub(op, tstore), F.sub(op, tload), F.sub(op, sccall)))
        c.constraint_first_row(lv[COL_TAPE_TX_IDX])
        d_tx = F.sub(nv[COL_TAPE_TX_IDX], lv[COL_TAPE_TX_IDX])
        c.constraint_transition(m(d_tx, F.sub(d_tx, one)))
        same_tx = F.sub(one, d_tx)
        seg = lv[COL_TAPE_IS_INIT_SEG]
        nseg = nv[COL_TAPE_IS_INIT_SEG]
        c.constraint(m(seg, F.sub(one, seg)))
        c.constraint_transition(m(F.sub(one, same_tx), F.sub(one, nseg)))
        c.constraint_transition(
            m(same_tx, F.sub(nseg, seg), F.sub(F.sub(seg, nseg), one))
        )
        c.constraint(m(seg, op, F.sub(op, tload)))
        c.constraint(
            m(F.sub(one, seg), F.sub(op, tload), F.sub(op, tstore), F.sub(op, sccall))
        )
        c.constraint_first_row(lv[COL_TAPE_ADDR])
        d_addr = F.sub(nv[COL_TAPE_ADDR], lv[COL_TAPE_ADDR])
        c.constraint_transition(m(F.sub(one, same_tx), nv[COL_TAPE_ADDR]))
        c.constraint_transition(m(same_tx, d_addr, F.sub(d_addr, one)))
        c.constraint_transition(
            m(same_tx, F.sub(one, d_addr),
              F.sub(nv[COL_TAPE_VALUE], lv[COL_TAPE_VALUE]))
        )
        c.constraint_transition(
            m(same_tx, F.sub(one, d_addr), F.sub(nv[COL_TAPE_OPCODE], tload))
        )
        nop = nv[COL_TAPE_OPCODE]
        c.constraint(
            m(same_tx, d_addr, nop, F.sub(nop, tstore), F.sub(nop, sccall))
        )
        c.constraint(
            m(op, F.sub(op, tload), F.sub(one, lv[COL_FILTER_LOOKED]))
        )


def ctl_data_tape():
    return Column.singles([
        COL_TAPE_TX_IDX, COL_TAPE_OPCODE, COL_TAPE_ADDR, COL_TAPE_VALUE,
    ])


def ctl_filter_tape():
    return Column.single(COL_FILTER_LOOKED)
