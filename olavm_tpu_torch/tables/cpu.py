"""Carried from olavm_tpu/tables/cpu.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

CPU (main) table: columns, trace generation, constraints, CTL views.

Column layout mirrors circuits/src/cpu/columns.rs; trace generation mirrors
circuits/src/generation/cpu.rs; constraints mirror circuits/src/cpu/
cpu_stark.rs:332-959 plus the per-op modules (simple_arithmatic_op, mov,
call, ret, mload, mstore, storage, tape, call_sc).
"""

from __future__ import annotations

import numpy as np

from ..field import goldilocks as gl
from ..isa.opcodes import Opcode
from ..stark.cross_table_lookup import Column
from ..stark.stark_base import Stark

CTX_REGISTER_NUM = 4
REGISTER_NUM = 10

# ----- column indices (columns.rs) -----
COL_TX_IDX = 0
COL_ENV_IDX = 1
COL_CALL_SC_CNT = 2
COL_ADDR_STORAGE = 3  # ..+4
COL_ADDR_CODE = 7  # ..+4
COL_TP = 11
COL_CLK = 12
COL_PC = 13
COL_IS_EXT_LINE = 14
COL_EXT_CNT = 15
COL_START_REG = 16
COL_REGS = list(range(16, 26))
COL_INST = 26
COL_OP1_IMM = 27
COL_OPCODE = 28
COL_IMM_VAL = 29
COL_OP0 = 30
COL_OP1 = 31
COL_DST = 32
COL_AUX0 = 33
COL_AUX1 = 34
COL_IDX_STORAGE = 35
COL_S_OP0_START = 36
COL_S_OP0 = list(range(36, 46))
COL_S_OP1_START = 46
COL_S_OP1 = list(range(46, 56))
COL_S_DST_START = 56
COL_S_DST = list(range(56, 66))
COL_S_SIMPLE_ARITHMATIC_OP = 66
COL_S_MOV = 67
COL_S_JMP = 68
COL_S_CJMP = 69
COL_S_CALL = 70
COL_S_RET = 71
COL_S_MLOAD = 72
COL_S_MSTORE = 73
COL_S_END = 74
COL_S_RC = 75
COL_S_BITWISE = 76
COL_S_NOT = 77
COL_S_GTE = 78
COL_S_PSDN = 79
COL_S_SLOAD = 80
COL_S_SSTORE = 81
COL_S_TLOAD = 82
COL_S_TSTORE = 83
COL_S_CALL_SC = 84
NUM_OP_SELECTOR = COL_S_CALL_SC - COL_S_SIMPLE_ARITHMATIC_OP + 1
COL_IS_ENTRY_SC = 85
COL_IS_NEXT_LINE_DIFF_INST = 86
COL_IS_NEXT_LINE_SAME_TX = 87
COL_FILTER_TAPE_LOOKING = 88
IS_SCCALL_EXT_LINE = 89
COL_IS_STORAGE_EXT_LINE = 90
COL_FILTER_SCCALL_END = 91
COL_FILTER_LOOKING_PROG_IMM = 92
COL_IS_PADDING = 93
NUM_CPU_COLS = 94

_OPCODE_TO_SELECTOR = {}
for _op, _sel in [
    (Opcode.ADD, COL_S_SIMPLE_ARITHMATIC_OP), (Opcode.MUL, COL_S_SIMPLE_ARITHMATIC_OP),
    (Opcode.EQ, COL_S_SIMPLE_ARITHMATIC_OP), (Opcode.ASSERT, COL_S_SIMPLE_ARITHMATIC_OP),
    (Opcode.NEQ, COL_S_SIMPLE_ARITHMATIC_OP), (Opcode.MOV, COL_S_MOV),
    (Opcode.JMP, COL_S_JMP), (Opcode.CJMP, COL_S_CJMP), (Opcode.CALL, COL_S_CALL),
    (Opcode.RET, COL_S_RET), (Opcode.MLOAD, COL_S_MLOAD), (Opcode.MSTORE, COL_S_MSTORE),
    (Opcode.END, COL_S_END), (Opcode.RC, COL_S_RC), (Opcode.AND, COL_S_BITWISE),
    (Opcode.OR, COL_S_BITWISE), (Opcode.XOR, COL_S_BITWISE), (Opcode.NOT, COL_S_NOT),
    (Opcode.GTE, COL_S_GTE), (Opcode.POSEIDON, COL_S_PSDN),
    (Opcode.SLOAD, COL_S_SLOAD), (Opcode.SSTORE, COL_S_SSTORE),
    (Opcode.TLOAD, COL_S_TLOAD), (Opcode.TSTORE, COL_S_TSTORE),
    (Opcode.SCCALL, COL_S_CALL_SC),
]:
    _OPCODE_TO_SELECTOR[_op.mask] = _sel


def generate_cpu_trace(steps) -> np.ndarray:
    """Steps -> (NUM_CPU_COLS, padded_degree) matrix (generation/cpu.rs)."""
    n = len(steps)
    ext_n = max(2, 1 << (n - 1).bit_length()) if n else 2
    tr = np.zeros((NUM_CPU_COLS, ext_n), dtype=np.uint64)

    for i, s in enumerate(steps):
        tr[COL_ENV_IDX][i] = s.env_idx
        tr[COL_CALL_SC_CNT][i] = s.call_sc_cnt
        for j in range(CTX_REGISTER_NUM):
            tr[COL_ADDR_STORAGE + j][i] = s.addr_storage[j]
            tr[COL_ADDR_CODE + j][i] = s.addr_code[j]
        tr[COL_TP][i] = s.tp
        tr[COL_CLK][i] = s.clk
        tr[COL_PC][i] = s.pc
        tr[COL_IS_EXT_LINE][i] = s.is_ext_line
        tr[COL_EXT_CNT][i] = s.ext_cnt
        for j in range(REGISTER_NUM):
            tr[COL_START_REG + j][i] = s.regs[j]
        tr[COL_INST][i] = s.instruction
        tr[COL_OP1_IMM][i] = s.op1_imm
        tr[COL_OPCODE][i] = s.opcode
        tr[COL_IMM_VAL][i] = s.immediate_data
        rs = s.register_selector
        tr[COL_OP0][i] = rs.op0
        tr[COL_OP1][i] = rs.op1
        tr[COL_DST][i] = rs.dst
        tr[COL_AUX0][i] = rs.aux0
        tr[COL_AUX1][i] = rs.aux1
        tr[COL_IDX_STORAGE][i] = s.storage_access_idx
        for j in range(REGISTER_NUM):
            tr[COL_S_OP0_START + j][i] = rs.op0_reg_sel[j]
            tr[COL_S_OP1_START + j][i] = rs.op1_reg_sel[j]
            tr[COL_S_DST_START + j][i] = rs.dst_reg_sel[j]
        sel = _OPCODE_TO_SELECTOR.get(s.opcode)
        if sel is not None:
            tr[sel][i] = 1
        # entry flag feeds END's ext_length (cpu_stark.rs:842-848): the env-0
        # END main line has no ext line; a callee-return END ext line (env
        # patched to the caller's 0) must still count ext_length 1.
        tr[COL_IS_ENTRY_SC][i] = (
            1 if (s.env_idx == 0
                  and not (s.opcode == Opcode.END.mask and s.is_ext_line == 1))
            else 0
        )

        if s.opcode in (Opcode.SLOAD.mask, Opcode.SSTORE.mask, Opcode.SCCALL.mask) or (
            s.opcode == Opcode.END.mask
            and (s.env_idx != 0 or s.is_ext_line == 1)
        ):
            ext_length = 1
        elif s.opcode == Opcode.TLOAD.mask:
            ext_length = rs.op0 * rs.op1 + (1 - rs.op0)
        elif s.opcode == Opcode.TSTORE.mask:
            ext_length = rs.op1
        else:
            ext_length = 0
        tr[COL_IS_NEXT_LINE_DIFF_INST][i] = 1 if ext_length == s.ext_cnt else 0
        tr[COL_IS_NEXT_LINE_SAME_TX][i] = (
            0 if (s.env_idx == 0 and s.opcode == Opcode.END.mask
                  and s.is_ext_line == 0) else 1
        )
        tr[COL_FILTER_TAPE_LOOKING][i] = s.filter_tape_looking
        tr[IS_SCCALL_EXT_LINE][i] = (
            1 if (s.opcode == Opcode.SCCALL.mask and s.ext_cnt == 1) else 0
        )
        tr[COL_IS_STORAGE_EXT_LINE][i] = (
            1
            if (s.opcode in (Opcode.SLOAD.mask, Opcode.SSTORE.mask) and s.is_ext_line == 1)
            else 0
        )
        tr[COL_FILTER_SCCALL_END][i] = (
            1 if (s.opcode == Opcode.END.mask and s.is_ext_line == 1) else 0
        )
        if s.is_ext_line == 1:
            filt_imm = 0
        elif s.opcode in (Opcode.MLOAD.mask, Opcode.MSTORE.mask):
            filt_imm = 1
        elif s.op1_imm == 1:
            filt_imm = 1
        else:
            filt_imm = 0
        tr[COL_FILTER_LOOKING_PROG_IMM][i] = filt_imm

    # padding (generation/cpu.rs:177-210)
    inst_end = tr[COL_INST][n - 1] if n else np.uint64(1048576)
    if n != ext_n:
        tr[COL_TX_IDX][n:] = tr[COL_TX_IDX][n - 1] if n else 0
        tr[COL_INST][n:] = inst_end
        tr[COL_OPCODE][n:] = Opcode.END.mask
        tr[COL_IDX_STORAGE][n:] = tr[COL_IDX_STORAGE][n - 1] if n else 0
        tr[COL_S_END][n:] = 1
        tr[COL_IS_ENTRY_SC][n:] = 1
        tr[COL_IS_NEXT_LINE_DIFF_INST][n:] = 1
        tr[COL_IS_NEXT_LINE_SAME_TX][n:] = 0
        tr[COL_IS_PADDING][n:] = 1
    return tr


class CpuStark(Stark):
    COLUMNS = NUM_CPU_COLS

    def constraint_degree(self):
        return 7

    def eval_packed(self, lv, nv, c):
        F = c.F
        one = F.constant(1)
        regs = [lv[i] for i in COL_REGS]
        n_regs = [nv[i] for i in COL_REGS]
        lv_is_padding = lv[COL_IS_PADDING]
        nv_is_padding = nv[COL_IS_PADDING]
        lv_is_ext_inst = F.add_many([
            lv[COL_S_SLOAD], lv[COL_S_SSTORE], lv[COL_S_TLOAD], lv[COL_S_TSTORE],
            lv[COL_S_CALL_SC], lv[COL_S_END],
        ])
        nv_is_ext_inst = F.add_many([
            nv[COL_S_SLOAD], nv[COL_S_SSTORE], nv[COL_S_TLOAD], nv[COL_S_TSTORE],
            nv[COL_S_CALL_SC], nv[COL_S_END],
        ])
        lv_is_entry_sc = lv[COL_IS_ENTRY_SC]
        lv_ext_length = F.add_many([
            lv[COL_S_SLOAD], lv[COL_S_SSTORE],
            F.mul(lv[COL_S_TLOAD],
                  F.add(F.mul(lv[COL_OP0], lv[COL_OP1]), F.sub(one, lv[COL_OP0]))),
            F.mul(lv[COL_S_TSTORE], lv[COL_OP1]),
            lv[COL_S_CALL_SC],
            F.mul(lv[COL_S_END], F.sub(one, lv_is_entry_sc)),
        ])
        is_crossing_inst = lv[COL_IS_NEXT_LINE_DIFF_INST]
        is_in_same_tx = lv[COL_IS_NEXT_LINE_SAME_TX]

        def m(*terms):
            acc = terms[0]
            for t in terms[1:]:
                acc = F.mul(acc, t)
            return acc

        # ---- wrapper cols (cpu_stark.rs:338-370) ----
        c.constraint(m(lv_is_padding, F.sub(lv_is_padding, one)))
        d = F.sub(nv_is_padding, lv_is_padding)
        c.constraint_transition(m(d, F.sub(d, one)))
        c.constraint(m(lv_is_padding, F.sub(lv[COL_S_END], one)))
        c.constraint(m(lv_is_entry_sc, F.sub(one, lv_is_entry_sc)))
        # bind the flag to env 0 (cpu_stark.rs:353): is_entry_sc may only be
        # set on env-0 rows, so it is not free prover advice for END
        # ext_length / tx_idx gating (the env-0 END ext line keeps flag 0,
        # satisfying flag * env == 0 either way).
        c.constraint(m(lv_is_entry_sc, lv[COL_ENV_IDX]))
        c.constraint(
            m(F.sub(one, nv_is_padding), is_in_same_tx,
              F.sub(nv[COL_TX_IDX], lv[COL_TX_IDX]))
        )
        c.constraint_transition(
            m(F.sub(one, nv_is_padding), F.sub(one, is_in_same_tx),
              F.sub(F.sub(nv[COL_TX_IDX], lv[COL_TX_IDX]), one))
        )
        c.constraint(m(is_crossing_inst, F.sub(lv_ext_length, lv[COL_EXT_CNT])))

        # ---- tx init (cpu_stark.rs:372-404) ----
        c.constraint_first_row(lv[COL_TX_IDX])
        c.constraint_first_row(lv[COL_ENV_IDX])
        c.constraint_first_row(lv[COL_CALL_SC_CNT])
        c.constraint_first_row(lv[COL_CLK])
        c.constraint_first_row(lv[COL_PC])
        for r in COL_REGS:
            c.constraint_first_row(lv[r])
        c.constraint_transition(m(is_in_same_tx, F.sub(nv[COL_TX_IDX], lv[COL_TX_IDX])))
        not_same_tx = F.sub(one, is_in_same_tx)
        c.constraint_transition(m(not_same_tx, nv[COL_ENV_IDX]))
        c.constraint_transition(m(not_same_tx, nv[COL_CALL_SC_CNT]))
        c.constraint_transition(m(not_same_tx, nv[COL_TP]))
        c.constraint_transition(m(not_same_tx, nv[COL_CLK]))
        c.constraint_transition(m(not_same_tx, nv[COL_PC]))
        for r in COL_REGS:
            c.constraint_transition(m(not_same_tx, nv[r]))

        # ---- tx_idx transitions + ctx regs (cpu_stark.rs:886-914) ----
        c.constraint_transition(
            m(F.sub(one, nv_is_padding), F.sub(one, lv[COL_S_END]),
              F.sub(nv[COL_TX_IDX], lv[COL_TX_IDX]))
        )
        c.constraint_transition(
            m(F.sub(one, nv_is_padding), lv_is_entry_sc, lv[COL_S_END],
              F.sub(F.sub(nv[COL_TX_IDX], lv[COL_TX_IDX]), one))
        )
        for j in range(CTX_REGISTER_NUM):
            guard = m(F.sub(one, nv_is_padding), F.sub(one, lv[COL_S_END]),
                      F.sub(one, lv[COL_S_CALL_SC]))
            c.constraint_transition(
                m(guard, F.sub(nv[COL_ADDR_STORAGE + j], lv[COL_ADDR_STORAGE + j]))
            )
            c.constraint_transition(
                m(guard, F.sub(nv[COL_ADDR_CODE + j], lv[COL_ADDR_CODE + j]))
            )
        # filter imm to prog (cpu_stark.rs:916-925)
        main_line = F.sub(F.sub(one, lv[COL_IS_PADDING]), lv[COL_IS_EXT_LINE])
        c.constraint(
            m(main_line, lv[COL_OP1_IMM], F.sub(one, lv[COL_FILTER_LOOKING_PROG_IMM]))
        )
        c.constraint(
            m(main_line, F.add(lv[COL_S_MLOAD], lv[COL_S_MSTORE]),
              F.sub(one, lv[COL_FILTER_LOOKING_PROG_IMM]))
        )

        # ---- ext lines (cpu_stark.rs:650-689) ----
        c.constraint(m(F.sub(one, lv_is_ext_inst), lv[COL_IS_EXT_LINE]))
        c.constraint(
            m(lv_is_ext_inst, F.sub(lv_ext_length, lv[COL_EXT_CNT]),
              F.sub(one, nv[COL_IS_EXT_LINE]))
        )
        c.constraint(m(lv_is_ext_inst, F.sub(one, lv[COL_IS_EXT_LINE]), lv[COL_EXT_CNT]))
        c.constraint(
            m(nv_is_ext_inst, nv[COL_IS_EXT_LINE],
              F.sub(F.sub(nv[COL_EXT_CNT], lv[COL_EXT_CNT]), one))
        )
        c.constraint(m(nv[COL_IS_EXT_LINE], F.sub(nv[COL_OPCODE], lv[COL_OPCODE])))
        for col in range(COL_S_SIMPLE_ARITHMATIC_OP,
                         COL_S_SIMPLE_ARITHMATIC_OP + NUM_OP_SELECTOR):
            c.constraint(m(nv[COL_IS_EXT_LINE], F.sub(nv[col], lv[col])))
        c.constraint(m(nv[COL_IS_EXT_LINE], F.sub(nv[COL_OP1_IMM], lv[COL_OP1_IMM])))

        # ---- env idx (cpu_stark.rs:406-454) ----
        c.constraint_transition(
            m(lv[COL_S_CALL_SC], is_crossing_inst,
              F.sub(F.sub(nv[COL_CALL_SC_CNT], lv[COL_CALL_SC_CNT]), one))
        )
        c.constraint_transition(
            m(is_in_same_tx, F.sub(one, lv[COL_S_CALL_SC]),
              F.sub(nv[COL_CALL_SC_CNT], lv[COL_CALL_SC_CNT]))
        )
        c.constraint(
            m(lv[COL_S_CALL_SC], F.sub(one, is_crossing_inst),
              F.sub(nv[COL_CALL_SC_CNT], lv[COL_CALL_SC_CNT]))
        )
        # callee env = caller's call_sc_cnt + 1 (= nv[COL_CALL_SC_CNT]);
        # the reference writes nv_env - lv_cnt (cpu_stark.rs:433-437) which
        # contradicts its own executor numbering (env = global sc counter)
        c.constraint(
            m(lv[COL_S_CALL_SC], is_crossing_inst,
              F.sub(F.sub(nv[COL_ENV_IDX], lv[COL_CALL_SC_CNT]), one))
        )
        c.constraint(
            m(F.sub(F.sub(one, lv[COL_S_CALL_SC]), lv[COL_S_END]),
              F.sub(nv[COL_ENV_IDX], lv[COL_ENV_IDX]))
        )
        c.constraint(
            m(lv[COL_S_CALL_SC], F.sub(one, is_crossing_inst),
              F.sub(nv[COL_ENV_IDX], lv[COL_ENV_IDX]))
        )
        c.constraint(
            m(lv[COL_S_END], lv[COL_IS_EXT_LINE],
              F.sub(nv[COL_ENV_IDX], lv[COL_ENV_IDX]))
        )

        # ---- opcode selectors (cpu_stark.rs:456-523) ----
        ops_to_op = [
            (lv[COL_S_SIMPLE_ARITHMATIC_OP], 0),
            (lv[COL_S_MOV], Opcode.MOV.mask), (lv[COL_S_JMP], Opcode.JMP.mask),
            (lv[COL_S_CJMP], Opcode.CJMP.mask), (lv[COL_S_CALL], Opcode.CALL.mask),
            (lv[COL_S_RET], Opcode.RET.mask), (lv[COL_S_MLOAD], Opcode.MLOAD.mask),
            (lv[COL_S_MSTORE], Opcode.MSTORE.mask), (lv[COL_S_END], Opcode.END.mask),
            (lv[COL_S_RC], Opcode.RC.mask), (lv[COL_S_BITWISE], 0),
            (lv[COL_S_NOT], Opcode.NOT.mask), (lv[COL_S_GTE], Opcode.GTE.mask),
            (lv[COL_S_PSDN], Opcode.POSEIDON.mask),
            (lv[COL_S_SLOAD], Opcode.SLOAD.mask),
            (lv[COL_S_SSTORE], Opcode.SSTORE.mask),
            (lv[COL_S_TLOAD], Opcode.TLOAD.mask),
            (lv[COL_S_TSTORE], Opcode.TSTORE.mask),
            (lv[COL_S_CALL_SC], Opcode.SCCALL.mask),
        ]
        c.constraint(m(
            lv[COL_S_SIMPLE_ARITHMATIC_OP],
            F.sub(lv[COL_OPCODE], F.constant(Opcode.ADD.mask)),
            F.sub(lv[COL_OPCODE], F.constant(Opcode.MUL.mask)),
            F.sub(lv[COL_OPCODE], F.constant(Opcode.EQ.mask)),
            F.sub(lv[COL_OPCODE], F.constant(Opcode.NEQ.mask)),
            F.sub(lv[COL_OPCODE], F.constant(Opcode.ASSERT.mask)),
        ))
        c.constraint(m(
            lv[COL_S_BITWISE],
            F.sub(lv[COL_OPCODE], F.constant(Opcode.AND.mask)),
            F.sub(lv[COL_OPCODE], F.constant(Opcode.OR.mask)),
            F.sub(lv[COL_OPCODE], F.constant(Opcode.XOR.mask)),
        ))
        for s, _ in ops_to_op:
            c.constraint(m(s, F.sub(one, s)))
        sum_s_op = F.add_many([s for s, _ in ops_to_op])
        c.constraint(F.sub(one, sum_s_op))
        cal_opcode = F.add_many(
            [F.scalar_mul(s, op) for s, op in ops_to_op]
        )
        c.constraint(m(
            F.sub(lv[COL_OPCODE], cal_opcode),
            F.sub(F.sub(one, lv[COL_S_BITWISE]), lv[COL_S_SIMPLE_ARITHMATIC_OP]),
        ))

        # ---- instruction encoding (cpu_stark.rs:525-575) ----
        c.constraint(m(lv[COL_OP1_IMM], F.sub(one, lv[COL_OP1_IMM])))
        instruction = F.scalar_mul(lv[COL_OP1_IMM], 1 << 62)
        for index in range(REGISTER_NUM):
            # iterate rev: s_op0s[9-index] with shift 2^61 >> index
            instruction = F.add(
                instruction,
                F.scalar_mul(lv[COL_S_OP0[REGISTER_NUM - 1 - index]], 1 << (61 - index)),
            )
            instruction = F.add(
                instruction,
                F.scalar_mul(lv[COL_S_OP1[REGISTER_NUM - 1 - index]], 1 << (51 - index)),
            )
            instruction = F.add(
                instruction,
                F.scalar_mul(lv[COL_S_DST[REGISTER_NUM - 1 - index]], 1 << (41 - index)),
            )
        instruction = F.add(instruction, lv[COL_OPCODE])
        not_ext = F.sub(one, lv[COL_IS_EXT_LINE])
        c.constraint(m(not_ext, F.sub(lv[COL_INST], instruction)))
        c.constraint(m(not_ext, lv[COL_OP1_IMM], F.sub(lv[COL_OP1], lv[COL_IMM_VAL])))

        # ---- operands match registers (cpu_stark.rs:577-648) ----
        s_op0s = [lv[i] for i in COL_S_OP0]
        s_op1s = [lv[i] for i in COL_S_OP1]
        s_dsts = [lv[i] for i in COL_S_DST]
        for s in s_op0s + s_op1s + s_dsts:
            c.constraint(m(not_ext, s, F.sub(one, s)))
        sum_s_op0 = F.add_many(s_op0s)
        sum_s_op1 = F.add_many(s_op1s)
        sum_s_dst = F.add_many(s_dsts)
        c.constraint(m(not_ext, sum_s_op0, F.sub(one, sum_s_op0)))
        c.constraint(m(not_ext, sum_s_op1, F.sub(one, sum_s_op1)))
        c.constraint(m(not_ext, sum_s_dst, F.sub(one, sum_s_dst)))
        op0_sum = F.add_many([F.mul(s, r) for s, r in zip(s_op0s, regs)])
        c.constraint(m(not_ext, sum_s_op0, F.sub(lv[COL_OP0], op0_sum)))
        op1_sum = F.add_many([F.mul(s, r) for s, r in zip(s_op1s, regs)])
        c.constraint(m(not_ext, sum_s_op1, F.sub(lv[COL_OP1], op1_sum)))
        dst_sum = F.add_many([F.mul(s, r) for s, r in zip(s_dsts, n_regs)])
        c.constraint(m(not_ext, sum_s_dst, F.sub(lv[COL_DST], dst_sum)))

        # ---- clk (cpu_stark.rs:691-711) ----
        c.constraint(
            m(nv[COL_IS_EXT_LINE], F.sub(one, nv[COL_S_END]),
              F.sub(nv[COL_CLK], lv[COL_CLK]))
        )
        c.constraint(
            m(is_in_same_tx,
              F.sub(F.sub(one, lv[COL_S_CALL_SC]), lv[COL_S_END]),
              F.sub(one, nv[COL_IS_EXT_LINE]),
              F.sub(F.sub(nv[COL_CLK], lv[COL_CLK]), one))
        )

        # ---- pc (cpu_stark.rs:713-755) ----
        c.constraint(
            m(nv[COL_IS_EXT_LINE], F.sub(one, nv[COL_S_END]),
              F.sub(nv[COL_CLK], lv[COL_CLK]))
        )
        is_mem = F.add(lv[COL_S_MLOAD], lv[COL_S_MSTORE])
        instruction_size = F.add(
            F.mul(F.sub(one, is_mem), F.add(one, lv[COL_OP1_IMM])),
            F.scalar_mul(is_mem, 2),
        )
        pc_plus = F.add(lv[COL_PC], instruction_size)
        no_jump = F.sub(one, F.add_many([
            lv[COL_S_JMP], lv[COL_S_CJMP], lv[COL_S_CALL], lv[COL_S_RET]
        ]))
        pc_incr = F.mul(no_jump, pc_plus)
        pc_jmp = F.mul(lv[COL_S_JMP], lv[COL_OP1])
        pc_cjmp = F.mul(
            lv[COL_S_CJMP],
            F.add(F.mul(F.sub(one, lv[COL_OP0]), pc_plus),
                  F.mul(lv[COL_OP0], lv[COL_OP1])),
        )
        pc_call = F.mul(lv[COL_S_CALL], lv[COL_OP1])
        pc_ret = F.mul(lv[COL_S_RET], lv[COL_DST])
        pc_expected = F.add_many([pc_incr, pc_jmp, pc_cjmp, pc_call, pc_ret])
        c.constraint(
            m(F.sub(one, nv[COL_IS_EXT_LINE]),
              F.sub(F.sub(one, lv[COL_S_END]), lv[COL_S_CALL_SC]),
              F.sub(nv[COL_PC], pc_expected))
        )
        c.constraint(
            m(F.sub(one, nv[COL_IS_EXT_LINE]), lv[COL_S_CJMP], lv[COL_OP0],
              F.sub(one, lv[COL_OP0]))
        )

        # ---- register consistency (cpu_stark.rs:757-789) ----
        multi_reg_change = F.add_many([
            lv[COL_S_SLOAD], lv[COL_S_PSDN],
            F.mul(lv[COL_S_CALL_SC], is_crossing_inst),
            F.mul(lv[COL_S_END], F.sub(one, lv[COL_IS_EXT_LINE])),
        ])
        for j in range(REGISTER_NUM - 1):
            c.constraint_transition(
                m(F.sub(one, multi_reg_change), F.sub(one, s_dsts[j]),
                  F.sub(n_regs[j], regs[j]))
            )
        fp_guard = F.sub(
            F.sub(F.sub(one, lv[COL_S_RET]),
                  F.mul(lv[COL_S_CALL_SC], is_crossing_inst)),
            lv[COL_S_END],
        )
        c.constraint_transition(
            m(fp_guard, F.sub(one, s_dsts[REGISTER_NUM - 1]),
              F.sub(n_regs[REGISTER_NUM - 1], regs[REGISTER_NUM - 1]))
        )

        # ---- per-op modules ----
        self._eval_simple_arith(lv, c, m, F, one)
        c.constraint(m(lv[COL_S_MOV], F.sub(lv[COL_DST], lv[COL_OP1])))
        self._eval_call_ret(lv, nv, c, m, F, one)
        self._eval_mem_ops(lv, c, m, F, one)
        self._eval_storage(lv, nv, c, m, F, one)
        self._eval_tape(lv, nv, c, m, F, one, is_in_same_tx)
        self._eval_call_sc(lv, nv, c, m, F, one, is_crossing_inst)

    def _eval_simple_arith(self, lv, c, m, F, one):
        def diffs(*excl):
            return [F.sub(lv[COL_OPCODE], F.constant(op.mask)) for op in excl]

        ops = (Opcode.ADD, Opcode.MUL, Opcode.EQ, Opcode.NEQ, Opcode.ASSERT)
        sel = {}
        for target in ops:
            others = [o for o in ops if o != target]
            sel[target] = m(lv[COL_S_SIMPLE_ARITHMATIC_OP], *diffs(*others))
        c.constraint(m(sel[Opcode.ADD],
                       F.sub(lv[COL_DST], F.add(lv[COL_OP0], lv[COL_OP1]))))
        c.constraint(m(sel[Opcode.MUL],
                       F.sub(lv[COL_DST], F.mul(lv[COL_OP0], lv[COL_OP1]))))
        op_diff = F.sub(lv[COL_OP0], lv[COL_OP1])
        diff_aux = F.mul(op_diff, lv[COL_AUX0])
        res = lv[COL_DST]
        eq_cs = F.mul(sel[Opcode.EQ], F.add(
            F.mul(res, op_diff), F.mul(F.sub(one, res), F.sub(one, diff_aux))
        ))
        neq_cs = F.mul(sel[Opcode.NEQ], F.add(
            F.mul(F.sub(one, res), op_diff), F.mul(res, F.sub(one, diff_aux))
        ))
        c.constraint(F.add(eq_cs, neq_cs))
        c.constraint(m(sel[Opcode.ASSERT], F.sub(one, lv[COL_OP1])))

    def _eval_call_ret(self, lv, nv, c, m, F, one):
        two = F.constant(2)
        fp = lv[COL_REGS[-1]]
        op0_cs = F.sub(F.add(lv[COL_OP0], one), fp)
        op1_cs = F.add(
            F.mul(lv[COL_OP1_IMM],
                  F.sub(F.sub(lv[COL_DST], lv[COL_PC]), two)),
            F.mul(F.sub(one, lv[COL_OP1_IMM]),
                  F.sub(F.sub(lv[COL_DST], lv[COL_PC]), one)),
        )
        aux0_cs = F.add(F.sub(lv[COL_AUX0], fp), two)
        c.constraint(m(lv[COL_S_CALL], F.add_many([op0_cs, op1_cs, aux0_cs])))

        r_op0_cs = F.sub(F.add(lv[COL_OP0], one), fp)
        r_dst_cs = F.sub(lv[COL_DST], nv[COL_PC])
        r_aux0_cs = F.sub(F.add(F.add(lv[COL_AUX0], one), one), fp)
        c.constraint(m(lv[COL_S_RET], F.add_many([r_op0_cs, r_dst_cs, r_aux0_cs])))
        c.constraint_transition(
            m(lv[COL_S_RET], F.sub(nv[COL_REGS[-1]], lv[COL_AUX1]))
        )

    def _eval_mem_ops(self, lv, c, m, F, one):
        for s_col in (COL_S_MLOAD, COL_S_MSTORE):
            s = lv[s_col]
            not_imm = F.sub(one, lv[COL_OP1_IMM])
            c.constraint(m(s, not_imm, F.sub(lv[COL_AUX0], lv[COL_IMM_VAL])))
            c.constraint(
                m(s, lv[COL_OP1_IMM],
                  F.sub(F.sub(lv[COL_AUX1], lv[COL_OP0]), lv[COL_OP1]))
            )
            c.constraint(
                m(s, not_imm,
                  F.sub(F.sub(lv[COL_AUX1], lv[COL_OP0]),
                        F.mul(lv[COL_AUX0], lv[COL_OP1])))
            )

    def _eval_storage(self, lv, nv, c, m, F, one):
        s_storage = F.add(lv[COL_S_SSTORE], lv[COL_S_SLOAD])
        c.constraint_first_row(F.sub(lv[COL_IDX_STORAGE], s_storage))
        c.constraint_transition(
            F.sub(F.sub(nv[COL_IDX_STORAGE], lv[COL_IDX_STORAGE]),
                  nv[COL_IS_STORAGE_EXT_LINE])
        )
        not_ext = F.sub(one, lv[COL_IS_EXT_LINE])
        c.constraint(m(s_storage, not_ext, F.sub(nv[COL_OP0], lv[COL_OP0])))
        c.constraint(m(s_storage, not_ext, F.sub(nv[COL_OP1], lv[COL_OP1])))
        ext = lv[COL_IS_EXT_LINE]
        c.constraint(m(s_storage, ext, F.sub(lv[COL_S_OP0[0]], lv[COL_OP0])))
        for i in range(3):
            c.constraint(
                m(s_storage, ext,
                  F.sub(F.sub(lv[COL_S_OP0[i + 1]], lv[COL_S_OP0[i]]), one))
            )
        c.constraint(m(s_storage, ext, F.sub(lv[COL_S_OP1[0]], lv[COL_OP1])))
        for i in range(3):
            c.constraint(
                m(s_storage, ext,
                  F.sub(F.sub(lv[COL_S_OP1[i + 1]], lv[COL_S_OP1[i]]), one))
            )
        c.constraint(m(s_storage, ext, F.sub(one, lv[COL_IS_STORAGE_EXT_LINE])))
        c.constraint(m(F.sub(one, s_storage), lv[COL_IS_STORAGE_EXT_LINE]))
        c.constraint(m(s_storage, not_ext, lv[COL_IS_STORAGE_EXT_LINE]))

    def _eval_tape(self, lv, nv, c, m, F, one, is_in_same_tx):
        nv_tape = F.add(nv[COL_S_TSTORE], nv[COL_S_TLOAD])
        lv_tape = F.add(lv[COL_S_TSTORE], lv[COL_S_TLOAD])
        c.constraint(m(nv_tape, nv[COL_IS_EXT_LINE], F.sub(nv[COL_OP0], lv[COL_OP0])))
        c.constraint(m(nv_tape, nv[COL_IS_EXT_LINE], F.sub(nv[COL_OP1], lv[COL_OP1])))
        c.constraint(
            m(lv_tape, lv[COL_IS_EXT_LINE], nv[COL_IS_EXT_LINE],
              F.sub(F.sub(nv[COL_AUX0], lv[COL_AUX0]), one))
        )
        not_ext = F.sub(one, lv[COL_IS_EXT_LINE])
        c.constraint(
            m(lv[COL_S_TSTORE], not_ext, F.sub(lv[COL_TP], nv[COL_S_OP0[0]]))
        )
        c.constraint(
            m(lv[COL_S_TSTORE], lv[COL_IS_EXT_LINE], nv[COL_IS_EXT_LINE],
              F.sub(F.sub(nv[COL_S_OP0[0]], lv[COL_S_OP0[0]]), one))
        )
        c.constraint(
            m(lv[COL_S_TSTORE], F.sub(one, nv[COL_IS_EXT_LINE]),
              F.sub(F.sub(nv[COL_TP], lv[COL_S_OP0[0]]), one))
        )
        c.constraint(
            m(lv[COL_S_TLOAD], lv[COL_OP0], not_ext,
              F.sub(F.add(nv[COL_S_OP0[0]], lv[COL_OP1]), lv[COL_TP]))
        )
        c.constraint(
            m(lv[COL_S_TLOAD], F.sub(one, lv[COL_OP0]), not_ext,
              F.sub(nv[COL_S_OP0[0]], lv[COL_OP1]))
        )
        c.constraint(
            m(lv_tape, lv[COL_IS_EXT_LINE], nv[COL_IS_EXT_LINE],
              F.sub(F.sub(nv[COL_S_OP0[0]], lv[COL_S_OP0[0]]), one))
        )
        c.constraint(
            m(lv[COL_S_TSTORE], not_ext, F.sub(lv[COL_OP0], nv[COL_AUX0]))
        )
        c.constraint(
            m(lv[COL_S_TLOAD], not_ext, F.sub(lv[COL_DST], nv[COL_AUX0]))
        )
        # tp unchanged unless tstore last-ext, sccall ext crossing, or the
        # row before an sccall main. The reference's sum guard
        # (1 - lv_tstore - nv_call_sc) (cpu/tape.rs:97-101) is -1 when a
        # tstore ext is immediately followed by an sccall and misses the
        # sccall-ext -> callee (+12) jump; use a product guard instead.
        c.constraint(
            m(is_in_same_tx,
              F.sub(one, lv[COL_S_TSTORE]),
              F.sub(one, nv[COL_S_CALL_SC]),
              F.sub(one, lv[COL_S_CALL_SC]),
              F.sub(nv[COL_TP], lv[COL_TP]))
        )
        c.constraint(
            m(lv[COL_S_TSTORE], nv[COL_IS_EXT_LINE], F.sub(nv[COL_TP], lv[COL_TP]))
        )
        c.constraint(
            m(lv[COL_S_TSTORE], F.sub(one, nv[COL_IS_EXT_LINE]),
              F.sub(F.sub(nv[COL_TP], lv[COL_S_OP0[0]]), one))
        )
        # entering an sccall main line tp is unchanged — unless the previous
        # instruction was a tstore whose last ext line advances tp
        c.constraint(
            m(F.sub(one, lv[COL_S_CALL_SC]), F.sub(one, lv[COL_S_TSTORE]),
              nv[COL_S_CALL_SC], F.sub(nv[COL_TP], lv[COL_TP]))
        )
        c.constraint(
            m(lv[COL_S_CALL_SC], not_ext, F.sub(nv[COL_TP], lv[COL_TP]))
        )
        c.constraint(
            m(lv[COL_S_CALL_SC], lv[COL_IS_EXT_LINE],
              F.sub(F.sub(nv[COL_TP], lv[COL_TP]), F.constant(12)))
        )
        filt = lv[COL_FILTER_TAPE_LOOKING]
        c.constraint(m(filt, F.sub(one, filt)))
        c.constraint(m(filt, F.sub(F.sub(one, lv[COL_S_TLOAD]), lv[COL_S_TSTORE])))
        c.constraint(m(filt, F.sub(one, lv[COL_IS_EXT_LINE])))
        c.constraint(m(lv_tape, lv[COL_IS_EXT_LINE], F.sub(one, filt)))

    def _eval_call_sc(self, lv, nv, c, m, F, one, is_crossing_inst):
        not_ext = F.sub(one, lv[COL_IS_EXT_LINE])
        for i in range(4):
            c.constraint(
                m(lv[COL_S_CALL_SC], not_ext,
                  F.sub(nv[COL_S_OP0[i]], lv[COL_ADDR_STORAGE + i]))
            )
            c.constraint(
                m(lv[COL_S_CALL_SC], not_ext,
                  F.sub(nv[COL_S_OP0[4 + i]], lv[COL_ADDR_CODE + i]))
            )
        c.constraint(m(lv[COL_S_CALL_SC], not_ext, F.sub(nv[COL_OP0], lv[COL_OP0])))
        c.constraint(m(lv[COL_S_CALL_SC], not_ext, F.sub(nv[COL_OP1], lv[COL_OP1])))
        not_crossing = F.sub(one, is_crossing_inst)
        c.constraint_transition(
            m(lv[COL_S_END], not_crossing, F.sub(lv[COL_ENV_IDX], nv[COL_AUX0]))
        )
        c.constraint_transition(
            m(lv[COL_S_END], not_crossing, F.sub(lv[COL_CLK], nv[COL_AUX1]))
        )
        c.constraint(m(lv[COL_S_CALL_SC], is_crossing_inst, nv[COL_CLK]))
        c.constraint(m(lv[COL_S_CALL_SC], is_crossing_inst, nv[COL_PC]))
        for i in range(REGISTER_NUM):
            c.constraint(m(lv[COL_S_CALL_SC], is_crossing_inst, nv[COL_REGS[i]]))
        for j in range(CTX_REGISTER_NUM):
            c.constraint(
                m(lv[COL_S_CALL_SC], is_crossing_inst,
                  F.sub(nv[COL_ADDR_STORAGE + j], lv[COL_ADDR_STORAGE + j]))
            )
            c.constraint(
                m(lv[COL_S_CALL_SC], is_crossing_inst,
                  F.sub(nv[COL_ADDR_CODE + j], lv[COL_ADDR_CODE + j]))
            )
        c.constraint(
            m(lv[COL_S_END], lv[COL_IS_EXT_LINE], not_crossing,
              F.sub(nv[COL_PC], lv[COL_PC]))
        )
        c.constraint(
            m(lv[COL_S_END], lv[COL_IS_EXT_LINE], not_crossing,
              F.sub(nv[COL_CLK], lv[COL_CLK]))
        )
        sc_ext = lv[IS_SCCALL_EXT_LINE]
        c.constraint(m(sc_ext, F.sub(one, sc_ext)))
        c.constraint(m(F.sub(one, lv[COL_S_CALL_SC]), sc_ext))
        c.constraint(m(lv[COL_S_CALL_SC], lv[COL_IS_EXT_LINE], F.sub(one, sc_ext)))
        c.constraint(m(lv[COL_S_CALL_SC], not_ext, sc_ext))
        fse = lv[COL_FILTER_SCCALL_END]
        c.constraint(m(fse, F.sub(one, fse)))
        c.constraint(m(F.sub(one, lv[COL_S_END]), fse))
        c.constraint(m(lv[COL_S_END], not_ext, fse))
        c.constraint(m(lv[COL_S_END], lv[COL_IS_EXT_LINE], F.sub(one, fse)))
