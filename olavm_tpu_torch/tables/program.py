"""Carried from olavm_tpu/tables/program.py: the card has no jax, so this copy imports
only jax-free modules; its code is unchanged.

Program + ProgChunk tables (circuits/src/program/): the program ROM with
a compress challenge (derived from the start/end storage roots), and the
rate-8 chunking of program words for Poseidon program hashing."""

from __future__ import annotations

import numpy as np

from ..field import goldilocks as gl
from ..hash import poseidon as pos
from ..isa.opcodes import Opcode
from ..stark.challenger import Challenger
from ..stark.cross_table_lookup import Column
from ..stark.lookup import eval_lookups, permuted_cols
from ..stark.stark_base import PermutationPair, Stark

# ----- Program table (columns.rs) -----
COL_PROG_CODE_ADDR = list(range(0, 4))
COL_PROG_PC = 4
COL_PROG_INST = 5
COL_PROG_COMP_PROG = 6
COL_PROG_COMP_PROG_PERM = 7
COL_PROG_EXEC_CODE_ADDR = list(range(8, 12))
COL_PROG_EXEC_PC = 12
COL_PROG_EXEC_INST = 13
COL_PROG_EXEC_COMP_PROG = 14
COL_PROG_EXEC_COMP_PROG_PERM = 15
COL_PROG_FILTER_EXEC = 16
COL_PROG_FILTER_PROG_CHUNK = 17
NUM_PROG_COLS = 18


def _compress6(vals, beta):
    acc = np.zeros_like(vals[0])
    for v in reversed(vals):
        acc = gl.add_arr(gl.mul_arr(acc, np.uint64(beta)), v)
    return acc


def generate_prog_trace(execs, progs, start_end_roots):
    """execs: Steps; progs: list of (addr4, [inst words]);
    start_end_roots: (root4, root4). Returns (trace, beta)."""
    challenger = Challenger()
    for j in range(4):
        challenger.observe_element(int(start_end_roots[0][j]))
        challenger.observe_element(int(start_end_roots[1][j]))
    beta = challenger.get_challenge()

    main_lines = [e for e in execs if e.is_ext_line == 0]
    exec_len = sum(
        2
        if (e.op1_imm == 1 or e.opcode in (Opcode.MLOAD.mask, Opcode.MSTORE.mask))
        else 1
        for e in main_lines
    )
    progs_total = sum(len(p[1]) for p in progs)
    n = max(exec_len, progs_total)
    ext = max(2, 1 << (n - 1).bit_length()) if n >= 2 else 2
    tr = np.zeros((NUM_PROG_COLS, ext), dtype=np.uint64)

    idx = 0
    for e in main_lines:
        for j in range(4):
            tr[COL_PROG_EXEC_CODE_ADDR[j]][idx] = e.addr_code[j]
        tr[COL_PROG_EXEC_PC][idx] = e.pc
        tr[COL_PROG_EXEC_INST][idx] = e.instruction
        tr[COL_PROG_FILTER_EXEC][idx] = 1
        idx += 1
        if e.op1_imm == 1 or e.opcode in (Opcode.MLOAD.mask, Opcode.MSTORE.mask):
            for j in range(4):
                tr[COL_PROG_EXEC_CODE_ADDR[j]][idx] = e.addr_code[j]
            tr[COL_PROG_EXEC_PC][idx] = e.pc + 1
            tr[COL_PROG_EXEC_INST][idx] = e.immediate_data
            tr[COL_PROG_FILTER_EXEC][idx] = 1
            idx += 1
    tr[COL_PROG_EXEC_COMP_PROG] = _compress6(
        [tr[COL_PROG_EXEC_CODE_ADDR[0]], tr[COL_PROG_EXEC_CODE_ADDR[1]],
         tr[COL_PROG_EXEC_CODE_ADDR[2]], tr[COL_PROG_EXEC_CODE_ADDR[3]],
         tr[COL_PROG_EXEC_PC], tr[COL_PROG_EXEC_INST]],
        beta,
    )
    # zero out compress on empty exec rows to match row-by-row construction
    tr[COL_PROG_EXEC_COMP_PROG][idx:] = 0

    pidx = 0
    for addr, insts in progs:
        for pc, inst in enumerate(insts):
            for j in range(4):
                tr[COL_PROG_CODE_ADDR[j]][pidx] = addr[j]
            tr[COL_PROG_PC][pidx] = pc
            tr[COL_PROG_INST][pidx] = inst
            tr[COL_PROG_FILTER_PROG_CHUNK][pidx] = 1
            pidx += 1
    comp = _compress6(
        [tr[COL_PROG_CODE_ADDR[0]], tr[COL_PROG_CODE_ADDR[1]],
         tr[COL_PROG_CODE_ADDR[2]], tr[COL_PROG_CODE_ADDR[3]],
         tr[COL_PROG_PC], tr[COL_PROG_INST]],
        beta,
    )
    comp[pidx:] = 0
    tr[COL_PROG_COMP_PROG] = comp

    tr[COL_PROG_EXEC_COMP_PROG_PERM], tr[COL_PROG_COMP_PROG_PERM] = permuted_cols(
        tr[COL_PROG_EXEC_COMP_PROG], tr[COL_PROG_COMP_PROG]
    )
    return tr, beta


class ProgramStark(Stark):
    COLUMNS = NUM_PROG_COLS

    def __init__(self):
        self.compress_challenge = None

    def constraint_degree(self):
        return 3

    def eval_packed(self, lv, nv, c):
        F = c.F
        beta = int(self.compress_challenge)
        pw = [1]
        for _ in range(5):
            pw.append(gl.mul(pw[-1], beta))
        for (addr_cols, pc_col, inst_col, comp_col) in (
            (COL_PROG_CODE_ADDR, COL_PROG_PC, COL_PROG_INST, COL_PROG_COMP_PROG),
            (COL_PROG_EXEC_CODE_ADDR, COL_PROG_EXEC_PC, COL_PROG_EXEC_INST,
             COL_PROG_EXEC_COMP_PROG),
        ):
            acc = F.add_many([
                F.scalar_mul(lv[addr_cols[0]], pw[0]),
                F.scalar_mul(lv[addr_cols[1]], pw[1]),
                F.scalar_mul(lv[addr_cols[2]], pw[2]),
                F.scalar_mul(lv[addr_cols[3]], pw[3]),
                F.scalar_mul(lv[pc_col], pw[4]),
                F.scalar_mul(lv[inst_col], pw[5]),
            ])
            c.constraint(F.sub(acc, lv[comp_col]))
        eval_lookups(lv, nv, c, COL_PROG_EXEC_COMP_PROG_PERM, COL_PROG_COMP_PROG_PERM)

    def permutation_pairs(self):
        return [
            PermutationPair.singletons(COL_PROG_COMP_PROG, COL_PROG_COMP_PROG_PERM),
            PermutationPair.singletons(
                COL_PROG_EXEC_COMP_PROG, COL_PROG_EXEC_COMP_PROG_PERM
            ),
        ]


def ctl_data_by_cpu():
    return Column.singles(COL_PROG_EXEC_CODE_ADDR + [COL_PROG_EXEC_PC, COL_PROG_EXEC_INST])


def ctl_filter_by_cpu():
    return Column.single(COL_PROG_FILTER_EXEC)


def ctl_data_by_program_chunk():
    return Column.singles(COL_PROG_CODE_ADDR + [COL_PROG_PC, COL_PROG_INST])


def ctl_filter_by_program_chunk():
    return Column.single(COL_PROG_FILTER_PROG_CHUNK)


# ----- ProgChunk table -----
COL_PROG_CHUNK_CODE_ADDR = list(range(0, 4))
COL_PROG_CHUNK_START_PC = 4
COL_PROG_CHUNK_INST = list(range(5, 13))
COL_PROG_CHUNK_CAP = list(range(13, 17))
COL_PROG_CHUNK_HASH = list(range(17, 29))
COL_PROG_CHUNK_IS_FIRST_LINE = 29
COL_PROG_CHUNK_IS_RESULT_LINE = 30
COL_PROG_CHUNK_FILTER_LOOKING_PROG = list(range(31, 39))
COL_PROG_CHUNK_IS_PADDING_LINE = 39
NUM_PROG_CHUNK_COLS = 40


def generate_prog_chunk_trace(progs) -> np.ndarray:
    entries = []
    for addr, insts in progs:
        chunks = [insts[i : i + 8] for i in range(0, len(insts), 8)]
        for ci, chunk in enumerate(chunks):
            entries.append(
                (addr, ci * 8, chunk, ci == 0, ci == len(chunks) - 1)
            )
    n = len(entries)
    ext = max(2, 1 << (n - 1).bit_length()) if n >= 2 else 2
    tr = np.zeros((NUM_PROG_CHUNK_COLS, ext), dtype=np.uint64)
    pre_hash = np.zeros(12, dtype=np.uint64)
    for i, (addr, start_pc, chunk, first, result) in enumerate(entries):
        if first:  # sponge state resets per program
            pre_hash = np.zeros(12, dtype=np.uint64)
        for j in range(4):
            tr[COL_PROG_CHUNK_CODE_ADDR[j]][i] = addr[j]
        tr[COL_PROG_CHUNK_START_PC][i] = start_pc
        state = np.zeros(12, dtype=np.uint64)
        for j in range(len(chunk)):
            state[j] = chunk[j]
            tr[COL_PROG_CHUNK_INST[j]][i] = chunk[j]
        for j in range(len(chunk), 8):
            state[j] = pre_hash[j]
            tr[COL_PROG_CHUNK_INST[j]][i] = pre_hash[j]
        for j in range(4):
            state[8 + j] = pre_hash[8 + j]
            tr[COL_PROG_CHUNK_CAP[j]][i] = pre_hash[8 + j]
        out = pos.permute_np(state)
        for j in range(12):
            tr[COL_PROG_CHUNK_HASH[j]][i] = out[j]
        pre_hash = out
        tr[COL_PROG_CHUNK_IS_FIRST_LINE][i] = 1 if first else 0
        tr[COL_PROG_CHUNK_IS_RESULT_LINE][i] = 1 if result else 0
        for j in range(len(chunk)):
            tr[COL_PROG_CHUNK_FILTER_LOOKING_PROG[j]][i] = 1
    if n != ext:
        tr[COL_PROG_CHUNK_IS_PADDING_LINE][n:] = 1
    return tr


class ProgChunkStark(Stark):
    COLUMNS = NUM_PROG_CHUNK_COLS

    def constraint_degree(self):
        return 4

    def eval_packed(self, lv, nv, c):
        F = c.F
        one = F.constant(1)

        def m(*terms):
            acc = terms[0]
            for t in terms[1:]:
                acc = F.mul(acc, t)
            return acc

        lp = lv[COL_PROG_CHUNK_IS_PADDING_LINE]
        np_ = nv[COL_PROG_CHUNK_IS_PADDING_LINE]
        lfirst = lv[COL_PROG_CHUNK_IS_FIRST_LINE]
        nfirst = nv[COL_PROG_CHUNK_IS_FIRST_LINE]
        lresult = lv[COL_PROG_CHUNK_IS_RESULT_LINE]

        c.constraint(m(lp, F.sub(one, lp)))
        d = F.sub(np_, lp)
        c.constraint_transition(m(d, F.sub(d, one)))
        c.constraint_first_row(m(F.sub(one, lp), F.sub(one, lfirst)))
        c.constraint_transition(m(F.sub(one, np_), F.sub(one, lresult), nfirst))
        c.constraint_transition(m(F.sub(one, np_), lresult, F.sub(one, nfirst)))
        for j in range(4):
            c.constraint_transition(
                m(F.sub(one, np_), F.sub(one, lresult),
                  F.sub(nv[COL_PROG_CHUNK_CODE_ADDR[j]], lv[COL_PROG_CHUNK_CODE_ADDR[j]]))
            )
        c.constraint(m(lfirst, lv[COL_PROG_CHUNK_START_PC]))
        c.constraint_transition(
            m(F.sub(one, np_), F.sub(one, lresult),
              F.sub(F.sub(nv[COL_PROG_CHUNK_START_PC], lv[COL_PROG_CHUNK_START_PC]),
                    F.constant(8)))
        )
        for j in range(4):
            c.constraint(m(lfirst, lv[COL_PROG_CHUNK_CAP[j]]))
        for j in range(4):
            c.constraint(
                m(F.sub(one, np_), F.sub(one, nfirst),
                  F.sub(nv[COL_PROG_CHUNK_CAP[j]], lv[COL_PROG_CHUNK_HASH[8 + j]]))
            )
        for col in COL_PROG_CHUNK_FILTER_LOOKING_PROG:
            f = lv[col]
            c.constraint(m(f, F.sub(one, f)))
            c.constraint(m(F.sub(one, lp), F.sub(one, lresult), F.sub(one, f)))
        c.constraint(
            m(lresult, F.sub(one, lv[COL_PROG_CHUNK_FILTER_LOOKING_PROG[0]]))
        )
        for j in range(7):
            after = lv[COL_PROG_CHUNK_FILTER_LOOKING_PROG[j]]
            pre = lv[COL_PROG_CHUNK_FILTER_LOOKING_PROG[j + 1]]
            diff = F.sub(after, pre)
            c.constraint(m(lresult, diff, F.sub(one, diff)))


def ctl_chunk_data_to_program(i: int):
    cols = Column.singles(COL_PROG_CHUNK_CODE_ADDR)
    cols.append(
        Column.linear_combination_with_constant([(COL_PROG_CHUNK_START_PC, 1)], i)
    )
    cols.append(Column.single(COL_PROG_CHUNK_INST[i]))
    return cols


def ctl_chunk_filter_to_program(i: int):
    return Column.single(COL_PROG_CHUNK_FILTER_LOOKING_PROG[i])


def ctl_chunk_data_to_poseidon():
    return Column.singles(
        COL_PROG_CHUNK_INST + COL_PROG_CHUNK_CAP + COL_PROG_CHUNK_HASH
    )


def ctl_chunk_filter_to_poseidon():
    return Column.linear_combination_with_constant(
        [(COL_PROG_CHUNK_IS_PADDING_LINE, -1)], 1
    )


def ctl_chunk_data_to_storage_access():
    return [Column.zero()] + Column.singles(
        COL_PROG_CHUNK_CODE_ADDR + COL_PROG_CHUNK_HASH[:4]
    )


def ctl_chunk_filter_to_storage_access():
    return Column.single(COL_PROG_CHUNK_IS_RESULT_LINE)
