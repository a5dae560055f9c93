"""Carried from olavm_tpu/tables/ola_stark.py: the card has no jax, so this copy imports
only jax-free modules; its code is unchanged.

OlaStark aggregate: the 12 tables + 19 cross-table lookups
(circuits/src/stark/ola_stark.rs:27-580) and the trace-generation driver
(circuits/src/generation/mod.rs)."""

from __future__ import annotations

import numpy as np

from ..stark.cross_table_lookup import (
    Column,
    CrossTableLookup,
    TableWithColumns,
)
from . import bitwise as bw
from ..tables import cmp as cmp_t
from ..tables import cpu
from ..tables import memory as mem
from . import poseidon as pos_t
from ..tables import poseidon_chunk as pc
from . import program as prog
from ..tables import rangecheck as rc
from ..tables import sccall as sc
from ..tables import storage_access as st
from ..tables import tape as tape_t

# Table indices (ola_stark.rs:104-120)
CPU = 0
MEMORY = 1
BITWISE = 2
CMP = 3
RANGECHECK = 4
POSEIDON = 5
POSEIDON_CHUNK = 6
STORAGE_ACCESS = 7
TAPE = 8
SCCALL = 9
PROGRAM = 10
PROG_CHUNK = 11
NUM_TABLES = 12


def _t(table, data, filt):
    return TableWithColumns(table, data, filt)


def _ctl_cpu_memory():
    lookers = [
        _t(CPU, cpu_ctl("mem_store_load"), Column([(cpu.COL_S_MSTORE, 1), (cpu.COL_S_MLOAD, 1)])),
        _t(CPU, Column.singles([cpu.COL_TX_IDX, cpu.COL_ENV_IDX, cpu.COL_CLK,
                                cpu.COL_OPCODE, cpu.COL_OP0, cpu.COL_DST]),
           Column([(cpu.COL_S_CALL, 1), (cpu.COL_S_RET, 1)])),
        _t(CPU, Column.singles([cpu.COL_TX_IDX, cpu.COL_ENV_IDX, cpu.COL_CLK,
                                cpu.COL_OPCODE, cpu.COL_AUX0, cpu.COL_AUX1]),
           Column([(cpu.COL_S_CALL, 1), (cpu.COL_S_RET, 1)])),
        _t(CPU, Column.singles([cpu.COL_TX_IDX, cpu.COL_ENV_IDX, cpu.COL_CLK,
                                cpu.COL_OPCODE, cpu.COL_AUX0, cpu.COL_AUX1]),
           Column.single(cpu.COL_FILTER_TAPE_LOOKING)),
    ]
    for i in range(4):
        col_addr = [cpu.COL_OP0, cpu.COL_DST, cpu.COL_AUX0, cpu.COL_AUX1][i]
        col_value = cpu.COL_ADDR_CODE + i
        lookers.append(
            _t(CPU, Column.singles([cpu.COL_TX_IDX, cpu.COL_ENV_IDX, cpu.COL_CLK,
                                    cpu.COL_OPCODE, col_addr, col_value]),
               Column.single(cpu.IS_SCCALL_EXT_LINE))
        )
    for i in range(4):
        lookers.append(
            _t(CPU, Column.singles([cpu.COL_TX_IDX, cpu.COL_ENV_IDX, cpu.COL_CLK,
                                    cpu.COL_OPCODE, cpu.COL_S_OP0[i],
                                    cpu.COL_S_OP0[4 + i]]),
               Column.single(cpu.COL_IS_STORAGE_EXT_LINE))
        )
    for i in range(4):
        lookers.append(
            _t(CPU, Column.singles([cpu.COL_TX_IDX, cpu.COL_ENV_IDX, cpu.COL_CLK,
                                    cpu.COL_OPCODE, cpu.COL_S_OP1[i],
                                    cpu.COL_S_OP1[4 + i]]),
               Column.single(cpu.COL_IS_STORAGE_EXT_LINE))
        )
    return CrossTableLookup(lookers, _t(MEMORY, mem.ctl_data(), mem.ctl_filter()))


def cpu_ctl(which):
    if which == "mem_store_load":
        return Column.singles([cpu.COL_TX_IDX, cpu.COL_ENV_IDX, cpu.COL_CLK,
                               cpu.COL_OPCODE, cpu.COL_AUX1, cpu.COL_DST])
    raise KeyError(which)


def all_cross_table_lookups() -> list[CrossTableLookup]:
    ctls = [
        _ctl_cpu_memory(),
        # memory <-> rangecheck (sort + region)
        CrossTableLookup(
            [_t(MEMORY, mem.ctl_data_mem_sort_rc(), mem.ctl_filter_mem_sort_rc())],
            _t(RANGECHECK, rc.ctl_data_memory(), rc.ctl_filter_memory_sort()),
        ),
        CrossTableLookup(
            [_t(MEMORY, mem.ctl_data_mem_rc_diff_cond(),
                mem.ctl_filter_mem_rc_diff_cond())],
            _t(RANGECHECK, rc.ctl_data_memory(), rc.ctl_filter_memory_region()),
        ),
        # bitwise <- cpu
        CrossTableLookup(
            [_t(CPU, Column.singles([cpu.COL_OPCODE, cpu.COL_OP0, cpu.COL_OP1,
                                     cpu.COL_DST]),
                Column.single(cpu.COL_S_BITWISE))],
            _t(BITWISE, bw.ctl_data_with_cpu(), bw.ctl_filter_with_cpu()),
        ),
        # cmp <- cpu
        CrossTableLookup(
            [_t(CPU, Column.singles([cpu.COL_OP0, cpu.COL_OP1, cpu.COL_DST]),
                Column.single(cpu.COL_S_GTE))],
            _t(CMP, cmp_t.ctl_data_with_cpu(), cmp_t.ctl_filter_with_cpu()),
        ),
        # cmp <-> rangecheck
        CrossTableLookup(
            [_t(RANGECHECK, rc.ctl_data_with_cmp(), rc.ctl_filter_with_cmp())],
            _t(CMP, cmp_t.ctl_data_with_rangecheck(),
               cmp_t.ctl_filter_with_rangecheck()),
        ),
        # rangecheck <- cpu
        CrossTableLookup(
            [_t(CPU, Column.singles([cpu.COL_OP1]), Column.single(cpu.COL_S_RC))],
            _t(RANGECHECK, rc.ctl_data_with_cpu(), rc.ctl_filter_with_cpu()),
        ),
        # cpu <-> poseidon_chunk
        CrossTableLookup(
            [_t(CPU, Column.singles([cpu.COL_TX_IDX, cpu.COL_ENV_IDX, cpu.COL_CLK,
                                     cpu.COL_OPCODE, cpu.COL_OP0, cpu.COL_OP1,
                                     cpu.COL_DST]),
                Column.single(cpu.COL_S_PSDN))],
            _t(POSEIDON_CHUNK, pc.ctl_data_with_cpu(), pc.ctl_filter_with_cpu()),
        ),
        # poseidon_chunk <-> memory
        CrossTableLookup(
            [_t(POSEIDON_CHUNK, pc.ctl_data_with_mem_src(i),
                pc.ctl_filter_with_mem_src(i)) for i in range(8)]
            + [_t(POSEIDON_CHUNK, pc.ctl_data_with_mem_dst(i),
                  pc.ctl_filter_with_mem_dst()) for i in range(4)],
            _t(MEMORY, mem.ctl_data_with_poseidon_chunk(),
               mem.ctl_filter_with_poseidon_chunk()),
        ),
        # chunk (+prog_chunk) <-> poseidon
        CrossTableLookup(
            [
                _t(POSEIDON_CHUNK, pc.ctl_data_with_poseidon(),
                   pc.ctl_filter_with_poseidon()),
                _t(PROG_CHUNK, prog.ctl_chunk_data_to_poseidon(),
                   prog.ctl_chunk_filter_to_poseidon()),
            ],
            _t(POSEIDON, pos_t.ctl_data_with_poseidon_chunk(),
               pos_t.ctl_filter_with_poseidon_chunk()),
        ),
        # cpu <-> poseidon (tree key)
        CrossTableLookup(
            [_t(CPU,
                Column.singles(
                    list(range(cpu.COL_ADDR_STORAGE, cpu.COL_ADDR_STORAGE + 4))
                    + cpu.COL_S_OP0[4:8]
                )
                + [Column.zero()] * 4
                + Column.singles(cpu.COL_S_DST[:4]),
                Column.single(cpu.COL_IS_STORAGE_EXT_LINE))],
            _t(POSEIDON, pos_t.ctl_data_cpu_tree_key(),
               pos_t.ctl_filter_cpu_tree_key()),
        ),
        # cpu <-> storage_access
        CrossTableLookup(
            [_t(CPU,
                Column.singles([cpu.COL_IDX_STORAGE, cpu.COL_S_SSTORE]
                               + cpu.COL_S_DST[:4] + cpu.COL_S_OP1[4:8]),
                Column.single(cpu.COL_IS_STORAGE_EXT_LINE))],
            _t(STORAGE_ACCESS, st.ctl_data_with_cpu(),
               st.ctl_filter_with_cpu_sstore()),
        ),
        # storage_access <-> poseidon
        CrossTableLookup(
            [
                _t(STORAGE_ACCESS, st.ctl_data_with_poseidon_bit0(),
                   st.ctl_filter_with_poseidon_bit0()),
                _t(STORAGE_ACCESS, st.ctl_data_with_poseidon_bit0_pre(),
                   st.ctl_filter_with_poseidon_bit0()),
                _t(STORAGE_ACCESS, st.ctl_data_with_poseidon_bit1(),
                   st.ctl_filter_with_poseidon_bit1()),
                _t(STORAGE_ACCESS, st.ctl_data_with_poseidon_bit1_pre(),
                   st.ctl_filter_with_poseidon_bit1()),
            ],
            _t(POSEIDON, pos_t.ctl_data_with_storage(),
               pos_t.ctl_filter_with_storage()),
        ),
        # cpu <-> tape
        _ctl_cpu_tape(),
        # cpu <-> sccall
        CrossTableLookup(
            [_t(CPU, _cpu_sccall_data(), Column.single(cpu.IS_SCCALL_EXT_LINE))],
            _t(SCCALL, sc.ctl_data_sccall(), sc.ctl_filter_sccall()),
        ),
        CrossTableLookup(
            [_t(CPU, _cpu_sccall_end_data(),
                Column.single(cpu.COL_FILTER_SCCALL_END))],
            _t(SCCALL, sc.ctl_data_sccall_end(), sc.ctl_filter_sccall_end()),
        ),
        # cpu <-> program
        CrossTableLookup(
            [
                _t(CPU,
                   Column.singles(
                       list(range(cpu.COL_ADDR_CODE, cpu.COL_ADDR_CODE + 4))
                       + [cpu.COL_PC, cpu.COL_INST]
                   ),
                   Column.linear_combination_with_constant(
                       [(cpu.COL_IS_EXT_LINE, -1), (cpu.COL_IS_PADDING, -1)], 1
                   )),
                _t(CPU,
                   Column.singles(
                       list(range(cpu.COL_ADDR_CODE, cpu.COL_ADDR_CODE + 4))
                   )
                   + [Column.linear_combination_with_constant([(cpu.COL_PC, 1)], 1),
                      Column.single(cpu.COL_IMM_VAL)],
                   Column.single(cpu.COL_FILTER_LOOKING_PROG_IMM)),
            ],
            _t(PROGRAM, prog.ctl_data_by_cpu(), prog.ctl_filter_by_cpu()),
        ),
        # prog_chunk <-> program
        CrossTableLookup(
            [_t(PROG_CHUNK, prog.ctl_chunk_data_to_program(i),
                prog.ctl_chunk_filter_to_program(i)) for i in range(8)],
            _t(PROGRAM, prog.ctl_data_by_program_chunk(),
               prog.ctl_filter_by_program_chunk()),
        ),
        # prog_chunk <-> storage_access
        CrossTableLookup(
            [_t(PROG_CHUNK, prog.ctl_chunk_data_to_storage_access(),
                prog.ctl_chunk_filter_to_storage_access())],
            _t(STORAGE_ACCESS, st.ctl_data_for_prog_chunk(),
               st.ctl_filter_for_prog_chunk()),
        ),
    ]
    assert len(ctls) == 19
    return ctls


def _ctl_cpu_tape():
    lookers = [
        _t(CPU, Column.singles([cpu.COL_TX_IDX, cpu.COL_OPCODE, cpu.COL_S_OP0[0],
                                cpu.COL_AUX1]),
           Column.single(cpu.COL_FILTER_TAPE_LOOKING)),
    ]
    for i in range(4):
        lookers.append(
            _t(CPU,
               [Column.single(cpu.COL_TX_IDX), Column.single(cpu.COL_OPCODE),
                Column.linear_combination_with_constant([(cpu.COL_TP, 1)], i),
                Column.single(cpu.COL_S_OP0[i])],
               Column.single(cpu.IS_SCCALL_EXT_LINE))
        )
    for i in range(4):
        lookers.append(
            _t(CPU,
               [Column.single(cpu.COL_TX_IDX), Column.single(cpu.COL_OPCODE),
                Column.linear_combination_with_constant([(cpu.COL_TP, 1)], 4 + i),
                Column.single(cpu.COL_ADDR_CODE + i)],
               Column.single(cpu.IS_SCCALL_EXT_LINE))
        )
    for i in range(4):
        lookers.append(
            _t(CPU,
               [Column.single(cpu.COL_TX_IDX), Column.single(cpu.COL_OPCODE),
                Column.linear_combination_with_constant([(cpu.COL_TP, 1)], 8 + i),
                Column.single(cpu.COL_ADDR_STORAGE + i)],
               Column.single(cpu.IS_SCCALL_EXT_LINE))
        )
    return CrossTableLookup(
        lookers, _t(TAPE, tape_t.ctl_data_tape(), tape_t.ctl_filter_tape())
    )


def _cpu_sccall_data():
    cols = [Column.single(cpu.COL_TX_IDX), Column.single(cpu.COL_ENV_IDX)]
    cols += Column.singles(cpu.COL_S_OP0[0:4])
    cols += Column.singles(cpu.COL_S_OP0[4:8])
    cols += Column.singles([cpu.COL_CLK, cpu.COL_OP1_IMM])
    cols += Column.singles(cpu.COL_REGS)
    cols.append(
        Column.linear_combination_with_constant([(cpu.COL_ENV_IDX, 1)], 1)
    )
    return cols


def _cpu_sccall_end_data():
    cols = [cpu.COL_TX_IDX, cpu.COL_ENV_IDX]
    cols += list(range(cpu.COL_ADDR_STORAGE, cpu.COL_ADDR_STORAGE + 4))
    cols += list(range(cpu.COL_ADDR_CODE, cpu.COL_ADDR_CODE + 4))
    cols += [cpu.COL_CLK]
    cols += cpu.COL_REGS
    cols += [cpu.COL_AUX0, cpu.COL_AUX1]
    return Column.singles(cols)


class OlaStark:
    """The 12 starks + CTLs + per-table compress challenges."""

    def __init__(self):
        self.cpu_stark = cpu.CpuStark()
        self.memory_stark = mem.MemoryStark()
        self.bitwise_stark = bw.BitwiseStark()
        self.cmp_stark = cmp_t.CmpStark()
        self.rangecheck_stark = rc.RangeCheckStark()
        self.poseidon_stark = pos_t.PoseidonStark()
        self.poseidon_chunk_stark = pc.PoseidonChunkStark()
        self.storage_access_stark = st.StorageAccessStark()
        self.tape_stark = tape_t.TapeStark()
        self.sccall_stark = sc.SCCallStark()
        self.program_stark = prog.ProgramStark()
        self.prog_chunk_stark = prog.ProgChunkStark()
        self.starks = [
            self.cpu_stark, self.memory_stark, self.bitwise_stark,
            self.cmp_stark, self.rangecheck_stark, self.poseidon_stark,
            self.poseidon_chunk_stark, self.storage_access_stark,
            self.tape_stark, self.sccall_stark, self.program_stark,
            self.prog_chunk_stark,
        ]
        self.cross_table_lookups = all_cross_table_lookups()

    def compress_challenges(self) -> list[int]:
        out = [0] * NUM_TABLES
        out[BITWISE] = int(self.bitwise_stark.compress_challenge or 0)
        out[PROGRAM] = int(self.program_stark.compress_challenge or 0)
        return out

    def set_compress_challenges(self, challenges):
        self.bitwise_stark.compress_challenge = int(challenges[BITWISE])
        self.program_stark.compress_challenge = int(challenges[PROGRAM])


def generate_traces(program, ola_stark: OlaStark, progs=None):
    """Build all 12 table matrices from an executed Program's trace
    (circuits/src/generation/mod.rs:77-...).

    progs: list of (addr4, [instruction words]) for the program table; if
    None, derived from the trace's addr_program_hash map.
    """
    trace = program.trace
    if progs is None:
        progs = []
        for addr_str, words in trace.addr_program_hash.items():
            addr = tuple(int(x) for x in addr_str.split(":"))
            progs.append((addr, [int(w) for w in words]))

    cpu_tr = cpu.generate_cpu_trace(trace.exec)
    mem_tr = mem.generate_memory_trace(trace.memory)
    bw_tr, bw_beta = bw.generate_bitwise_trace(trace.builtin_bitwise_combined)
    ola_stark.bitwise_stark.compress_challenge = bw_beta
    cmp_tr = cmp_t.generate_cmp_trace(trace.builtin_cmp)
    rc_tr = rc.generate_rc_trace(trace.builtin_rangecheck)
    pos_tr = pos_t.generate_poseidon_trace(trace.builtin_poseidon)
    pc_tr = pc.generate_poseidon_chunk_trace(trace.builtin_poseidon_chunk)
    st_tr = st.generate_storage_access_trace(
        trace.builtin_storage_hash, trace.builtin_program_hash
    )
    tape_tr = tape_t.generate_tape_trace(trace.tape)
    sc_tr = sc.generate_sccall_trace(trace.sc_call)
    prog_tr, prog_beta = prog.generate_prog_trace(
        trace.exec, progs, trace.start_end_roots
    )
    ola_stark.program_stark.compress_challenge = prog_beta
    pchunk_tr = prog.generate_prog_chunk_trace(progs)

    return [
        cpu_tr, mem_tr, bw_tr, cmp_tr, rc_tr, pos_tr, pc_tr, st_tr,
        tape_tr, sc_tr, prog_tr, pchunk_tr,
    ]
