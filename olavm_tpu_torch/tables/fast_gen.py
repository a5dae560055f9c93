"""Carried from olavm_tpu/tables/fast_gen.py: the card has no jax, so this copy imports
only jax-free modules; its code is unchanged.

Vectorized trace generation from the fast executor's SoA journals.

Column-for-column equivalent to the row-based generators (tables/cpu.py
generate_cpu_trace, tables/memory.py generate_memory_trace, ...), but built
from flat numpy arrays in O(columns) vector ops instead of per-row Python —
the analogue of the reference's thread-per-table generation
(circuits/src/generation/mod.rs:77) at numpy speed.

Equality with the row-based path is enforced by tests/test_fast_executor.py.
"""

from __future__ import annotations

import numpy as np

from ..field import goldilocks as gl
from ..isa.opcodes import Opcode
from ..runtime import fast_executor as fx
from . import bitwise as bw_t
from ..tables import cmp as cmp_t
from ..tables import cpu as cpu_t
from ..tables import memory as mem_t
from ..tables import rangecheck as rc_t
from ..tables import tape as tape_t
from . import program as prog_t


def _pad_len(n: int) -> int:
    return max(2, 1 << (n - 1).bit_length()) if n >= 2 else 2


def generate_cpu_trace_soa(cpu: np.ndarray, addr_storage, addr_code,
                           storage_access_idx_base: int = 0) -> np.ndarray:
    n = cpu.shape[0]
    ext_n = _pad_len(n)
    tr = np.zeros((cpu_t.NUM_CPU_COLS, ext_n), dtype=np.uint64)
    c = cpu.T  # (CPU_FIELDS, n)
    sl = slice(0, n)
    for j in range(4):
        tr[cpu_t.COL_ADDR_STORAGE + j][sl] = np.uint64(addr_storage[j])
        tr[cpu_t.COL_ADDR_CODE + j][sl] = np.uint64(addr_code[j])
    tr[cpu_t.COL_TP][sl] = c[fx.CF_TP]
    tr[cpu_t.COL_CLK][sl] = c[fx.CF_CLK]
    tr[cpu_t.COL_PC][sl] = c[fx.CF_PC]
    is_ext = c[fx.CF_IS_EXT]
    tr[cpu_t.COL_IS_EXT_LINE][sl] = is_ext
    tr[cpu_t.COL_EXT_CNT][sl] = c[fx.CF_EXT_CNT]
    for j in range(10):
        tr[cpu_t.COL_START_REG + j][sl] = c[fx.CF_REG0 + j]
    tr[cpu_t.COL_INST][sl] = c[fx.CF_INSTR]
    tr[cpu_t.COL_OP1_IMM][sl] = c[fx.CF_OP1IMM]
    opcode = c[fx.CF_OPCODE]
    tr[cpu_t.COL_OPCODE][sl] = opcode
    tr[cpu_t.COL_IMM_VAL][sl] = c[fx.CF_IMM]
    tr[cpu_t.COL_OP0][sl] = c[fx.CF_OP0]
    tr[cpu_t.COL_OP1][sl] = c[fx.CF_OP1]
    tr[cpu_t.COL_DST][sl] = c[fx.CF_DST]
    tr[cpu_t.COL_AUX0][sl] = c[fx.CF_AUX0]
    tr[cpu_t.COL_AUX1][sl] = c[fx.CF_AUX1]
    tr[cpu_t.COL_IDX_STORAGE][sl] = np.uint64(storage_access_idx_base)
    for j in range(10):
        tr[cpu_t.COL_S_OP0_START + j][sl] = (
            c[fx.CF_SEL_OP0] == np.uint64(j + 1)
        ).astype(np.uint64)
        tr[cpu_t.COL_S_OP1_START + j][sl] = (
            c[fx.CF_SEL_OP1] == np.uint64(j + 1)
        ).astype(np.uint64)
        tr[cpu_t.COL_S_DST_START + j][sl] = (
            c[fx.CF_SEL_DST] == np.uint64(j + 1)
        ).astype(np.uint64)
    # tape ext lines override op0_reg_sel[0] with the tape address
    ext_mask = is_ext == 1
    tr[cpu_t.COL_S_OP0_START][ :n][ext_mask] = c[fx.CF_SEL_OP0_VAL0][ext_mask]

    for mask, sel in cpu_t._OPCODE_TO_SELECTOR.items():
        tr[sel][sl] |= (opcode == np.uint64(mask)).astype(np.uint64)

    end_mask = np.uint64(Opcode.END.mask)
    is_end = opcode == end_mask
    # env 0 everywhere; entry flag = 1 except END ext lines (none in fast path)
    tr[cpu_t.COL_IS_ENTRY_SC][sl] = np.where(is_end & ext_mask, 0, 1)

    # ext_length per row (fast path ops only: tload/tstore; END is env-0)
    op0v = c[fx.CF_OP0]
    op1v = c[fx.CF_OP1]
    ext_length = np.zeros(n, dtype=np.uint64)
    tl = opcode == np.uint64(Opcode.TLOAD.mask)
    ts = opcode == np.uint64(Opcode.TSTORE.mask)
    ext_length[tl] = (gl.mul_arr(op0v[tl], op1v[tl])
                      + (np.uint64(1) - op0v[tl]))
    ext_length[ts] = op1v[ts]
    tr[cpu_t.COL_IS_NEXT_LINE_DIFF_INST][sl] = (
        ext_length == c[fx.CF_EXT_CNT]
    ).astype(np.uint64)
    tr[cpu_t.COL_IS_NEXT_LINE_SAME_TX][sl] = np.where(is_end & ~ext_mask, 0, 1)
    tr[cpu_t.COL_FILTER_TAPE_LOOKING][sl] = c[fx.CF_FILTER_TAPE]
    # sccall/storage ext flags stay 0 in the fast path
    mload_mask = opcode == np.uint64(Opcode.MLOAD.mask)
    mstore_mask = opcode == np.uint64(Opcode.MSTORE.mask)
    filt_imm = np.where(
        ext_mask, 0,
        np.where(mload_mask | mstore_mask, 1,
                 (c[fx.CF_OP1IMM] == 1).astype(np.uint64)),
    )
    tr[cpu_t.COL_FILTER_LOOKING_PROG_IMM][sl] = filt_imm

    # padding (generation/cpu.rs:177-210)
    if n and n != ext_n:
        tr[cpu_t.COL_INST][n:] = tr[cpu_t.COL_INST][n - 1]
        tr[cpu_t.COL_OPCODE][n:] = Opcode.END.mask
        tr[cpu_t.COL_IDX_STORAGE][n:] = tr[cpu_t.COL_IDX_STORAGE][n - 1]
        tr[cpu_t.COL_S_END][n:] = 1
        tr[cpu_t.COL_IS_ENTRY_SC][n:] = 1
        tr[cpu_t.COL_IS_NEXT_LINE_DIFF_INST][n:] = 1
        tr[cpu_t.COL_IS_NEXT_LINE_SAME_TX][n:] = 0
        tr[cpu_t.COL_IS_PADDING][n:] = 1
    return tr


def generate_memory_trace_soa(mem: np.ndarray) -> np.ndarray:
    """mem: (n, 16) rows [env, addr, clk, is_rw, op, is_write, diff_addr,
    diff_addr_inv, diff_clk, diff_addr_cond, filter_main, rw_unchanged,
    region_p, region_h, value, rc_value]."""
    n = mem.shape[0]
    padded = _pad_len(n)
    tr = np.zeros((mem_t.NUM_MEM_COLS, padded), dtype=np.uint64)
    m = mem.T
    sl = slice(0, n)
    tr[mem_t.COL_MEM_ENV_IDX][sl] = m[0]
    tr[mem_t.COL_MEM_ADDR][sl] = m[1]
    tr[mem_t.COL_MEM_CLK][sl] = m[2]
    tr[mem_t.COL_MEM_IS_RW][sl] = m[3]
    tr[mem_t.COL_MEM_OP][sl] = m[4]
    op = m[4]
    for mask, sel in mem_t._OP_TO_SEL.items():
        tr[sel][sl] |= (op == np.uint64(mask)).astype(np.uint64)
    tr[mem_t.COL_MEM_IS_WRITE][sl] = m[5]
    tr[mem_t.COL_MEM_DIFF_ADDR][sl] = m[6]
    tr[mem_t.COL_MEM_DIFF_ADDR_INV][sl] = m[7]
    tr[mem_t.COL_MEM_DIFF_CLK][sl] = m[8]
    tr[mem_t.COL_MEM_DIFF_ADDR_COND][sl] = m[9]
    # m[10] (filter_looked_for_main) has no memory-table column
    tr[mem_t.COL_MEM_RW_ADDR_UNCHANGED][sl] = m[11]
    tr[mem_t.COL_MEM_REGION_PROPHET][sl] = m[12]
    tr[mem_t.COL_MEM_REGION_HEAP][sl] = m[13]
    tr[mem_t.COL_MEM_VALUE][sl] = m[14]
    tr[mem_t.COL_MEM_RC_VALUE][sl] = m[15]
    heap = m[13] == 1
    proph = m[12] == 1
    prev_not_heap = np.empty(n, dtype=bool)
    prev_not_heap[0] = False
    prev_not_heap[1:] = m[13][:-1] == 0
    env_changed = np.zeros(n, dtype=bool)
    env_changed[1:] = m[0][1:] != m[0][:-1]
    first = np.zeros(n, dtype=bool)
    if n:
        first[0] = True
    excl = first | env_changed | proph | (heap & prev_not_heap)
    tr[mem_t.COL_MEM_FILTER_LOOKING_RC][sl] = (~excl).astype(np.uint64)
    tr[mem_t.COL_MEM_FILTER_LOOKING_RC_COND][sl] = (heap | proph).astype(
        np.uint64
    )

    filled = n
    if filled == 0:
        addr = gl.P - mem_t.SPAN
        tr[mem_t.COL_MEM_ADDR][0] = addr
        tr[mem_t.COL_MEM_IS_WRITE][0] = 1
        tr[mem_t.COL_MEM_DIFF_ADDR_COND][0] = gl.P - addr
        tr[mem_t.COL_MEM_REGION_PROPHET][0] = 1
        tr[mem_t.COL_MEM_RC_VALUE][0] = gl.P - addr
        filled = 1
    if padded != filled:
        mem_t._pad_memory(tr, filled, padded)
    return tr


def generate_rc_trace_soa(rc: np.ndarray) -> np.ndarray:
    """rc: (n, 2) of (value, filter_code 0=mem_sort 1=cpu 2=cmp 3=storage
    4=mem_region)."""
    n = rc.shape[0]
    max_len = max(n, rc_t.RANGE_CHECK_U16_SIZE)
    ext = max(2, 1 << (max_len - 1).bit_length())
    tr = np.zeros((rc_t.COL_NUM_RC, ext), dtype=np.uint64)
    vals = rc[:, 0]
    code = rc[:, 1]
    sl = slice(0, n)
    tr[rc_t.VAL][sl] = vals
    tr[rc_t.LIMB_LO][sl] = vals & np.uint64(0xFFFF)
    tr[rc_t.LIMB_HI][sl] = vals >> np.uint64(16)
    tr[rc_t.MEMORY_SORT_FILTER][sl] = (code == 0).astype(np.uint64)
    tr[rc_t.CPU_FILTER][sl] = (code == 1).astype(np.uint64)
    tr[rc_t.CMP_FILTER][sl] = (code == 2).astype(np.uint64)
    # storage filter (code 3) has no rangecheck-table column
    tr[rc_t.MEMORY_REGION_FILTER][sl] = (code == 4).astype(np.uint64)
    fix = np.arange(ext, dtype=np.uint64)
    fix[rc_t.RANGE_CHECK_U16_SIZE:] = rc_t.RANGE_CHECK_U16_SIZE - 1
    tr[rc_t.FIX_RANGE_CHECK_U16] = fix
    from ..stark.lookup import permuted_cols

    tr[rc_t.LIMB_LO_PERMUTED], tr[rc_t.FIX_RANGE_CHECK_U16_PERMUTED_LO] = (
        permuted_cols(tr[rc_t.LIMB_LO], tr[rc_t.FIX_RANGE_CHECK_U16])
    )
    tr[rc_t.LIMB_HI_PERMUTED], tr[rc_t.FIX_RANGE_CHECK_U16_PERMUTED_HI] = (
        permuted_cols(tr[rc_t.LIMB_HI], tr[rc_t.FIX_RANGE_CHECK_U16])
    )
    return tr


def generate_bitwise_trace_soa(bw: np.ndarray):
    """bw: (n, 4) of (opcode, op0, op1, res)."""
    rows = [
        _BWRow(int(r[0]), int(r[1]), int(r[2]), int(r[3])) for r in bw
    ]
    return bw_t.generate_bitwise_trace(rows)


class _BWRow:
    __slots__ = ("opcode", "op0", "op1", "res", "op0_limbs", "op1_limbs",
                 "res_limbs")

    def __init__(self, opcode, op0, op1, res):
        self.opcode = opcode
        self.op0 = op0
        self.op1 = op1
        self.res = res
        self.op0_limbs = tuple((op0 >> (8 * i)) & 0xFF for i in range(4))
        self.op1_limbs = tuple((op1 >> (8 * i)) & 0xFF for i in range(4))
        self.res_limbs = tuple((res >> (8 * i)) & 0xFF for i in range(4))


def generate_cmp_trace_soa(cmp_rows: np.ndarray) -> np.ndarray:
    """cmp: (n, 4) of (op0, op1, gte, abs_diff); inverse batched."""
    n = cmp_rows.shape[0]
    ext = max(2, 1 << (n - 1).bit_length()) if n >= 2 else 2
    tr = np.zeros((cmp_t.COL_NUM_CMP, ext), dtype=np.uint64)
    sl = slice(0, n)
    tr[cmp_t.COL_CMP_OP0][sl] = cmp_rows[:, 0]
    tr[cmp_t.COL_CMP_OP1][sl] = cmp_rows[:, 1]
    tr[cmp_t.COL_CMP_GTE][sl] = cmp_rows[:, 2]
    abs_diff = cmp_rows[:, 3]
    tr[cmp_t.COL_CMP_ABS_DIFF][sl] = abs_diff
    nz = abs_diff != 0
    inv = np.zeros(n, dtype=np.uint64)
    if nz.any():
        inv[nz] = gl.batch_inv(abs_diff[nz])
    tr[cmp_t.COL_CMP_ABS_DIFF_INV][sl] = inv
    tr[cmp_t.COL_CMP_FILTER_LOOKING_RC][sl] = 1
    if n != ext:
        tr[cmp_t.COL_CMP_OP0][n:] = 1
        tr[cmp_t.COL_CMP_GTE][n:] = 1
        tr[cmp_t.COL_CMP_ABS_DIFF][n:] = 1
        tr[cmp_t.COL_CMP_ABS_DIFF_INV][n:] = 1
    return tr


def generate_tape_trace_soa(tape: np.ndarray) -> np.ndarray:
    """tape: (n, 5) of (is_init, op, addr, value, filter)."""
    n = tape.shape[0]
    ext = _pad_len(n)
    tr = np.zeros((tape_t.NUM_COL_TAPE, ext), dtype=np.uint64)
    sl = slice(0, n)
    tr[tape_t.COL_TAPE_IS_INIT_SEG][sl] = tape[:, 0]
    tr[tape_t.COL_TAPE_OPCODE][sl] = tape[:, 1]
    tr[tape_t.COL_TAPE_ADDR][sl] = tape[:, 2]
    tr[tape_t.COL_TAPE_VALUE][sl] = tape[:, 3]
    tr[tape_t.COL_FILTER_LOOKED][sl] = tape[:, 4]
    if n and n != ext:
        tr[tape_t.COL_TAPE_TX_IDX][n:] = tr[tape_t.COL_TAPE_TX_IDX][n - 1]
        tr[tape_t.COL_TAPE_IS_INIT_SEG][n:] = tr[tape_t.COL_TAPE_IS_INIT_SEG][n - 1]
        tr[tape_t.COL_TAPE_OPCODE][n:] = Opcode.TLOAD.mask
        tr[tape_t.COL_TAPE_ADDR][n:] = tr[tape_t.COL_TAPE_ADDR][n - 1]
        tr[tape_t.COL_TAPE_VALUE][n:] = tr[tape_t.COL_TAPE_VALUE][n - 1]
    elif n == 0:
        tr[tape_t.COL_TAPE_OPCODE][:] = Opcode.TLOAD.mask
    return tr


def generate_traces_fast(fast_run, program, ola_stark, process, progs=None):
    """Fast analogue of tables.ola_stark.generate_traces: the 6 hot tables
    (cpu/memory/rangecheck/bitwise/cmp/tape/program) come from the native
    executor's SoA journals; the cold tables (poseidon/poseidon_chunk/
    storage_access/sccall/prog_chunk) from the Python-side trace lists, which
    for fast-path programs only hold program-hash and SMT bookkeeping."""
    from . import ola_stark as _os
    from . import poseidon as pos_t
    from ..tables import poseidon_chunk as pc_t
    from ..tables import sccall as sc_t
    from ..tables import storage_access as st_t

    trace = program.trace
    if progs is None:
        progs = []
        for addr_str, words in trace.addr_program_hash.items():
            addr = tuple(int(x) for x in addr_str.split(":"))
            progs.append((addr, [int(w) for w in words]))

    cpu_tr = generate_cpu_trace_soa(
        fast_run.cpu, process.addr_storage, process.addr_code
    )
    mem_tr = generate_memory_trace_soa(fast_run.mem)
    bw_tr, bw_beta = generate_bitwise_trace_soa(fast_run.bw)
    ola_stark.bitwise_stark.compress_challenge = bw_beta
    cmp_tr = generate_cmp_trace_soa(fast_run.cmp)
    # rangecheck = native rows (exec + memory phases, in order) followed by
    # any Python-side finalizer inserts (storage; none for fast programs)
    extra_rc = [
        (r.val, 3) for r in trace.builtin_rangecheck
    ]
    rc_all = fast_run.rc
    if extra_rc:
        rc_all = np.concatenate(
            [rc_all, np.array(extra_rc, dtype=np.uint64)]
        )
    rc_tr = generate_rc_trace_soa(rc_all)
    pos_tr = pos_t.generate_poseidon_trace(trace.builtin_poseidon)
    pc_tr = pc_t.generate_poseidon_chunk_trace(trace.builtin_poseidon_chunk)
    st_tr = st_t.generate_storage_access_trace(
        trace.builtin_storage_hash, trace.builtin_program_hash
    )
    tape_tr = generate_tape_trace_soa(fast_run.tape)
    sc_tr = sc_t.generate_sccall_trace(trace.sc_call)
    prog_tr, prog_beta = generate_prog_trace_soa(
        fast_run.cpu, process.addr_code, progs, trace.start_end_roots
    )
    ola_stark.program_stark.compress_challenge = prog_beta
    pchunk_tr = prog_t.generate_prog_chunk_trace(progs)

    return [
        cpu_tr, mem_tr, bw_tr, cmp_tr, rc_tr, pos_tr, pc_tr, st_tr,
        tape_tr, sc_tr, prog_tr, pchunk_tr,
    ]


def generate_prog_trace_soa(cpu: np.ndarray, addr_code, progs,
                            start_end_roots):
    """Vectorized program-table generation (tables/program.py
    generate_prog_trace): the executed-fetch view from the cpu SoA + the
    program ROM view."""
    from ..stark.challenger import Challenger

    challenger = Challenger()
    for j in range(4):
        challenger.observe_element(int(start_end_roots[0][j]))
        challenger.observe_element(int(start_end_roots[1][j]))
    beta = challenger.get_challenge()

    c = cpu.T
    main = c[fx.CF_IS_EXT] == 0
    opcode = c[fx.CF_OPCODE][main]
    pc = c[fx.CF_PC][main]
    inst = c[fx.CF_INSTR][main]
    imm = c[fx.CF_IMM][main]
    has_imm = (
        (c[fx.CF_OP1IMM][main] == 1)
        | (opcode == np.uint64(Opcode.MLOAD.mask))
        | (opcode == np.uint64(Opcode.MSTORE.mask))
    )
    n_main = main.sum()
    rows_per = 1 + has_imm.astype(np.int64)
    pos = np.zeros(n_main, dtype=np.int64)
    np.cumsum(rows_per[:-1], out=pos[1:])
    exec_len = int(rows_per.sum())
    progs_total = sum(len(p[1]) for p in progs)
    n = max(exec_len, progs_total)
    ext = max(2, 1 << (n - 1).bit_length()) if n >= 2 else 2
    tr = np.zeros((prog_t.NUM_PROG_COLS, ext), dtype=np.uint64)

    for j in range(4):
        tr[prog_t.COL_PROG_EXEC_CODE_ADDR[j]][:exec_len] = np.uint64(
            addr_code[j]
        )
    tr[prog_t.COL_PROG_EXEC_PC][pos] = pc
    tr[prog_t.COL_PROG_EXEC_INST][pos] = inst
    tr[prog_t.COL_PROG_FILTER_EXEC][:exec_len] = 1
    ipos = pos[has_imm] + 1
    tr[prog_t.COL_PROG_EXEC_PC][ipos] = pc[has_imm] + np.uint64(1)
    tr[prog_t.COL_PROG_EXEC_INST][ipos] = imm[has_imm]
    tr[prog_t.COL_PROG_EXEC_COMP_PROG] = prog_t._compress6(
        [tr[prog_t.COL_PROG_EXEC_CODE_ADDR[0]],
         tr[prog_t.COL_PROG_EXEC_CODE_ADDR[1]],
         tr[prog_t.COL_PROG_EXEC_CODE_ADDR[2]],
         tr[prog_t.COL_PROG_EXEC_CODE_ADDR[3]],
         tr[prog_t.COL_PROG_EXEC_PC], tr[prog_t.COL_PROG_EXEC_INST]],
        beta,
    )
    tr[prog_t.COL_PROG_EXEC_COMP_PROG][exec_len:] = 0

    pidx = 0
    for addr, insts in progs:
        ln = len(insts)
        for j in range(4):
            tr[prog_t.COL_PROG_CODE_ADDR[j]][pidx : pidx + ln] = np.uint64(
                addr[j]
            )
        tr[prog_t.COL_PROG_PC][pidx : pidx + ln] = np.arange(ln, dtype=np.uint64)
        tr[prog_t.COL_PROG_INST][pidx : pidx + ln] = np.array(
            insts, dtype=np.uint64
        )
        tr[prog_t.COL_PROG_FILTER_PROG_CHUNK][pidx : pidx + ln] = 1
        pidx += ln
    comp = prog_t._compress6(
        [tr[prog_t.COL_PROG_CODE_ADDR[0]], tr[prog_t.COL_PROG_CODE_ADDR[1]],
         tr[prog_t.COL_PROG_CODE_ADDR[2]], tr[prog_t.COL_PROG_CODE_ADDR[3]],
         tr[prog_t.COL_PROG_PC], tr[prog_t.COL_PROG_INST]],
        beta,
    )
    comp[pidx:] = 0
    tr[prog_t.COL_PROG_COMP_PROG] = comp
    from ..stark.lookup import permuted_cols

    (tr[prog_t.COL_PROG_EXEC_COMP_PROG_PERM],
     tr[prog_t.COL_PROG_COMP_PROG_PERM]) = permuted_cols(
        tr[prog_t.COL_PROG_EXEC_COMP_PROG], tr[prog_t.COL_PROG_COMP_PROG]
    )
    return tr, beta
