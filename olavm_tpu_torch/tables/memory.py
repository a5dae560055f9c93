"""Carried from olavm_tpu/tables/memory.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

Memory table (circuits/src/memory/columns.rs, memory_stark.rs,
generation/memory.rs): address-sorted access journal with region semantics
(read-write stack/heap, write-once prophet region) and rangechecked diffs."""

from __future__ import annotations

import numpy as np

from ..field import goldilocks as gl
from ..isa.opcodes import Opcode
from ..stark.cross_table_lookup import Column
from ..stark.stark_base import Stark

COL_MEM_TX_IDX = 0
COL_MEM_ENV_IDX = 1
COL_MEM_IS_RW = 2
COL_MEM_ADDR = 3
COL_MEM_CLK = 4
COL_MEM_OP = 5
COL_MEM_S_MLOAD = 6
COL_MEM_S_MSTORE = 7
COL_MEM_S_CALL = 8
COL_MEM_S_RET = 9
COL_MEM_S_TLOAD = 10
COL_MEM_S_TSTORE = 11
COL_MEM_S_SCCALL = 12
COL_MEM_S_POSEIDON = 13
COL_MEM_S_SSTORE = 14
COL_MEM_S_SLOAD = 15
COL_MEM_S_PROPHET = 16
COL_MEM_IS_WRITE = 17
COL_MEM_VALUE = 18
COL_MEM_DIFF_ADDR = 19
COL_MEM_DIFF_ADDR_INV = 20
COL_MEM_DIFF_CLK = 21
COL_MEM_DIFF_ADDR_COND = 22
COL_MEM_RW_ADDR_UNCHANGED = 23
COL_MEM_REGION_PROPHET = 24
COL_MEM_REGION_HEAP = 25
COL_MEM_RC_VALUE = 26
COL_MEM_FILTER_LOOKING_RC = 27
COL_MEM_FILTER_LOOKING_RC_COND = 28
NUM_MEM_COLS = 29

ADDR_HEAP_PTR = 18446744060824649731
INIT_VALUE_HEAP_PTR = ADDR_HEAP_PTR + 1
SPAN = (1 << 32) - 1

_OP_TO_SEL = {
    Opcode.MLOAD.mask: COL_MEM_S_MLOAD,
    Opcode.MSTORE.mask: COL_MEM_S_MSTORE,
    Opcode.CALL.mask: COL_MEM_S_CALL,
    Opcode.RET.mask: COL_MEM_S_RET,
    Opcode.TLOAD.mask: COL_MEM_S_TLOAD,
    Opcode.TSTORE.mask: COL_MEM_S_TSTORE,
    Opcode.SCCALL.mask: COL_MEM_S_SCCALL,
    Opcode.POSEIDON.mask: COL_MEM_S_POSEIDON,
    Opcode.SSTORE.mask: COL_MEM_S_SSTORE,
    Opcode.SLOAD.mask: COL_MEM_S_SLOAD,
    0: COL_MEM_S_PROPHET,
}


def generate_memory_trace(cells) -> np.ndarray:
    n = len(cells)
    padded = max(2, 1 << (n - 1).bit_length()) if n >= 2 else 2
    tr = np.zeros((NUM_MEM_COLS, padded), dtype=np.uint64)
    for i, c in enumerate(cells):
        tr[COL_MEM_ENV_IDX][i] = c.env_idx
        tr[COL_MEM_IS_RW][i] = c.is_rw
        tr[COL_MEM_ADDR][i] = c.addr
        tr[COL_MEM_CLK][i] = c.clk
        tr[COL_MEM_OP][i] = c.op
        sel = _OP_TO_SEL.get(c.op)
        if sel is not None:
            tr[sel][i] = 1
        tr[COL_MEM_IS_WRITE][i] = c.is_write
        tr[COL_MEM_VALUE][i] = c.value
        tr[COL_MEM_DIFF_ADDR][i] = c.diff_addr
        tr[COL_MEM_DIFF_ADDR_INV][i] = c.diff_addr_inv
        tr[COL_MEM_DIFF_CLK][i] = c.diff_clk
        tr[COL_MEM_DIFF_ADDR_COND][i] = c.diff_addr_cond
        tr[COL_MEM_RW_ADDR_UNCHANGED][i] = c.rw_addr_unchanged
        tr[COL_MEM_REGION_PROPHET][i] = c.region_prophet
        tr[COL_MEM_REGION_HEAP][i] = c.region_heap
        tr[COL_MEM_RC_VALUE][i] = c.rc_value
        curr_is_heap = c.region_heap == 1
        last_is_not_heap = i > 0 and cells[i - 1].region_heap == 0
        env_changed = i > 0 and cells[i - 1].env_idx != c.env_idx
        if (i == 0 or env_changed or c.region_prophet == 1
                or (curr_is_heap and last_is_not_heap)):
            tr[COL_MEM_FILTER_LOOKING_RC][i] = 0
        else:
            tr[COL_MEM_FILTER_LOOKING_RC][i] = 1
        tr[COL_MEM_FILTER_LOOKING_RC_COND][i] = (
            1 if (c.region_heap == 1 or c.region_prophet == 1) else 0
        )

    filled = n
    if filled == 0:
        addr = gl.P - SPAN
        tr[COL_MEM_ADDR][0] = addr
        tr[COL_MEM_IS_WRITE][0] = 1
        tr[COL_MEM_DIFF_ADDR_COND][0] = gl.P - addr
        tr[COL_MEM_REGION_PROPHET][0] = 1
        tr[COL_MEM_RC_VALUE][0] = gl.P - addr
        filled = 1

    if padded != filled:
        _pad_memory(tr, filled, padded)
    return tr


def _pad_memory(tr, filled, padded):
    """Write-once prophet-region padding rows (generation/memory.rs),
    vectorized (the pad span can be ~n rows)."""
    k = padded - filled
    last_addr = int(tr[COL_MEM_ADDR][filled - 1])
    if tr[COL_MEM_IS_RW][filled - 1] == 1:
        addr0 = gl.P - SPAN
    else:
        addr0 = last_addr + 1
    i = slice(filled, padded)
    addrs = np.uint64(addr0) + np.arange(k, dtype=np.uint64)
    tr[COL_MEM_S_PROPHET][i] = 1
    tr[COL_MEM_TX_IDX][i] = tr[COL_MEM_TX_IDX][filled - 1]
    tr[COL_MEM_ENV_IDX][i] = tr[COL_MEM_ENV_IDX][filled - 1]
    tr[COL_MEM_ADDR][i] = addrs
    tr[COL_MEM_IS_WRITE][i] = 1
    diff0 = gl.sub(addr0, last_addr)
    tr[COL_MEM_DIFF_ADDR][i] = 1
    tr[COL_MEM_DIFF_ADDR][filled] = diff0
    tr[COL_MEM_DIFF_ADDR_INV][i] = 1
    tr[COL_MEM_DIFF_ADDR_INV][filled] = gl.inv(diff0) if diff0 else 0
    cond = np.uint64(gl.P) - addrs
    tr[COL_MEM_DIFF_ADDR_COND][i] = cond
    tr[COL_MEM_REGION_PROPHET][i] = 1
    tr[COL_MEM_RC_VALUE][i] = cond
    return tr


class MemoryStark(Stark):
    COLUMNS = NUM_MEM_COLS

    def constraint_degree(self):
        return 8

    def eval_packed(self, lv, nv, c):
        F = c.F
        one = F.constant(1)

        def m(*terms):
            acc = terms[0]
            for t in terms[1:]:
                acc = F.mul(acc, t)
            return acc

        d_tx = F.sub(nv[COL_MEM_TX_IDX], lv[COL_MEM_TX_IDX])
        same_tx = F.sub(one, d_tx)  # 1 - (nv_tx - lv_tx)
        c.constraint_transition(m(d_tx, same_tx))
        d_env = F.sub(nv[COL_MEM_ENV_IDX], lv[COL_MEM_ENV_IDX])
        same_env = F.sub(one, d_env)
        c.constraint_transition(m(same_tx, d_env, same_env))

        is_rw = lv[COL_MEM_IS_RW]
        region_prophet = lv[COL_MEM_REGION_PROPHET]
        nv_region_prophet = nv[COL_MEM_REGION_PROPHET]
        region_heap = lv[COL_MEM_REGION_HEAP]
        nv_region_heap = nv[COL_MEM_REGION_HEAP]
        region_stack = F.sub(F.sub(one, region_heap), region_prophet)
        nv_region_stack = F.sub(
            F.sub(one, nv_region_heap), nv_region_prophet
        )
        is_write = lv[COL_MEM_IS_WRITE]
        nv_is_write = nv[COL_MEM_IS_WRITE]
        addr = lv[COL_MEM_ADDR]
        nv_addr = nv[COL_MEM_ADDR]
        diff_addr = lv[COL_MEM_DIFF_ADDR]
        nv_diff_addr = nv[COL_MEM_DIFF_ADDR]
        nv_diff_addr_inv = nv[COL_MEM_DIFF_ADDR_INV]
        rw_addr_unchanged = lv[COL_MEM_RW_ADDR_UNCHANGED]
        nv_rw_addr_unchanged = nv[COL_MEM_RW_ADDR_UNCHANGED]
        diff_addr_cond = lv[COL_MEM_DIFF_ADDR_COND]
        value = lv[COL_MEM_VALUE]
        nv_value = nv[COL_MEM_VALUE]
        diff_clk = lv[COL_MEM_DIFF_CLK]
        rc_value = lv[COL_MEM_RC_VALUE]
        filter_looking_rc = lv[COL_MEM_FILTER_LOOKING_RC]
        rc_cond = lv[COL_MEM_FILTER_LOOKING_RC_COND]

        sels = [
            (COL_MEM_S_MLOAD, Opcode.MLOAD.mask),
            (COL_MEM_S_MSTORE, Opcode.MSTORE.mask),
            (COL_MEM_S_CALL, Opcode.CALL.mask),
            (COL_MEM_S_RET, Opcode.RET.mask),
            (COL_MEM_S_TLOAD, Opcode.TLOAD.mask),
            (COL_MEM_S_TSTORE, Opcode.TSTORE.mask),
            (COL_MEM_S_SCCALL, Opcode.SCCALL.mask),
            (COL_MEM_S_POSEIDON, Opcode.POSEIDON.mask),
            (COL_MEM_S_SSTORE, Opcode.SSTORE.mask),
            (COL_MEM_S_SLOAD, Opcode.SLOAD.mask),
            (COL_MEM_S_PROPHET, 0),
        ]
        for col, mask in sels:
            c.constraint(m(F.sub(lv[COL_MEM_OP], F.constant(mask)), lv[col]))
            c.constraint(m(F.sub(one, lv[col]), lv[col]))
        c.constraint(F.sub(one, F.add_many([lv[col] for col, _ in sels])))

        c.constraint(m(is_rw, F.sub(one, is_rw)))
        c.constraint(m(is_rw, lv[COL_MEM_S_PROPHET]))
        c.constraint(
            m(F.sub(one, is_rw),
              F.sub(F.sub(one, lv[COL_MEM_S_PROPHET]), lv[COL_MEM_S_MLOAD]))
        )
        c.constraint(m(is_write, F.sub(one, F.add_many([
            lv[COL_MEM_S_MSTORE], lv[COL_MEM_S_CALL], lv[COL_MEM_S_TLOAD],
            lv[COL_MEM_S_POSEIDON], lv[COL_MEM_S_SLOAD], lv[COL_MEM_S_PROPHET],
        ]))))
        c.constraint(m(F.sub(one, is_write), F.sub(one, F.add_many([
            lv[COL_MEM_S_MLOAD], lv[COL_MEM_S_CALL], lv[COL_MEM_S_RET],
            lv[COL_MEM_S_TSTORE], lv[COL_MEM_S_SCCALL], lv[COL_MEM_S_POSEIDON],
            lv[COL_MEM_S_SSTORE], lv[COL_MEM_S_SLOAD],
        ]))))

        c.constraint(F.sub(F.sub(F.sub(one, region_stack), region_heap), region_prophet))
        c.constraint(m(region_stack, F.sub(one, region_stack)))
        c.constraint(m(region_heap, F.sub(one, region_heap)))
        c.constraint(m(region_prophet, F.sub(one, region_prophet)))
        # p == 0 in the field: p - addr == -addr
        c.constraint(m(region_prophet, F.sub(F.neg(addr), diff_addr_cond)))
        c.constraint(
            m(region_heap,
              F.sub(F.sub(F.neg(F.constant(SPAN)), addr), diff_addr_cond))
        )

        same_env_guard = m(same_tx, same_env)
        heap_trans = F.sub(F.sub(nv_region_heap, region_heap), one)
        c.constraint_transition(
            m(same_env_guard, heap_trans,
              F.sub(F.sub(nv_addr, addr), nv_diff_addr))
        )
        c.constraint_transition(
            m(same_env_guard, region_stack, nv_region_stack,
              F.sub(F.sub(one, nv_rw_addr_unchanged),
                    F.mul(nv_diff_addr, nv_diff_addr_inv)))
        )
        c.constraint_transition(
            m(same_env_guard, region_heap, nv_region_heap,
              F.sub(F.sub(one, nv_rw_addr_unchanged),
                    F.mul(nv_diff_addr, nv_diff_addr_inv)))
        )

        d_addr = F.sub(nv_addr, addr)
        c.constraint(
            m(region_prophet, nv_region_prophet, d_addr, F.sub(d_addr, one))
        )
        c.constraint(
            m(region_prophet, nv_region_prophet, F.sub(d_addr, one), nv_is_write)
        )

        heap_ptr = F.constant(ADDR_HEAP_PTR)
        c.constraint_first_row(
            m(is_rw, F.sub(one, is_write), F.sub(addr, heap_ptr))
        )
        c.constraint(
            m(d_tx, d_env, nv[COL_MEM_IS_RW], F.sub(one, nv_is_write),
              F.sub(nv_addr, heap_ptr))
        )
        c.constraint(
            m(d_addr, F.sub(one, nv_is_write), F.sub(nv_addr, heap_ptr))
        )
        c.constraint(
            m(F.sub(one, nv_is_write), F.sub(nv_value, value),
              F.sub(nv_addr, heap_ptr))
        )
        # data-dependent heap-ptr selector (memory_stark.rs:290-307): equals 1
        # exactly where nv_addr == ADDR_HEAP_PTR in the evaluation domain
        is_next_hp = F.indicator_eq_const(nv_addr, ADDR_HEAP_PTR)
        c.constraint(m(is_next_hp, F.sub(nv_addr, heap_ptr)))
        c.constraint(
            m(F.sub(addr, heap_ptr), is_next_hp, F.sub(one, nv_is_write),
              F.sub(nv_value, F.constant(INIT_VALUE_HEAP_PTR)))
        )

        c.constraint_transition(
            m(same_env_guard, is_rw, heap_trans,
              F.sub(rc_value, F.mul(rw_addr_unchanged, diff_clk)),
              F.sub(rc_value, F.mul(F.sub(one, rw_addr_unchanged), diff_addr)))
        )
        c.constraint_transition(
            m(same_env_guard, is_rw, rc_value, heap_trans,
              F.sub(one, filter_looking_rc))
        )
        c.constraint(m(F.sub(one, rc_cond), region_heap))
        c.constraint(m(F.sub(one, rc_cond), region_prophet, F.sub(one, is_write)))


# ----- CTL views (memory_stark.rs:19-80) -----

def ctl_data_mem_rc_diff_cond():
    return [Column.single(COL_MEM_DIFF_ADDR_COND)]


def ctl_filter_mem_rc_diff_cond():
    return Column.single(COL_MEM_FILTER_LOOKING_RC_COND)


def ctl_data_mem_sort_rc():
    return [Column.single(COL_MEM_RC_VALUE)]


def ctl_filter_mem_sort_rc():
    return Column.single(COL_MEM_FILTER_LOOKING_RC)


def ctl_data():
    return Column.singles([
        COL_MEM_TX_IDX, COL_MEM_ENV_IDX, COL_MEM_CLK, COL_MEM_OP,
        COL_MEM_ADDR, COL_MEM_VALUE,
    ])


def ctl_filter():
    return Column([(col, 1) for col in [
        COL_MEM_S_MLOAD, COL_MEM_S_MSTORE, COL_MEM_S_CALL, COL_MEM_S_RET,
        COL_MEM_S_TLOAD, COL_MEM_S_TSTORE, COL_MEM_S_SCCALL,
        COL_MEM_S_SSTORE, COL_MEM_S_SLOAD,
    ]])


def ctl_data_with_poseidon_chunk():
    return Column.singles([
        COL_MEM_TX_IDX, COL_MEM_ENV_IDX, COL_MEM_CLK, COL_MEM_OP,
        COL_MEM_ADDR, COL_MEM_VALUE, COL_MEM_IS_WRITE,
    ])


def ctl_filter_with_poseidon_chunk():
    return Column.single(COL_MEM_S_POSEIDON)
