"""Carried from olavm_tpu/tables/storage_access.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

StorageAccess table (circuits/src/builtins/storage/): verifies the
depth-256 SMT Merkle path per storage access (layer counters, address bit
accumulators, pre/post hashes), with CTLs to Poseidon for branch hashes."""

from __future__ import annotations

import numpy as np

from ..stark.cross_table_lookup import Column
from ..stark.stark_base import Stark

COL_ST_ACCESS_IDX = 0
COL_ST_PRE_ROOT = list(range(1, 5))
COL_ST_ROOT = list(range(5, 9))
COL_ST_IS_WRITE = 9
COL_ST_LAYER = 10
COL_ST_LAYER_BIT = 11
COL_ST_ADDR_ACC = 12
COL_ST_ADDR = list(range(13, 17))
COL_ST_PRE_PATH = list(range(17, 21))
COL_ST_PATH = list(range(21, 25))
COL_ST_SIB = list(range(25, 29))
COL_ST_HASH_TYPE = 29
COL_ST_PRE_HASH = list(range(30, 34))
COL_ST_HASH = list(range(34, 38))
COL_ST_IS_LAYER_1 = 38
COL_ST_IS_LAYER_64 = 39
COL_ST_IS_LAYER_128 = 40
COL_ST_IS_LAYER_192 = 41
COL_ST_IS_LAYER_256 = 42
COL_ST_ACC_LAYER_MARKER = 43
COL_ST_FILTER_IS_HASH_BIT_0 = 44
COL_ST_FILTER_IS_HASH_BIT_1 = 45
COL_ST_FILTER_IS_FOR_PROG = 46
COL_ST_IS_PADDING = 47
NUM_COL_ST = 48


def generate_storage_access_trace(accesses, prog_hash_read) -> np.ndarray:
    n = len(accesses) + len(prog_hash_read)
    ext = max(2, 1 << (n - 1).bit_length()) if n >= 2 else 2
    tr = np.zeros((NUM_COL_ST, ext), dtype=np.uint64)
    n_acc = len(accesses)
    for i, c in enumerate(list(accesses) + list(prog_hash_read)):
        tr[COL_ST_ACCESS_IDX][i] = c.storage_access_idx
        for j in range(4):
            tr[COL_ST_PRE_ROOT[j]][i] = c.pre_root[j]
            tr[COL_ST_ROOT[j]][i] = c.root[j]
            tr[COL_ST_ADDR[j]][i] = c.addr[j]
            tr[COL_ST_PRE_PATH[j]][i] = c.pre_path[j]
            tr[COL_ST_PATH[j]][i] = c.path[j]
            tr[COL_ST_SIB[j]][i] = c.sibling[j]
            tr[COL_ST_PRE_HASH[j]][i] = c.pre_hash[j]
            tr[COL_ST_HASH[j]][i] = c.hash[j]
        tr[COL_ST_IS_WRITE][i] = c.is_write
        tr[COL_ST_LAYER][i] = c.layer
        tr[COL_ST_LAYER_BIT][i] = c.layer_bit
        tr[COL_ST_ADDR_ACC][i] = c.addr_acc
        tr[COL_ST_HASH_TYPE][i] = c.hash_type
        tr[COL_ST_IS_LAYER_1][i] = 1 if c.layer == 1 else 0
        tr[COL_ST_IS_LAYER_64][i] = 1 if c.layer == 64 else 0
        tr[COL_ST_IS_LAYER_128][i] = 1 if c.layer == 128 else 0
        tr[COL_ST_IS_LAYER_192][i] = 1 if c.layer == 192 else 0
        tr[COL_ST_IS_LAYER_256][i] = 1 if c.layer == 256 else 0
        if c.layer < 64:
            marker = 1
        elif c.layer < 128:
            marker = 2
        elif c.layer < 192:
            marker = 3
        elif c.layer < 256:
            marker = 4
        else:
            marker = 5
        tr[COL_ST_ACC_LAYER_MARKER][i] = marker
        tr[COL_ST_FILTER_IS_HASH_BIT_0][i] = 1 if c.layer_bit == 0 else 0
        tr[COL_ST_FILTER_IS_HASH_BIT_1][i] = 1 if c.layer_bit == 1 else 0
        tr[COL_ST_FILTER_IS_FOR_PROG][i] = (
            1 if (i >= n_acc and c.layer == 256) else 0
        )
    if n != ext:
        for j in range(4):
            tr[COL_ST_ROOT[j]][n:] = tr[COL_ST_ROOT[j]][n - 1] if n else 0
        tr[COL_ST_IS_PADDING][n:] = 1
    return tr


class StorageAccessStark(Stark):
    COLUMNS = NUM_COL_ST

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

        lp = lv[COL_ST_IS_PADDING]
        np_ = nv[COL_ST_IS_PADDING]
        lidx = lv[COL_ST_ACCESS_IDX]
        nidx = nv[COL_ST_ACCESS_IDX]
        llayer = lv[COL_ST_LAYER]
        nlayer = nv[COL_ST_LAYER]
        d_idx = F.sub(nidx, lidx)

        c.constraint(m(F.sub(one, lp), lp))
        d = F.sub(np_, lp)
        c.constraint_transition(m(d, F.sub(d, one)))
        c.constraint_first_row(m(F.sub(one, lp), F.sub(lidx, one)))
        c.constraint_transition(m(F.sub(one, np_), d_idx, F.sub(d_idx, one)))

        c.constraint_first_row(m(F.sub(one, lp), F.sub(one, llayer)))
        c.constraint_transition(
            m(F.sub(one, np_), F.sub(one, d_idx),
              F.sub(F.sub(nlayer, llayer), one))
        )
        c.constraint_transition(
            m(F.sub(one, np_), d_idx, F.sub(llayer, F.constant(256)))
        )
        c.constraint_transition(m(F.sub(one, np_), d_idx, F.sub(nlayer, one)))
        c.constraint(
            m(F.sub(one, np_), F.sub(llayer, F.constant(256)),
              F.sub(F.sub(nlayer, llayer), one))
        )

        layer_sels = [
            (COL_ST_IS_LAYER_1, 1), (COL_ST_IS_LAYER_64, 64),
            (COL_ST_IS_LAYER_128, 128), (COL_ST_IS_LAYER_192, 192),
            (COL_ST_IS_LAYER_256, 256),
        ]
        for col, _ in layer_sels:
            c.constraint(m(lv[col], F.sub(one, lv[col])))
        c.constraint_first_row(
            m(F.sub(one, lp), F.sub(one, lv[COL_ST_IS_LAYER_1]))
        )
        c.constraint_transition(
            m(F.sub(one, np_), d_idx, F.sub(one, nv[COL_ST_IS_LAYER_1]))
        )
        for col, val in layer_sels:
            c.constraint(m(F.sub(llayer, F.constant(val)), lv[col]))
        sel_sum_next = F.add_many([nv[col] for col, _ in layer_sels])
        c.constraint_transition(
            m(F.sub(one, np_), F.sub(one, d_idx),
              F.sub(F.sub(nv[COL_ST_ACC_LAYER_MARKER], lv[COL_ST_ACC_LAYER_MARKER]),
                    sel_sum_next))
        )
        c.constraint_transition(
            m(F.sub(one, np_), d_idx,
              F.sub(lv[COL_ST_ACC_LAYER_MARKER], F.constant(5)))
        )

        c.constraint_transition(
            m(F.sub(one, np_), d_idx, F.sub(lv[COL_ST_HASH_TYPE], one))
        )
        c.constraint_transition(
            m(F.sub(one, np_), F.sub(one, d_idx), lv[COL_ST_HASH_TYPE])
        )

        for j in range(4):
            c.constraint(m(np_, F.sub(nv[COL_ST_ROOT[j]], lv[COL_ST_ROOT[j]])))

        for j in range(4):
            c.constraint_transition(
                m(F.sub(one, np_), d_idx,
                  F.sub(nv[COL_ST_PRE_ROOT[j]], lv[COL_ST_ROOT[j]]))
            )
            c.constraint_transition(
                m(F.sub(one, np_), F.sub(one, d_idx),
                  F.sub(nv[COL_ST_PRE_ROOT[j]], lv[COL_ST_PRE_ROOT[j]]))
            )
            c.constraint_transition(
                m(F.sub(one, np_), F.sub(one, d_idx),
                  F.sub(nv[COL_ST_ROOT[j]], lv[COL_ST_ROOT[j]]))
            )
            c.constraint(
                m(lv[COL_ST_IS_LAYER_1],
                  F.sub(lv[COL_ST_PRE_ROOT[j]], lv[COL_ST_PRE_HASH[j]]))
            )
            c.constraint(
                m(lv[COL_ST_IS_LAYER_1], F.sub(lv[COL_ST_ROOT[j]], lv[COL_ST_HASH[j]]))
            )

        bit = lv[COL_ST_LAYER_BIT]
        c.constraint(m(bit, F.sub(one, bit)))
        not_64_boundary = F.sub(one, F.add_many([
            lv[COL_ST_IS_LAYER_64], lv[COL_ST_IS_LAYER_128],
            lv[COL_ST_IS_LAYER_192], lv[COL_ST_IS_LAYER_256],
        ]))
        c.constraint_transition(
            m(not_64_boundary,
              F.sub(F.sub(nv[COL_ST_ADDR_ACC], F.scalar_mul(lv[COL_ST_ADDR_ACC], 2)),
                    nv[COL_ST_LAYER_BIT]))
        )
        for col, addr_i in ((COL_ST_IS_LAYER_64, 0), (COL_ST_IS_LAYER_128, 1),
                            (COL_ST_IS_LAYER_192, 2), (COL_ST_IS_LAYER_256, 3)):
            c.constraint(
                m(lv[col], F.sub(lv[COL_ST_ADDR_ACC], lv[COL_ST_ADDR[addr_i]]))
            )

        for j in range(4):
            c.constraint_transition(
                m(F.sub(one, np_), F.sub(one, d_idx),
                  F.sub(lv[COL_ST_PATH[j]], nv[COL_ST_HASH[j]]))
            )

        c.constraint(
            m(F.sub(one, lp),
              F.sub(F.add(lv[COL_ST_FILTER_IS_HASH_BIT_0], bit), one))
        )
        c.constraint(
            m(F.sub(one, lp), F.sub(lv[COL_ST_FILTER_IS_HASH_BIT_1], bit))
        )
        c.constraint(m(lp, lv[COL_ST_FILTER_IS_HASH_BIT_0]))
        c.constraint(m(lp, lv[COL_ST_FILTER_IS_HASH_BIT_1]))
        c.constraint(m(lv[COL_ST_FILTER_IS_FOR_PROG], lv[COL_ST_IS_WRITE]))
        c.constraint(
            m(lv[COL_ST_FILTER_IS_FOR_PROG], F.sub(one, lv[COL_ST_IS_LAYER_256]))
        )


# CTL views (storage_access_stark.rs:23-105)

def ctl_data_for_prog_chunk():
    return Column.singles([COL_ST_IS_WRITE] + COL_ST_ADDR + COL_ST_PATH)


def ctl_filter_for_prog_chunk():
    return Column.single(COL_ST_FILTER_IS_FOR_PROG)


def ctl_data_with_cpu():
    return Column.singles([COL_ST_ACCESS_IDX, COL_ST_IS_WRITE] + COL_ST_ADDR + COL_ST_PATH)


def ctl_filter_with_cpu_sstore():
    return Column.linear_combination_with_constant(
        [(COL_ST_IS_LAYER_256, 1), (COL_ST_FILTER_IS_FOR_PROG, -1)], 0
    )


def _poseidon_tail():
    return [
        Column.single(COL_ST_HASH_TYPE), Column.zero(), Column.zero(),
        Column.zero(),
    ]


def ctl_data_with_poseidon_bit0():
    cols = Column.singles(COL_ST_PATH + COL_ST_SIB) + _poseidon_tail()
    cols += Column.singles(COL_ST_HASH)
    cols.append(Column.single(COL_ST_IS_LAYER_256))
    cols.append(
        Column.linear_combination_with_constant([(COL_ST_IS_LAYER_256, -1)], 1)
    )
    return cols


def ctl_data_with_poseidon_bit0_pre():
    cols = Column.singles(COL_ST_PRE_PATH + COL_ST_SIB) + _poseidon_tail()
    cols += Column.singles(COL_ST_PRE_HASH)
    cols.append(Column.single(COL_ST_IS_LAYER_256))
    cols.append(
        Column.linear_combination_with_constant([(COL_ST_IS_LAYER_256, -1)], 1)
    )
    return cols


def ctl_filter_with_poseidon_bit0():
    return Column.single(COL_ST_FILTER_IS_HASH_BIT_0)


def ctl_data_with_poseidon_bit1():
    cols = Column.singles(COL_ST_SIB + COL_ST_PATH) + _poseidon_tail()
    cols += Column.singles(COL_ST_HASH)
    cols.append(Column.single(COL_ST_IS_LAYER_256))
    cols.append(
        Column.linear_combination_with_constant([(COL_ST_IS_LAYER_256, -1)], 1)
    )
    return cols


def ctl_data_with_poseidon_bit1_pre():
    cols = Column.singles(COL_ST_SIB + COL_ST_PRE_PATH) + _poseidon_tail()
    cols += Column.singles(COL_ST_PRE_HASH)
    cols.append(Column.single(COL_ST_IS_LAYER_256))
    cols.append(
        Column.linear_combination_with_constant([(COL_ST_IS_LAYER_256, -1)], 1)
    )
    return cols


def ctl_filter_with_poseidon_bit1():
    return Column.single(COL_ST_FILTER_IS_HASH_BIT_1)
