"""Carried from olavm_tpu/tables/bitwise.py: the card has no jax, so this copy imports
only jax-free modules; its code is unchanged.

Bitwise table (circuits/src/builtins/bitwise/): u32 AND/OR/XOR via 4 x u8
limb decomposition, with in-table lookups against fixed limb tables
compressed by a challenge beta derived from the limb columns
(generation/builtin.rs:35-200). The table is always 2^18 rows (3 * 2^16
fixed bitwise rows)."""

from __future__ import annotations

import numpy as np

from ..field import goldilocks as gl
from ..isa.opcodes import Opcode
from ..stark.challenger import Challenger
from ..stark.cross_table_lookup import Column
from ..stark.lookup import eval_lookups, permuted_cols
from ..stark.stark_base import PermutationPair, Stark

FILTER = 0
TAG = 1
OP0 = 2
OP1 = 3
RES = 4
OP0_LIMBS = list(range(5, 9))
OP1_LIMBS = list(range(9, 13))
RES_LIMBS = list(range(13, 17))
OP0_LIMBS_PERMUTED = list(range(17, 21))
OP1_LIMBS_PERMUTED = list(range(21, 25))
RES_LIMBS_PERMUTED = list(range(25, 29))
COMPRESS_LIMBS = list(range(29, 33))
COMPRESS_PERMUTED = list(range(33, 37))
FIX_RANGE_CHECK_U8 = 37
FIX_RANGE_CHECK_U8_PERMUTED = list(range(38, 50))
FIX_TAG = 50
FIX_BITWISE_OP0 = 51
FIX_BITWISE_OP1 = 52
FIX_BITWISE_RES = 53
FIX_COMPRESS = 54
FIX_COMPRESS_PERMUTED = list(range(55, 59))
COL_NUM_BITWISE = 59

RANGE_CHECK_U8_SIZE = 1 << 8
BITWISE_U8_SIZE_PER = 1 << 16
BITWISE_U8_SIZE = 3 * BITWISE_U8_SIZE_PER


def generate_bitwise_trace(rows) -> tuple[np.ndarray, int]:
    """Returns (trace, compress_challenge beta)."""
    n = len(rows)
    max_len = max(n, RANGE_CHECK_U8_SIZE, BITWISE_U8_SIZE)
    ext = max(2, 1 << (max_len - 1).bit_length())
    tr = np.zeros((COL_NUM_BITWISE, ext), dtype=np.uint64)
    for i, c in enumerate(rows):
        tr[FILTER][i] = 1
        tr[TAG][i] = c.opcode
        tr[OP0][i] = c.op0
        tr[OP1][i] = c.op1
        tr[RES][i] = c.res
        for j in range(4):
            tr[OP0_LIMBS[j]][i] = c.op0_limbs[j]
            tr[OP1_LIMBS[j]][i] = c.op1_limbs[j]
            tr[RES_LIMBS[j]][i] = c.res_limbs[j]

    # fixed tables (vectorized: op0 major, op1 minor)
    tr[FIX_RANGE_CHECK_U8][:RANGE_CHECK_U8_SIZE] = np.arange(256, dtype=np.uint64)
    a = np.repeat(np.arange(256, dtype=np.uint64), 256)
    b = np.tile(np.arange(256, dtype=np.uint64), 256)
    tr[FIX_BITWISE_OP0][0:BITWISE_U8_SIZE_PER] = a
    tr[FIX_BITWISE_OP1][0:BITWISE_U8_SIZE_PER] = b
    tr[FIX_BITWISE_RES][0:BITWISE_U8_SIZE_PER] = a & b
    tr[FIX_TAG][0:BITWISE_U8_SIZE_PER] = Opcode.AND.mask
    s = BITWISE_U8_SIZE_PER
    tr[FIX_BITWISE_OP0][s : 2 * s] = a
    tr[FIX_BITWISE_OP1][s : 2 * s] = b
    tr[FIX_BITWISE_RES][s : 2 * s] = a | b
    tr[FIX_TAG][s : 2 * s] = Opcode.OR.mask
    tr[FIX_BITWISE_OP0][2 * s : 3 * s] = a
    tr[FIX_BITWISE_OP1][2 * s : 3 * s] = b
    tr[FIX_BITWISE_RES][2 * s : 3 * s] = a ^ b
    tr[FIX_TAG][2 * s : 3 * s] = Opcode.XOR.mask

    # compress challenge from the limb columns (generation/builtin.rs:117-128)
    challenger = Challenger()
    for cols in (OP0_LIMBS, OP1_LIMBS, RES_LIMBS):
        for col in cols:
            challenger.observe_array(tr[col])
    beta = challenger.get_challenge()

    b1 = np.uint64(beta)
    b2 = np.uint64(gl.mul(beta, beta))
    b3 = np.uint64(gl.mul(gl.mul(beta, beta), beta))
    for j in range(4):
        tr[COMPRESS_LIMBS[j]] = gl.add_arr(
            gl.add_arr(
                gl.add_arr(tr[TAG], gl.mul_arr(tr[OP0_LIMBS[j]], b1)),
                gl.mul_arr(tr[OP1_LIMBS[j]], b2),
            ),
            gl.mul_arr(tr[RES_LIMBS[j]], b3),
        )
    tr[FIX_COMPRESS] = gl.add_arr(
        gl.add_arr(
            gl.add_arr(tr[FIX_TAG], gl.mul_arr(tr[FIX_BITWISE_OP0], b1)),
            gl.mul_arr(tr[FIX_BITWISE_OP1], b2),
        ),
        gl.mul_arr(tr[FIX_BITWISE_RES], b3),
    )

    for j in range(4):
        tr[OP0_LIMBS_PERMUTED[j]], tr[FIX_RANGE_CHECK_U8_PERMUTED[j]] = permuted_cols(
            tr[OP0_LIMBS[j]], tr[FIX_RANGE_CHECK_U8]
        )
        tr[OP1_LIMBS_PERMUTED[j]], tr[FIX_RANGE_CHECK_U8_PERMUTED[4 + j]] = permuted_cols(
            tr[OP1_LIMBS[j]], tr[FIX_RANGE_CHECK_U8]
        )
        tr[RES_LIMBS_PERMUTED[j]], tr[FIX_RANGE_CHECK_U8_PERMUTED[8 + j]] = permuted_cols(
            tr[RES_LIMBS[j]], tr[FIX_RANGE_CHECK_U8]
        )
        tr[COMPRESS_PERMUTED[j]], tr[FIX_COMPRESS_PERMUTED[j]] = permuted_cols(
            tr[COMPRESS_LIMBS[j]], tr[FIX_COMPRESS]
        )
    return tr, beta


class BitwiseStark(Stark):
    COLUMNS = COL_NUM_BITWISE

    def __init__(self):
        self.compress_challenge = None

    def constraint_degree(self):
        return 3

    def eval_packed(self, lv, nv, c):
        F = c.F
        base = 1 << 8
        for val_col, limb_cols in ((OP0, OP0_LIMBS), (OP1, OP1_LIMBS), (RES, RES_LIMBS)):
            s = F.constant(0)
            for j in range(3, -1, -1):
                s = F.add(F.scalar_mul(s, base), lv[limb_cols[j]])
            c.constraint(F.sub(s, lv[val_col]))

        beta = int(self.compress_challenge)
        b2 = gl.mul(beta, beta)
        b3 = gl.mul(b2, beta)
        for j in range(4):
            compressed = F.add_many([
                lv[TAG],
                F.scalar_mul(lv[OP0_LIMBS[j]], beta),
                F.scalar_mul(lv[OP1_LIMBS[j]], b2),
                F.scalar_mul(lv[RES_LIMBS[j]], b3),
            ])
            c.constraint(F.sub(compressed, lv[COMPRESS_LIMBS[j]]))

        for j in range(4):
            eval_lookups(lv, nv, c, OP0_LIMBS_PERMUTED[j], FIX_RANGE_CHECK_U8_PERMUTED[j])
        for j in range(4):
            eval_lookups(lv, nv, c, OP1_LIMBS_PERMUTED[j], FIX_RANGE_CHECK_U8_PERMUTED[4 + j])
        for j in range(4):
            eval_lookups(lv, nv, c, RES_LIMBS_PERMUTED[j], FIX_RANGE_CHECK_U8_PERMUTED[8 + j])
        for j in range(4):
            eval_lookups(lv, nv, c, COMPRESS_PERMUTED[j], FIX_COMPRESS_PERMUTED[j])

    def permutation_pairs(self):
        return (
            [PermutationPair.singletons(COMPRESS_LIMBS[j], COMPRESS_PERMUTED[j])
             for j in range(4)]
            + [PermutationPair.singletons(FIX_COMPRESS, FIX_COMPRESS_PERMUTED[j])
               for j in range(4)]
        )


def ctl_data_with_cpu():
    return Column.singles([TAG, OP0, OP1, RES])


def ctl_filter_with_cpu():
    return Column.single(FILTER)
