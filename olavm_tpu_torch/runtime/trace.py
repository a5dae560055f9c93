"""Carried from olavm_tpu/runtime/trace.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

Execution trace containers: one row type per sub-trace table.

Mirrors the reference trace structs (core/src/trace/trace.rs:66-343) with
plain-int fields (canonical Goldilocks values). These rows feed the per-table
trace generators in olavm_tpu.tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

from ..field import goldilocks as g

REGISTER_NUM = 10
TREE_VALUE_LEN = 4


@dataclass(slots=True)
class RegisterSelector:
    op0: int = 0
    op1: int = 0
    dst: int = 0
    aux0: int = 0
    aux1: int = 0
    op0_reg_sel: list = dfield(default_factory=lambda: [0] * REGISTER_NUM)
    op1_reg_sel: list = dfield(default_factory=lambda: [0] * REGISTER_NUM)
    dst_reg_sel: list = dfield(default_factory=lambda: [0] * REGISTER_NUM)

    def copy(self) -> "RegisterSelector":
        return RegisterSelector(
            self.op0, self.op1, self.dst, self.aux0, self.aux1,
            list(self.op0_reg_sel), list(self.op1_reg_sel), list(self.dst_reg_sel),
        )


@dataclass(slots=True)
class Step:
    env_idx: int
    call_sc_cnt: int
    clk: int
    pc: int
    tp: int
    addr_storage: tuple
    addr_code: tuple
    instruction: int
    immediate_data: int
    opcode: int
    op1_imm: int
    regs: tuple
    register_selector: RegisterSelector
    is_ext_line: int
    ext_cnt: int
    filter_tape_looking: int
    storage_access_idx: int


@dataclass(slots=True)
class MemoryRow:
    env_idx: int
    addr: int
    clk: int
    is_rw: int
    op: int
    is_write: int
    diff_addr: int
    diff_addr_inv: int
    diff_clk: int
    diff_addr_cond: int
    filter_looked_for_main: int
    rw_addr_unchanged: int
    region_prophet: int
    region_heap: int
    value: int
    rc_value: int


@dataclass(slots=True)
class RangeCheckRow:
    val: int
    limb_lo: int
    limb_hi: int
    filter_looked_for_mem_sort: int
    filter_looked_for_mem_region: int
    filter_looked_for_cpu: int
    filter_looked_for_comparison: int
    filter_looked_for_storage: int


@dataclass(slots=True)
class BitwiseRow:
    opcode: int
    op0: int
    op1: int
    res: int
    op0_limbs: tuple  # 4 x u8
    op1_limbs: tuple
    res_limbs: tuple


@dataclass(slots=True)
class CmpRow:
    op0: int
    op1: int
    gte: int
    abs_diff: int
    abs_diff_inv: int
    filter_looking_rc: int


@dataclass(slots=True)
class PoseidonRow:
    """One full permutation with all constrained intermediate states."""

    input: tuple  # 12
    full_0_1: tuple  # 12 (state after constant layer of full round 1)
    full_0_2: tuple
    full_0_3: tuple
    partial: tuple  # 22 sbox inputs
    full_1_0: tuple
    full_1_1: tuple
    full_1_2: tuple
    full_1_3: tuple
    output: tuple  # 12
    filter_looked_normal: bool = False
    filter_looked_treekey: bool = False
    filter_looked_storage: bool = False
    filter_looked_storage_branch: bool = False


@dataclass(slots=True)
class PoseidonChunkRow:
    env_idx: int
    clk: int
    opcode: int
    dst: int
    op0: int
    op1: int
    acc_cnt: int
    value: tuple  # 8
    cap: tuple  # 4
    hash: tuple  # 12
    is_ext_line: int


@dataclass(slots=True)
class StorageRow:
    env_idx: int
    clk: int
    diff_clk: int
    opcode: int
    root: tuple  # 4
    addr: tuple  # 4
    value: tuple  # 4


@dataclass(slots=True)
class StorageHashRow:
    storage_access_idx: int
    pre_root: tuple
    root: tuple
    is_write: int
    layer: int
    layer_bit: int
    addr_acc: int
    addr: tuple
    pre_path: tuple
    path: tuple
    hash_type: int
    pre_hash: tuple
    hash: tuple
    sibling: tuple


@dataclass(slots=True)
class TapeRow:
    is_init: bool
    opcode: int
    addr: int
    value: int
    filter_looked: int


@dataclass(slots=True)
class SCCallRow:
    caller_env_idx: int
    addr_storage: tuple
    addr_code: tuple
    caller_op1_imm: int
    clk_caller_call: int
    clk_caller_ret: int
    regs: tuple
    callee_env_idx: int
    clk_callee_end: int


def split_u8_limbs(v: int) -> tuple:
    """4 x 8-bit limbs of a u32 value (core/src/utils.rs split_limbs_from_field)."""
    return (v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF, (v >> 24) & 0xFF)


def split_u16_limbs(v: int) -> tuple:
    """2 x 16-bit limbs of a u32 value."""
    return (v & 0xFFFF, (v >> 16) & 0xFFFF)


class Trace:
    """Aggregate execution trace (reference Trace, trace.rs:320-343)."""

    def __init__(self):
        # pc -> (asm_str, imm_flag, step, inst_encode, imm_val)
        self.instructions: dict[int, tuple] = {}
        self.raw_binary_instructions: list[str] = []
        self.addr_program_hash: dict[str, list[int]] = {}
        self.start_end_roots: tuple = ((0, 0, 0, 0), (0, 0, 0, 0))
        self.exec: list[Step] = []
        self.memory: list[MemoryRow] = []
        self.builtin_rangecheck: list[RangeCheckRow] = []
        self.builtin_bitwise_combined: list[BitwiseRow] = []
        self.builtin_cmp: list[CmpRow] = []
        self.builtin_poseidon: list[PoseidonRow] = []
        self.builtin_poseidon_chunk: list[PoseidonChunkRow] = []
        self.builtin_storage: list[StorageRow] = []
        self.builtin_storage_hash: list[StorageHashRow] = []
        self.builtin_program_hash: list[StorageHashRow] = []
        self.tape: list[TapeRow] = []
        self.sc_call: list[SCCallRow] = []
        self.ret: list[int] = []

    def insert_rangecheck(self, value: int, filters: tuple):
        """filters = (mem_sort, cpu, comparison, storage, mem_region)."""
        lo, hi = split_u16_limbs(value)
        self.builtin_rangecheck.append(
            RangeCheckRow(
                val=value,
                limb_lo=lo,
                limb_hi=hi,
                filter_looked_for_mem_sort=filters[0],
                filter_looked_for_cpu=filters[1],
                filter_looked_for_comparison=filters[2],
                filter_looked_for_storage=filters[3],
                filter_looked_for_mem_region=filters[4],
            )
        )

    def insert_cmp(self, op0: int, op1: int, gte: int, abs_diff: int, filter_rc: int):
        inv = g.inv(abs_diff) if abs_diff else 0
        self.builtin_cmp.append(CmpRow(op0, op1, gte, abs_diff, inv, filter_rc))

    def insert_bitwise(self, opcode: int, op0: int, op1: int, res: int):
        self.builtin_bitwise_combined.append(
            BitwiseRow(
                opcode, op0, op1, res,
                split_u8_limbs(op0), split_u8_limbs(op1), split_u8_limbs(res),
            )
        )
