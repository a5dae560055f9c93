"""Carried from olavm_tpu/runtime/process.py: the card has no jax, so this copy imports
only jax-free modules; its code is unchanged.

The VM fetch-decode-execute loop with full trace recording.

Re-implements the reference Process (executor/src/lib.rs:220-2310): per-cycle
dispatch on decoded asm text, register-selector bookkeeping for the CPU
table, memory/tape/storage journaling, builtin-row emission, prophet
invocation, and the end-of-run table finalizers.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import Optional

from ..field import goldilocks as g
from ..hash import poseidon as pos
from ..interpreter.prophet import HEAP_PTR, ProphetInterpreter
from ..isa.instruction import decode_to_asm, instruction_length
from ..isa.opcodes import FP_REG, NUM_REGISTERS, Opcode
from ..runtime.memory import (
    HP_START_ADDR,
    MEM_READ,
    MEM_READ_WRITE,
    MEM_WRITE,
    MEM_WRITE_ONCE,
    MemoryTree,
    PSP_START_ADDR,
    StorageTree,
    TapeTree,
    region_flags,
)
from ..runtime.trace import (
    PoseidonChunkRow,
    PoseidonRow,
    RegisterSelector,
    SCCallRow,
    Step,
    Trace,
)

TREE_VALUE_LEN = 4
U32_MAX = 0xFFFFFFFF

PROPHET_INPUT_REG_START = 1
PROPHET_INPUT_REG_CNT = 3
PROPHET_INPUT_FP_START_OFFSET = 3


class ProcessorError(Exception):
    pass


class AssertFail(ProcessorError):
    pass


class U32RangeCheckFail(ProcessorError):
    pass


@dataclass
class Program:
    """Runtime program: bytecode lines + prophets + accumulating trace."""

    instructions: list[str]  # hex word strings
    prophets: dict[int, dict] = dfield(default_factory=dict)
    trace: Trace = dfield(default_factory=Trace)
    debug_info: Optional[dict] = None
    print_flag: bool = False
    pre_exe_flag: bool = False

    @staticmethod
    def from_binary_program(bp) -> "Program":
        return Program(
            instructions=[line.strip() for line in bp.bytecode.split("\n")],
            prophets={p.host: p.to_json() for p in bp.prophets},
            debug_info=bp.debug_info,
        )


def gen_program_hash_rows(program, words):
    """Program-code sponge PoseidonRows (zk-vm/src/lib.rs:404 get_code path);
    shared by the Python executor prologue and the fast harness."""
    from ..hash.poseidon import _native

    native = _native()
    if native is not None and words:
        import numpy as np

        _, raw = native.arbitrary_sponge_trace(np.array(words, dtype=np.uint64))
        for r in raw:
            program.trace.builtin_poseidon.append(
                PoseidonRow(
                    input=tuple(int(x) for x in r[0:12]),
                    full_0_1=tuple(int(x) for x in r[12:24]),
                    full_0_2=tuple(int(x) for x in r[24:36]),
                    full_0_3=tuple(int(x) for x in r[36:48]),
                    partial=tuple(int(x) for x in r[48:70]),
                    full_1_0=tuple(int(x) for x in r[70:82]),
                    full_1_1=tuple(int(x) for x in r[82:94]),
                    full_1_2=tuple(int(x) for x in r[94:106]),
                    full_1_3=tuple(int(x) for x in r[106:118]),
                    output=tuple(int(x) for x in r[118:130]),
                    filter_looked_normal=True,
                )
            )
    else:
        _, rows = pos.arbitrary_poseidon_np(words, with_rows=True)
        for r in rows:
            program.trace.builtin_poseidon.append(
                _poseidon_row_from_trace(
                    r["input"], r["output"], r, filter_looked_normal=True
                )
            )


def _poseidon_row_from_trace(inp, out, tr, **filters) -> PoseidonRow:
    return PoseidonRow(
        input=tuple(int(x) for x in inp),
        full_0_1=tuple(int(x) for x in tr["full_0_1"]),
        full_0_2=tuple(int(x) for x in tr["full_0_2"]),
        full_0_3=tuple(int(x) for x in tr["full_0_3"]),
        partial=tuple(int(x) for x in tr["partial"]),
        full_1_0=tuple(int(x) for x in tr["full_1_0"]),
        full_1_1=tuple(int(x) for x in tr["full_1_1"]),
        full_1_2=tuple(int(x) for x in tr["full_1_2"]),
        full_1_3=tuple(int(x) for x in tr["full_1_3"]),
        output=tuple(int(x) for x in out),
        **filters,
    )


def poseidon_with_row(state12: list[int], **filters) -> tuple[list[int], PoseidonRow]:
    import numpy as np

    from ..hash.poseidon import _native

    inp = np.array(state12, dtype=np.uint64)
    native = _native()
    if native is not None:
        outs, traces = native.permute_batch_trace(inp.reshape(1, 12))
        return (
            outs[0].tolist(),
            _row_from_native(inp, outs[0], traces[0], **filters),
        )
    out, tr = pos.permute_np(inp, with_trace=True)
    return [int(x) for x in out], _poseidon_row_from_trace(inp, out, tr, **filters)


def _row_from_native(inp, out, t, **filters) -> PoseidonRow:
    """PoseidonRow from a native trace lane ((12,), (12,), (106,)).
    .tolist() (C loop -> Python ints) instead of per-element int() genexprs:
    the SMT hashes tens of thousands of these per block."""
    tl = t.tolist()
    return PoseidonRow(
        input=tuple(inp.tolist()),
        full_0_1=tuple(tl[0:12]),
        full_0_2=tuple(tl[12:24]),
        full_0_3=tuple(tl[24:36]),
        partial=tuple(tl[36:58]),
        full_1_0=tuple(tl[58:70]),
        full_1_1=tuple(tl[70:82]),
        full_1_2=tuple(tl[82:94]),
        full_1_3=tuple(tl[94:106]),
        output=tuple(out.tolist()),
        **filters,
    )


def poseidon_rows_batch(states, **filters) -> tuple:
    """Batched poseidon_with_row: (n, 12) states -> (outs (n,12) u64,
    [PoseidonRow]*n). One native call for the whole batch."""
    import numpy as np

    from ..hash.poseidon import _native

    states = np.ascontiguousarray(states, dtype=np.uint64)
    native = _native()
    if native is not None:
        outs, traces = native.permute_batch_trace(states)
        rows = [
            _row_from_native(states[i], outs[i], traces[i], **filters)
            for i in range(states.shape[0])
        ]
        return outs, rows
    outs = []
    rows = []
    for i in range(states.shape[0]):
        o, r = poseidon_with_row(states[i].tolist(), **filters)
        outs.append(o)
        rows.append(r)
    return np.asarray(outs, dtype=np.uint64), rows


def hashed_storage_key(address: tuple, slot_key: tuple) -> tuple[tuple, PoseidonRow]:
    """StorageKey::raw_hashed_key (core/src/types/storage/mod.rs:37-46)."""
    state = list(address) + list(slot_key) + [0, 0, 0, 0]
    out, row = poseidon_with_row(state, filter_looked_treekey=True)
    return tuple(out[:4]), row


class VMState:
    pass


@dataclass
class ExeEnd(VMState):
    end_step: Optional[Step] = None


@dataclass
class SCCall(VMState):
    callee: tuple
    is_delegate: bool


class Process:
    def __init__(self):
        self.block_timestamp = 0
        self.env_idx = 0
        self.call_sc_cnt = 0
        self.clk = 0
        self.addr_storage = (0, 0, 0, 0)
        self.addr_code = (0, 0, 0, 0)
        self.registers = [0] * NUM_REGISTERS
        self.register_selector = RegisterSelector()
        self.pc = 0
        self.instruction = 0
        self.immediate_data = 0
        self.opcode = 0
        self.op1_imm = 0
        self.memory = MemoryTree()
        self.psp = PSP_START_ADDR
        self.psp_start = PSP_START_ADDR
        self.hp = HP_START_ADDR
        self.storage = StorageTree()
        self.storage_log: list = []  # WitnessStorageLog equivalents
        self.program_log: list = []
        self.tp = 0
        self.tape = TapeTree()
        self.storage_access_idx = 0
        self.storage_queries: list = []
        self.return_data: list[int] = []

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _operand(self, tok: str) -> tuple[int, Optional[int]]:
        """Returns (value, reg_index or None for immediates). r255 is the
        REG_NOT_USED sentinel meaning psp_start (lib.rs:306-311)."""
        if tok.startswith("r") and tok[1:].isdigit():
            idx = int(tok[1:])
            if idx == 255:
                return self.psp_start, None
            return self.registers[idx], idx
        return int(tok) % g.P, None

    def _mem_read(self, addr: int, opcode: Opcode, filter_main: int = 1) -> int:
        is_rw, rp, rh = region_flags(addr)
        return self.memory.read(
            addr, self.clk, 1 << opcode.shift, is_rw, MEM_READ, filter_main,
            rp, rh, self.env_idx,
        )

    def _mem_write(self, addr: int, value: int, opcode: Opcode, allow_prophet=False):
        if addr >= PSP_START_ADDR and not allow_prophet:
            raise ProcessorError(f"write to write-once region at {addr}")
        is_rw, rp, rh = region_flags(addr)
        self.memory.write(
            addr, self.clk, 1 << opcode.shift, is_rw, MEM_WRITE, 1,
            rp, rh, value, self.env_idx,
        )

    def _set_op1(self, value: int, reg: Optional[int]):
        self.register_selector.op1 = value
        if reg is not None:
            self.register_selector.op1_reg_sel[reg] = 1

    def _set_op0_reg(self, idx: int):
        self.register_selector.op0 = self.registers[idx]
        self.register_selector.op0_reg_sel[idx] = 1

    def _set_dst_reg(self, idx: int):
        self.register_selector.dst = self.registers[idx]
        self.register_selector.dst_reg_sel[idx] = 1

    # ------------------------------------------------------------------
    # instruction handlers (each mirrors executor/src/lib.rs execute_inst_*)
    # ------------------------------------------------------------------

    def _inst_mov_not(self, ops, step):
        dst = int(ops[1][1:])
        value, reg = self._operand(ops[2])
        self._set_op1(value, reg)
        if ops[0] == "mov":
            self.registers[dst] = value
            self.opcode = 1 << Opcode.MOV.shift
        else:  # not
            self.registers[dst] = g.sub(g.P - 1, value)
            self.opcode = 1 << Opcode.NOT.shift
        self._set_dst_reg(dst)
        self.pc += step

    def _inst_eq_neq(self, ops, step):
        dst = int(ops[1][1:])
        op0 = int(ops[2][1:])
        value, reg = self._operand(ops[3])
        self._set_op0_reg(op0)
        self._set_op1(value, reg)
        diff = g.sub(self.registers[op0], value)
        self.register_selector.aux0 = g.inv(diff) if diff else 0
        if ops[0] == "eq":
            self.registers[dst] = int(self.registers[op0] == value)
            self.opcode = 1 << Opcode.EQ.shift
        else:
            self.registers[dst] = int(self.registers[op0] != value)
            self.opcode = 1 << Opcode.NEQ.shift
        self._set_dst_reg(dst)
        self.pc += step

    def _inst_assert(self, ops, step):
        value, reg = self._operand(ops[1])
        self._set_op1(value, reg)
        if value != 1:
            raise AssertFail(f"assert failed: reg r{reg} value {value}")
        self.opcode = 1 << Opcode.ASSERT.shift
        self.pc += step

    def _inst_cjmp(self, ops, step):
        op0 = int(ops[1][1:])
        value, reg = self._operand(ops[2])
        if self.registers[op0] == 1:
            self.pc = value
        else:
            self.pc += step
        self.opcode = 1 << Opcode.CJMP.shift
        self._set_op0_reg(op0)
        self._set_op1(value, reg)

    def _inst_jmp(self, ops):
        value, reg = self._operand(ops[1])
        self.opcode = 1 << Opcode.JMP.shift
        self.pc = value
        self._set_op1(value, reg)

    def _inst_arith(self, ops, step):
        dst = int(ops[1][1:])
        op0 = int(ops[2][1:])
        value, reg = self._operand(ops[3])
        self._set_op0_reg(op0)
        self._set_op1(value, reg)
        if ops[0] == "add":
            self.registers[dst] = g.add(self.registers[op0], value)
            self.opcode = 1 << Opcode.ADD.shift
        else:  # mul
            self.registers[dst] = g.mul(self.registers[op0], value)
            self.opcode = 1 << Opcode.MUL.shift
        self._set_dst_reg(dst)
        self.pc += step

    def _inst_call(self, ops, step):
        value, reg = self._operand(ops[1])
        fp = self.registers[FP_REG]
        next_pc = self.pc + step
        self._mem_write(fp - 1, next_pc, Opcode.CALL)
        self.opcode = 1 << Opcode.CALL.shift
        self.register_selector.op0 = g.sub(fp, 1)
        self.register_selector.dst = next_pc
        self.register_selector.op1 = value
        if reg is not None:
            self.register_selector.op1_reg_sel[reg] = 1
        self.register_selector.aux0 = g.sub(fp, 2)
        self.register_selector.aux1 = self._mem_read(fp - 2, Opcode.CALL)
        self.pc = value

    def _inst_ret(self, ops):
        self.opcode = 1 << Opcode.RET.shift
        fp = self.registers[FP_REG]
        self.register_selector.op0 = g.sub(fp, 1)
        self.register_selector.aux0 = g.sub(fp, 2)
        self.pc = self._mem_read(fp - 1, Opcode.RET)
        self.registers[FP_REG] = self._mem_read(fp - 2, Opcode.RET)
        self.register_selector.dst = self.pc
        self.register_selector.aux1 = self.registers[FP_REG]

    def _inst_mstore(self, ops, step):
        # forms: mstore rX off rD | mstore rX rY factor rD
        op0_val, op0_reg = self._operand(ops[1])
        self.register_selector.op0 = op0_val
        if op0_reg is None:
            raise ProcessorError("mstore op0 must be a reg")
        self.register_selector.op0_reg_sel[op0_reg] = 1
        if len(ops) == 4:
            offset = int(ops[2])
            self.op1_imm = 1
            self.register_selector.op1 = offset
            self.register_selector.aux0 = 0
            dst = int(ops[3][1:])
        else:
            op1_reg = int(ops[2][1:])
            self.register_selector.op1 = self.registers[op1_reg]
            self.register_selector.op1_reg_sel[op1_reg] = 1
            factor = int(ops[3])
            self.register_selector.aux0 = factor
            offset = g.mul(factor, self.registers[op1_reg])
            self.op1_imm = 0
            dst = int(ops[4][1:])
        self._set_dst_reg(dst)
        addr = g.add(op0_val, offset)
        self.register_selector.aux1 = addr
        self._mem_write(addr, self.registers[dst], Opcode.MSTORE)
        self.opcode = 1 << Opcode.MSTORE.shift
        self.pc += step

    def _inst_mload(self, ops, step):
        dst = int(ops[1][1:])
        op0_val, op0_reg = self._operand(ops[2])
        if op0_reg is None:
            raise ProcessorError("mload op0 must be a reg")
        self.register_selector.op0_reg_sel[op0_reg] = 1
        self.register_selector.op0 = op0_val
        if len(ops) == 4:
            offset = int(ops[3])
            self.op1_imm = 1
            self.register_selector.op1 = offset
            self.register_selector.aux0 = 0
        else:
            op1_reg = int(ops[3][1:])
            self.register_selector.op1 = self.registers[op1_reg]
            self.register_selector.op1_reg_sel[op1_reg] = 1
            factor = int(ops[4])
            self.register_selector.aux0 = factor
            offset = g.mul(factor, self.registers[op1_reg])
            self.op1_imm = 0
        addr = g.add(op0_val, offset)
        self.register_selector.aux1 = addr
        self.registers[dst] = self._mem_read(addr, Opcode.MLOAD)
        self.opcode = 1 << Opcode.MLOAD.shift
        self._set_dst_reg(dst)
        self.pc += step

    def _inst_range(self, program, ops, step):
        op1 = int(ops[1][1:])
        if self.registers[op1] > U32_MAX:
            raise U32RangeCheckFail(f"range check failed: {self.registers[op1]}")
        if not program.pre_exe_flag:
            self.opcode = 1 << Opcode.RC.shift
            self.register_selector.op1 = self.registers[op1]
            self.register_selector.op1_reg_sel[op1] = 1
            program.trace.insert_rangecheck(self.registers[op1], (0, 1, 0, 0, 0))
        self.pc += step

    def _inst_bitwise(self, program, ops, step):
        dst = int(ops[1][1:])
        op0 = int(ops[2][1:])
        value, reg = self._operand(ops[3])
        self._set_op0_reg(op0)
        self._set_op1(value, reg)
        a = self.registers[op0]
        if ops[0] == "and":
            res = a & value
            opc = Opcode.AND
        elif ops[0] == "or":
            res = a | value
            opc = Opcode.OR
        else:
            res = a ^ value
            opc = Opcode.XOR
        self.registers[dst] = res
        self.opcode = 1 << opc.shift
        if not program.pre_exe_flag:
            self._set_dst_reg(dst)
            program.trace.insert_bitwise(1 << opc.shift, a, value, res)
        self.pc += step

    def _inst_gte(self, program, ops, step):
        dst = int(ops[1][1:])
        op0 = int(ops[2][1:])
        value, reg = self._operand(ops[3])
        self._set_op0_reg(op0)
        self._set_op1(value, reg)
        self.registers[dst] = int(self.registers[op0] >= value)
        self.opcode = 1 << Opcode.GTE.shift
        if not program.pre_exe_flag:
            self._set_dst_reg(dst)
            if self.registers[dst] == 1:
                abs_diff = g.sub(self.register_selector.op0, value)
            else:
                abs_diff = g.sub(value, self.register_selector.op0)
            if abs_diff > U32_MAX:
                raise U32RangeCheckFail(f"gte abs_diff too large: {abs_diff}")
            program.trace.insert_rangecheck(abs_diff, (0, 0, 1, 0, 0))
            program.trace.insert_cmp(
                self.register_selector.op0, value, self.registers[dst], abs_diff, 1
            )
        self.pc += step

    def _inst_end(self, program, pc_status, ctx_regs, regs_status, ctx_code):
        self.opcode = 1 << Opcode.END.shift
        length = 0
        if self.tp > 0:
            length = self.tape.read_without_trace(self.tp - 1)
        if length != 0:
            for i in range(length):
                program.trace.ret.append(
                    self.tape.read_without_trace(self.tp - length - 1 + i)
                )
        end_step = None
        if not program.pre_exe_flag:
            program.trace.exec.append(
                Step(
                    env_idx=self.env_idx,
                    call_sc_cnt=self.call_sc_cnt,
                    clk=self.clk,
                    pc=pc_status,
                    tp=self.tp,
                    addr_storage=ctx_regs,
                    addr_code=ctx_code,
                    instruction=self.instruction,
                    immediate_data=self.immediate_data,
                    opcode=self.opcode,
                    op1_imm=self.op1_imm,
                    regs=tuple(regs_status),
                    register_selector=self.register_selector.copy(),
                    is_ext_line=0,
                    ext_cnt=0,
                    filter_tape_looking=0,
                    storage_access_idx=self.storage_access_idx,
                )
            )
            if self.env_idx != 0:
                self.register_selector.aux0 = self.env_idx
                self.register_selector.aux1 = self.clk
                end_step = Step(
                    env_idx=0,
                    call_sc_cnt=self.call_sc_cnt,
                    clk=0,
                    pc=pc_status,
                    tp=self.tp,
                    addr_storage=(0, 0, 0, 0),
                    addr_code=(0, 0, 0, 0),
                    instruction=self.instruction,
                    immediate_data=self.immediate_data,
                    opcode=self.opcode,
                    op1_imm=self.op1_imm,
                    regs=tuple(self.registers),
                    register_selector=self.register_selector.copy(),
                    is_ext_line=1,
                    ext_cnt=1,
                    filter_tape_looking=0,
                    storage_access_idx=self.storage_access_idx,
                )
        return end_step

    def _aux_step(self, ctx_regs, ctx_code, regs_status, selector, ext_cnt,
                  filter_tape) -> Step:
        return Step(
            env_idx=self.env_idx,
            call_sc_cnt=self.call_sc_cnt,
            clk=self.clk,
            pc=self.pc,
            tp=self.tp,
            addr_storage=ctx_regs,
            addr_code=ctx_code,
            instruction=self.instruction,
            immediate_data=self.immediate_data,
            opcode=self.opcode,
            op1_imm=self.op1_imm,
            regs=tuple(regs_status),
            register_selector=selector,
            is_ext_line=1,
            ext_cnt=ext_cnt,
            filter_tape_looking=filter_tape,
            storage_access_idx=self.storage_access_idx,
        )

    def _inst_sstore(self, program, tx_cache, account_tree, aux_steps, ops, step,
                     ctx_regs, regs_status, ctx_code):
        self.opcode = 1 << Opcode.SSTORE.shift
        op0 = int(ops[1][1:])
        value, reg = self._operand(ops[2])
        self._set_op0_reg(op0)
        self._set_op1(value, reg)
        sel = RegisterSelector()
        sel.op0 = self.register_selector.op0
        sel.op1 = self.register_selector.op1

        key_addr = self.registers[op0]
        val_addr = value
        slot_key = []
        store_value = []
        for i in range(TREE_VALUE_LEN):
            a = key_addr + i
            slot_key.append(self._mem_read(a, Opcode.SSTORE))
            sel.op0_reg_sel[i] = a
            sel.op0_reg_sel[TREE_VALUE_LEN + i] = slot_key[i]
            a = val_addr + i
            store_value.append(self._mem_read(a, Opcode.SSTORE))
            sel.op1_reg_sel[i] = a
            sel.op1_reg_sel[TREE_VALUE_LEN + i] = store_value[i]
        slot_key = tuple(slot_key)
        store_value = tuple(store_value)

        tree_key, hash_row = hashed_storage_key(self.addr_storage, slot_key)
        sel.dst_reg_sel[0:TREE_VALUE_LEN] = list(tree_key)

        is_initial = True
        if tx_cache.get(tree_key) is not None:
            is_initial = True if tree_key not in tx_cache else True
        # previous value: tx cache, else account tree
        if tree_key in tx_cache:
            pre_value = tx_cache[tree_key]
            is_initial = True  # kind decided below by db presence only
        db_val = account_tree.get_leaf(tree_key) if account_tree else None
        if tree_key in tx_cache:
            pre_value = tx_cache[tree_key]
            is_initial = db_val is None
        elif db_val is not None:
            is_initial = False
            pre_value = db_val
        else:
            pre_value = (0, 0, 0, 0)
        kind = "initial" if is_initial else "repeated"

        tx_cache[tree_key] = store_value
        self.storage_queries.append(
            {
                "block_timestamp": self.block_timestamp,
                "kind": kind,
                "contract_addr": self.addr_storage,
                "storage_key": slot_key,
                "pre_value": pre_value,
                "value": store_value,
            }
        )
        self.storage.write(
            self.clk, 1 << Opcode.SSTORE.shift, tree_key, store_value,
            (0, 0, 0, 0), self.env_idx,
        )
        self.storage_access_idx += 1
        if not program.pre_exe_flag:
            self.storage_log.append(
                {"kind": kind, "key": tree_key, "value": store_value}
            )
            program.trace.builtin_poseidon.append(hash_row)
            aux_steps.append(
                self._aux_step(ctx_regs, ctx_code, regs_status, sel, 1, 0)
            )
        self.pc += step

    def _inst_sload(self, program, tx_cache, account_tree, aux_steps, ops, step,
                    ctx_regs, regs_status, ctx_code):
        self.opcode = 1 << Opcode.SLOAD.shift
        op0 = int(ops[1][1:])
        value, reg = self._operand(ops[2])
        self._set_op0_reg(op0)
        self._set_op1(value, reg)
        sel = RegisterSelector()
        sel.op0 = self.register_selector.op0
        sel.op1 = self.register_selector.op1

        key_addr = self.registers[op0]
        val_addr = value
        slot_key = []
        for i in range(TREE_VALUE_LEN):
            a = key_addr + i
            slot_key.append(self._mem_read(a, Opcode.SLOAD))
            sel.op0_reg_sel[i] = a
            sel.op0_reg_sel[TREE_VALUE_LEN + i] = slot_key[i]
        slot_key = tuple(slot_key)

        tree_key, hash_row = hashed_storage_key(self.addr_storage, slot_key)
        sel.dst_reg_sel[0:TREE_VALUE_LEN] = list(tree_key)

        if tree_key in tx_cache:
            read_value = tx_cache[tree_key]
        else:
            db_val = account_tree.get_leaf(tree_key) if account_tree else None
            read_value = db_val if db_val is not None else (0, 0, 0, 0)

        self.storage_queries.append(
            {
                "block_timestamp": self.block_timestamp,
                "kind": "read",
                "contract_addr": self.addr_storage,
                "storage_key": slot_key,
                "pre_value": read_value,
                "value": read_value,
            }
        )
        for i in range(TREE_VALUE_LEN):
            a = val_addr + i
            self._mem_write(a, read_value[i], Opcode.SLOAD)
            sel.op1_reg_sel[i] = a
            sel.op1_reg_sel[TREE_VALUE_LEN + i] = read_value[i]
        self.storage.read(
            self.clk, 1 << Opcode.SLOAD.shift, tree_key, (0, 0, 0, 0),
            tuple(read_value), self.env_idx,
        )
        self.storage_access_idx += 1
        if not program.pre_exe_flag:
            self.storage_log.append(
                {"kind": "read", "key": tree_key, "value": tuple(read_value)}
            )
            program.trace.builtin_poseidon.append(hash_row)
            aux_steps.append(
                self._aux_step(ctx_regs, ctx_code, regs_status, sel, 1, 0)
            )
        self.pc += step

    def _inst_poseidon(self, program, ops, step):
        self.opcode = 1 << Opcode.POSEIDON.shift
        dst = int(ops[1][1:])
        op0 = int(ops[2][1:])
        op1_value, reg = self._operand(ops[3])
        self._set_op0_reg(op0)
        self._set_op1(op1_value, reg)
        self._set_dst_reg(dst)

        dst_addr = self.registers[dst]
        src_addr = self.registers[op0]
        input_len = op1_value
        assert input_len != 0, "poseidon hash input len should not equal 0"

        state = [0] * 12
        output4 = [0] * 4
        hash_pre = [0] * 12
        if not program.pre_exe_flag:
            program.trace.builtin_poseidon_chunk.append(
                PoseidonChunkRow(
                    env_idx=self.env_idx, clk=self.clk, opcode=self.opcode,
                    dst=self.register_selector.dst, op0=self.register_selector.op0,
                    op1=self.register_selector.op1, acc_cnt=0,
                    value=(0,) * 8, cap=(0,) * 4, hash=(0,) * 12, is_ext_line=0,
                )
            )
        read_ptr = 0
        tail_len = 0
        while True:
            if read_ptr + 8 > input_len:
                tail_len = input_len - read_ptr
                break
            for i in range(8):
                state[i] = self._mem_read(src_addr + read_ptr + i, Opcode.POSEIDON)
            out, row = poseidon_with_row(state, filter_looked_normal=True)
            output4 = out[:4]
            read_ptr += 8
            if not program.pre_exe_flag:
                program.trace.builtin_poseidon_chunk.append(
                    PoseidonChunkRow(
                        env_idx=self.env_idx, clk=self.clk, opcode=self.opcode,
                        dst=self.register_selector.dst,
                        op0=src_addr + read_ptr - 8,
                        op1=input_len, acc_cnt=read_ptr,
                        value=tuple(state[:8]), cap=tuple(hash_pre[8:12]),
                        hash=tuple(out), is_ext_line=1,
                    )
                )
                hash_pre = list(out)
                program.trace.builtin_poseidon.append(row)
            if read_ptr + 8 > input_len:
                tail_len = input_len - read_ptr
                if tail_len != 0:
                    state[tail_len:] = out[tail_len:]
                break
            else:
                state[8:] = out[8:]

        if tail_len != 0:
            for i in range(tail_len):
                state[i] = self._mem_read(src_addr + read_ptr + i, Opcode.POSEIDON)
            out, row = poseidon_with_row(state, filter_looked_normal=True)
            output4 = out[:4]
            if not program.pre_exe_flag:
                program.trace.builtin_poseidon_chunk.append(
                    PoseidonChunkRow(
                        env_idx=self.env_idx, clk=self.clk, opcode=self.opcode,
                        dst=self.register_selector.dst,
                        op0=src_addr + read_ptr,
                        op1=input_len, acc_cnt=read_ptr + tail_len,
                        value=tuple(state[:8]), cap=tuple(hash_pre[8:12]),
                        hash=tuple(out), is_ext_line=1,
                    )
                )
                program.trace.builtin_poseidon.append(row)

        for i in range(4):
            self._mem_write(dst_addr + i, output4[i], Opcode.POSEIDON)
        self.pc += step

    def _tape_copy(self, aux_steps, ctx_regs, ctx_code, regs_status, zone_length,
                   mem_base, tape_base, is_tload, is_tstore):
        ext_cnt = 1
        sel = self.register_selector.copy()
        opc = Opcode.TLOAD if is_tload else Opcode.TSTORE
        for index in range(zone_length):
            mem_addr = mem_base + index
            tape_addr = tape_base + index
            assert tape_addr < g.P, "tape_addr exceeds field order"
            if mem_addr >= PSP_START_ADDR and is_tstore:
                raise ProcessorError("tstore in prophet region")
            is_rw, rp, rh = region_flags(mem_addr)
            sel.aux0 = mem_addr
            sel.op0_reg_sel[0] = tape_addr
            if is_tload:
                value = self.tape.read(tape_addr, self.clk, 1 << opc.shift, 1)
                sel.aux1 = value
                self.memory.write(
                    mem_addr, self.clk, 1 << opc.shift, is_rw, MEM_WRITE, 1,
                    rp, rh, value, self.env_idx,
                )
            else:
                value = self.memory.read(
                    mem_addr, self.clk, 1 << opc.shift, is_rw, MEM_READ, 1,
                    rp, rh, self.env_idx,
                )
                sel.aux1 = value
                self.tape.write(tape_addr, self.clk, 1 << opc.shift, 0, 1, value)
            if is_tstore:
                self.return_data.append(value)
            aux_steps.append(
                self._aux_step(ctx_regs, ctx_code, regs_status, sel.copy(), ext_cnt, 1)
            )
            ext_cnt += 1

    def _inst_tload(self, program, aux_steps, ops, step, ctx_regs, regs_status,
                    ctx_code):
        self.opcode = 1 << Opcode.TLOAD.shift
        dst = int(ops[1][1:])
        op0 = int(ops[2][1:])
        op1_value, reg = self._operand(ops[3])
        self.register_selector.dst = self.registers[dst]
        mem_base = self.registers[dst]
        self.register_selector.aux1 = self.registers[op0]
        self.register_selector.op1 = op1_value
        self.register_selector.dst_reg_sel[dst] = 1
        self.register_selector.op0_reg_sel[op0] = 1
        if reg is not None:
            self.register_selector.op1_reg_sel[reg] = 1
        flag = self.registers[op0]
        if flag == 1:
            tape_base = g.sub(self.tp, op1_value)
            zone_length = op1_value
            self.register_selector.op0 = 1
        elif flag == 0:
            tape_base = op1_value
            zone_length = 1
            self.register_selector.op0 = 0
        else:
            raise ProcessorError(f"tload flag invalid: {flag}")
        self._tape_copy(aux_steps, ctx_regs, ctx_code, regs_status, zone_length,
                        mem_base, tape_base, True, False)
        self.pc += step

    def _inst_tstore(self, aux_steps, ops, step, ctx_regs, regs_status, ctx_code):
        self.opcode = 1 << Opcode.TSTORE.shift
        op0 = int(ops[1][1:])
        op1_value, reg = self._operand(ops[2])
        if reg is not None:
            self.register_selector.op1_reg_sel[reg] = 1
        mem_base = self.registers[op0]
        self.register_selector.op0_reg_sel[op0] = 1
        self.register_selector.op0 = self.registers[op0]
        self.register_selector.op1 = op1_value
        self.register_selector.aux0 = 0
        self.register_selector.aux1 = 0
        tape_base = self.tp
        self._tape_copy(aux_steps, ctx_regs, ctx_code, regs_status, op1_value,
                        mem_base, tape_base, False, True)
        self.tp = g.add(self.tp, op1_value)
        self.pc += step

    def _inst_sccall(self, program, ops, step, pc_status, ctx_regs, regs_status,
                     ctx_code):
        from ..runtime.load_tx import append_caller_callee_addr

        op0 = int(ops[1][1:])
        op1_value, reg = self._operand(ops[2])
        self.opcode = 1 << Opcode.SCCALL.shift
        self._set_op0_reg(op0)
        self._set_op1(op1_value, reg)
        self.register_selector.aux0 = self.call_sc_cnt + 1

        mem_base = self.registers[op0]
        callee = tuple(
            self._mem_read(mem_base + i, Opcode.SCCALL) for i in range(4)
        )
        tp_status = self.tp  # tape offset the ext line's CTL view points at
        if op1_value == 1:
            callee_exe = self.addr_storage
        elif op1_value == 0:
            callee_exe = callee
        else:
            raise ProcessorError("sccall op1 must be 0 or 1")
        append_caller_callee_addr(self, self.addr_storage, callee, callee_exe)

        if not program.pre_exe_flag:
            program.trace.sc_call.append(
                SCCallRow(
                    caller_env_idx=self.env_idx,
                    addr_storage=self.addr_storage,
                    addr_code=self.addr_code,
                    # the cpu ext line's OP1_IMM flag (the CTL view reads COL_OP1_IMM;
                    # the reference stores the op1 VALUE here which breaks its
                    # own cpu<->sccall lookup for op1=0 calls)
                    caller_op1_imm=self.op1_imm,
                    clk_caller_call=self.clk,
                    clk_caller_ret=self.clk + 1,
                    regs=tuple(regs_status),
                    callee_env_idx=self.register_selector.aux0,
                    clk_callee_end=0,
                )
            )
            program.trace.exec.append(
                Step(
                    env_idx=self.env_idx, call_sc_cnt=self.call_sc_cnt,
                    clk=self.clk, pc=pc_status, tp=tp_status,
                    addr_storage=ctx_regs, addr_code=ctx_code,
                    instruction=self.instruction,
                    immediate_data=self.immediate_data, opcode=self.opcode,
                    op1_imm=self.op1_imm, regs=tuple(regs_status),
                    register_selector=self.register_selector.copy(),
                    is_ext_line=0, ext_cnt=0, filter_tape_looking=0,
                    storage_access_idx=self.storage_access_idx,
                )
            )
            # Ext line layout is dictated by the CTL views that read it
            # (ola_stark.rs:146-202 + ctl_cpu_tape): op0/dst/aux0/aux1 carry
            # the four memory addresses of the callee-address read; addr_code
            # carries the callee code address (= the read values); addr_storage
            # carries the callee storage-context address; op0_reg_sel[0..8]
            # carries the CALLER's (addr_storage, addr_code); tp is the tape
            # offset BEFORE the 12 appended address words.
            sel = RegisterSelector()
            sel.op0_reg_sel[0:TREE_VALUE_LEN] = list(ctx_regs)
            sel.op0_reg_sel[TREE_VALUE_LEN : 2 * TREE_VALUE_LEN] = list(ctx_code)
            sel.op0 = mem_base
            sel.dst = mem_base + 1
            sel.aux0 = mem_base + 2
            sel.aux1 = mem_base + 3
            sel.op1 = op1_value
            program.trace.exec.append(
                Step(
                    env_idx=self.env_idx, call_sc_cnt=self.call_sc_cnt,
                    clk=self.clk, pc=pc_status, tp=tp_status,
                    addr_storage=callee_exe, addr_code=callee,
                    instruction=self.instruction,
                    immediate_data=self.immediate_data, opcode=self.opcode,
                    op1_imm=self.op1_imm, regs=tuple(regs_status),
                    register_selector=sel, is_ext_line=1, ext_cnt=1,
                    filter_tape_looking=0,
                    storage_access_idx=self.storage_access_idx,
                )
            )
        self.pc += step
        self.clk += 1
        self.return_data.clear()
        return SCCall(callee, is_delegate=(op1_value == 1))

    def _inst_sigcheck(self, program, aux_steps, ops, step, ctx_regs, regs_status,
                       ctx_code):
        from ..runtime.ecdsa import ecdsa_verify

        dst = int(ops[1][1:])
        value, reg = self._operand(ops[2])
        self.register_selector.op1 = value
        if reg is not None:
            self.register_selector.op1_reg_sel[reg] = 1
        self.register_selector.dst_reg_sel[dst] = 1
        base = value
        blocks = []
        for b in range(5):  # msg, pk_x, pk_y, sig_r, sig_s
            vals = []
            for i in range(4):
                a = base + 4 * b + i
                # the reference double-reads each word (MSTORE then SIGCHECK
                # opcodes, executor/src/lib.rs:1999-2040); replicate
                self._mem_read(a, Opcode.MSTORE)
                vals.append(self._mem_read(a, Opcode.SIGCHECK))
            blocks.append(tuple(vals))
        msg, pk_x, pk_y, sig_r, sig_s = blocks
        ok = ecdsa_verify(pk_x, pk_y, sig_r, sig_s, msg)
        self.registers[dst] = int(ok)
        self.opcode = 1 << Opcode.SIGCHECK.shift
        if program.pre_exe_flag:
            sel = RegisterSelector()
            sel.op0_reg_sel[0:4] = list(sig_r)
            sel.op0_reg_sel[4:8] = list(sig_s)
            sel.op1_reg_sel[0:4] = list(msg)
            sel.op1_reg_sel[4:8] = list(pk_x)
            sel.dst_reg_sel[0:4] = list(pk_y)
            aux_steps.append(
                self._aux_step(ctx_regs, ctx_code, regs_status, sel, 1, 0)
            )
            self.register_selector.dst = self.registers[dst]
        self.pc += step

    # ------------------------------------------------------------------
    # prophets
    # ------------------------------------------------------------------

    def _read_prophet_input(self, is_ref: bool, state: dict) -> int:
        if state["reg_index"] < PROPHET_INPUT_REG_START + PROPHET_INPUT_REG_CNT:
            value = self.registers[state["reg_index"]]
            state["reg_index"] += 1
        else:
            value = self.memory.read(
                g.sub(self.registers[FP_REG], state["fp"]), self.clk, 0,
                MEM_READ_WRITE, MEM_READ, 0, 0, 0, self.env_idx,
            )
            state["fp"] += 1
        if is_ref:
            value = self.memory.read(
                value, self.clk, 0, MEM_READ_WRITE, MEM_READ, 0, 0, 0, self.env_idx,
            )
        return value

    def run_prophet(self, prophet: dict):
        values = []
        state = {"reg_index": PROPHET_INPUT_REG_START,
                 "fp": PROPHET_INPUT_FP_START_OFFSET}
        for inp in prophet.get("inputs", []):
            for _ in range(max(1, inp.get("length", 1))):
                values.append(self._read_prophet_input(inp.get("is_ref", False), state))

        def mem_reader(addr):
            cells = self.memory.trace.get(addr)
            return cells[-1].value if cells else 0

        interp = ProphetInterpreter(prophet["code"], mem_reader)
        out = interp.run(prophet, values, [(HEAP_PTR, self.hp)])
        if not out:
            raise ProcessorError("prophet produced no output")
        self.psp_start = self.psp
        self.hp = out[-1] % g.P
        for value in out[:-1]:
            self.memory.write(
                self.psp, 0, 0, MEM_WRITE_ONCE, MEM_WRITE, 0, 1, 0,
                value % g.P, self.env_idx,
            )
            self.psp += 1

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------

    def execute_decode(self, program: Program):
        """Pre-decode all instructions into the trace instruction map."""
        words = [int(s, 16) for s in program.instructions]
        pc = 0
        n = len(words)
        while pc < n:
            imm = words[pc + 1] if pc + 1 < n else None
            text, step = decode_to_asm(words[pc], imm)
            program.trace.raw_binary_instructions.append(program.instructions[pc])
            imm_flag = 1 if step == 2 else 0
            imm_val = 0
            if step == 2:
                program.trace.raw_binary_instructions.append(
                    program.instructions[pc + 1]
                )
                imm_val = words[pc + 1]
            program.trace.instructions[pc] = (text, imm_flag, step, words[pc], imm_val)
            pc += step

    def execute(self, program: Program, account_tree=None,
                tx_cache: Optional[dict] = None) -> VMState:
        if tx_cache is None:
            tx_cache = {}
        n_words = len(program.instructions)
        fresh_program = not program.trace.raw_binary_instructions
        if fresh_program:
            self.execute_decode(program)
            # heap pointer init cell
            self.memory.write(
                HP_START_ADDR, 0, 0, MEM_READ_WRITE, MEM_WRITE, 0, 0, 1,
                HP_START_ADDR + 1, self.env_idx,
            )
        assert len(program.trace.raw_binary_instructions) == n_words

        # program-hash sponge rows (one PoseidonRow per rate-8 chunk); only
        # on the first execute of this program (a resumed caller after an
        # sccall return must not re-hash, zk-vm/src/lib.rs:404 get_code=false)
        words = [int(s, 16) for s in program.instructions] if fresh_program else []
        gen_program_hash_rows(program, words)

        end_step = None
        while True:
            self.register_selector = RegisterSelector()
            regs_status = tuple(self.registers)
            ctx_regs = self.addr_storage
            ctx_code = self.addr_code
            pc_status = self.pc
            tp_status = self.tp
            storage_acc_idx_status = self.storage_access_idx
            aux_steps: list[Step] = []

            inst = program.trace.instructions.get(self.pc)
            if inst is None:
                raise ProcessorError(f"invalid pc visit {self.pc}")
            text, imm_flag, step, inst_encode, imm_val = inst
            ops = text.split()
            opcode_tok = ops[0]
            self.op1_imm = imm_flag
            self.instruction = inst_encode
            self.immediate_data = imm_val

            if opcode_tok in ("mov", "not"):
                self._inst_mov_not(ops, step)
            elif opcode_tok in ("eq", "neq"):
                self._inst_eq_neq(ops, step)
            elif opcode_tok == "assert":
                self._inst_assert(ops, step)
            elif opcode_tok == "cjmp":
                self._inst_cjmp(ops, step)
            elif opcode_tok == "jmp":
                self._inst_jmp(ops)
            elif opcode_tok in ("add", "mul"):
                self._inst_arith(ops, step)
            elif opcode_tok == "call":
                self._inst_call(ops, step)
            elif opcode_tok == "ret":
                self._inst_ret(ops)
            elif opcode_tok == "mstore":
                self._inst_mstore(ops, step)
            elif opcode_tok == "mload":
                self._inst_mload(ops, step)
            elif opcode_tok == "range":
                self._inst_range(program, ops, step)
            elif opcode_tok in ("and", "or", "xor"):
                self._inst_bitwise(program, ops, step)
            elif opcode_tok == "gte":
                self._inst_gte(program, ops, step)
            elif opcode_tok == "end":
                end_step = self._inst_end(
                    program, pc_status, ctx_regs, regs_status, ctx_code
                )
                break
            elif opcode_tok == "sstore":
                self._inst_sstore(program, tx_cache, account_tree, aux_steps, ops,
                                  step, ctx_regs, regs_status, ctx_code)
            elif opcode_tok == "sload":
                self._inst_sload(program, tx_cache, account_tree, aux_steps, ops,
                                 step, ctx_regs, regs_status, ctx_code)
            elif opcode_tok == "poseidon":
                self._inst_poseidon(program, ops, step)
            elif opcode_tok == "tload":
                self._inst_tload(program, aux_steps, ops, step, ctx_regs,
                                 regs_status, ctx_code)
            elif opcode_tok == "tstore":
                self._inst_tstore(aux_steps, ops, step, ctx_regs, regs_status,
                                  ctx_code)
            elif opcode_tok == "sccall":
                return self._inst_sccall(program, ops, step, pc_status, ctx_regs,
                                         regs_status, ctx_code)
            elif opcode_tok == "sigcheck":
                self._inst_sigcheck(program, aux_steps, ops, step, ctx_regs,
                                    regs_status, ctx_code)
            else:
                raise ProcessorError(f"unknown opcode {opcode_tok}")

            if pc_status in program.prophets:
                self.run_prophet(program.prophets[pc_status])

            if not program.pre_exe_flag:
                program.trace.exec.append(
                    Step(
                        env_idx=self.env_idx, call_sc_cnt=self.call_sc_cnt,
                        clk=self.clk, pc=pc_status, tp=tp_status,
                        addr_storage=ctx_regs, addr_code=ctx_code,
                        instruction=self.instruction,
                        immediate_data=self.immediate_data, opcode=self.opcode,
                        op1_imm=self.op1_imm, regs=regs_status,
                        register_selector=self.register_selector,
                        is_ext_line=0, ext_cnt=0, filter_tape_looking=0,
                        storage_access_idx=storage_acc_idx_status,
                    )
                )
                program.trace.exec.extend(aux_steps)

            if self.pc >= n_words:
                break
            self.clk += 1

        from .finalize import gen_memory_table, gen_tape_table

        gen_memory_table(self, program)
        gen_tape_table(self, program)
        return ExeEnd(end_step)
