"""Carried from olavm_tpu/runtime/fast_executor.py; it compiles the port's own
copy of the executor source (native/gl_executor.cpp) through hostlib.build, and
its code is otherwise unchanged.

Fast executor front-end: drives the native interpreter
(native/gl_executor.cpp) for plain-opcode programs and exports column-major
(SoA) journals for the vectorized trace generators (tables/fast_gen.py).

Replaces the per-step Python loop in runtime/process.py for the benchmark
workloads (reference hot loop: executor/src/lib.rs:2135-2296, ~1-3M steps/s);
programs using storage/poseidon/sccall/sigcheck opcodes are not supported
here and take the Python path. Prophets are supported via pause/resume: the
native loop pauses after a prophet-carrying pc, Python runs the DSL
interpreter against the native memory (recording the same journal cells the
slow path records), then resumes.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field as dfield

import numpy as np

from ..field import goldilocks as g
from ..interpreter.prophet import HEAP_PTR, ProphetInterpreter
from ..isa.opcodes import Opcode
from ..native import hostlib
from ..runtime.memory import HP_START_ADDR, PSP_START_ADDR
from .process import (
    PROPHET_INPUT_FP_START_OFFSET,
    PROPHET_INPUT_REG_CNT,
    PROPHET_INPUT_REG_START,
    ProcessorError,
)

FP_REG = 9

# Op enum (gl_executor.cpp)
_OPS = {
    "add": 0, "mul": 1, "eq": 2, "neq": 3, "assert": 4, "mov": 5, "not": 6,
    "jmp": 7, "cjmp": 8, "call": 9, "ret": 10, "mload": 11, "mstore": 12,
    "range": 13, "and": 14, "or": 15, "xor": 16, "gte": 17, "tload": 18,
    "tstore": 19, "end": 20,
}

_TOK_TO_MASK = {
    "add": Opcode.ADD, "mul": Opcode.MUL, "eq": Opcode.EQ, "neq": Opcode.NEQ,
    "assert": Opcode.ASSERT, "mov": Opcode.MOV, "not": Opcode.NOT,
    "jmp": Opcode.JMP, "cjmp": Opcode.CJMP, "call": Opcode.CALL,
    "ret": Opcode.RET, "mload": Opcode.MLOAD, "mstore": Opcode.MSTORE,
    "range": Opcode.RC, "and": Opcode.AND, "or": Opcode.OR, "xor": Opcode.XOR,
    "gte": Opcode.GTE, "tload": Opcode.TLOAD, "tstore": Opcode.TSTORE,
    "end": Opcode.END,
}

# cpu SoA field indices (gl_executor.cpp CF_*)
CF_CLK, CF_PC, CF_TP, CF_INSTR, CF_IMM, CF_OPCODE, CF_OP1IMM = range(7)
CF_REG0 = 7
CF_OP0, CF_OP1, CF_DST, CF_AUX0, CF_AUX1 = 17, 18, 19, 20, 21
CF_SEL_OP0, CF_SEL_OP1, CF_SEL_DST = 22, 23, 24
CF_IS_EXT, CF_EXT_CNT, CF_FILTER_TAPE, CF_SEL_OP0_VAL0 = 25, 26, 27, 28
CPU_FIELDS = 29

_lib = None
available = False


def _u64p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _load():
    global _lib, available
    lib = ctypes.CDLL(hostlib.build("gl_executor"))
    u64 = ctypes.c_uint64
    u64p = ctypes.POINTER(u64)
    vp = ctypes.c_void_p
    lib.exe_create.restype = vp
    lib.exe_destroy.argtypes = [vp]
    lib.exe_load_code.argtypes = [vp, u64p, u64, u64]
    lib.exe_init_tape.argtypes = [vp] + [u64p] * 6 + [u64, u64]
    lib.exe_set_state.argtypes = [vp, u64p, u64, u64, u64, u64]
    lib.exe_get_state.argtypes = [vp, u64p, u64p]
    lib.exe_mem_read_raw.argtypes = [vp] + [u64] * 7 + [u64p]
    lib.exe_mem_read_raw.restype = ctypes.c_int
    lib.exe_mem_peek.argtypes = [vp, u64, ctypes.POINTER(ctypes.c_int)]
    lib.exe_mem_peek.restype = u64
    lib.exe_mem_write_once.argtypes = [vp, u64, u64]
    lib.exe_run.argtypes = [vp, u64]
    lib.exe_run.restype = ctypes.c_int
    for name in ["exe_n_cpu", "exe_n_rc", "exe_n_bw", "exe_n_cmp", "exe_n_ret",
                 "exe_n_tape"]:
        getattr(lib, name).argtypes = [vp]
        getattr(lib, name).restype = u64
    lib.exe_finalize_memory.argtypes = [vp]
    lib.exe_finalize_memory.restype = u64
    for name in ["exe_export_cpu", "exe_export_rc", "exe_export_bw",
                 "exe_export_cmp", "exe_export_ret", "exe_export_memory",
                 "exe_export_tape"]:
        getattr(lib, name).argtypes = [vp, u64p]
    _lib = lib
    available = True


try:
    _load()
except Exception as _e:  # pragma: no cover
    import warnings

    warnings.warn(f"native gl_executor unavailable: {_e}")


class UnsupportedProgram(Exception):
    pass


def encode_instr_table(program) -> np.ndarray:
    """trace.instructions {(pc): (text, imm_flag, step, word, imm)} ->
    (n, 15) u64 table for exe_load_code. Raises UnsupportedProgram for
    opcodes outside the fast set."""
    rows = []
    for pc, (text, imm_flag, step, word, imm_val) in sorted(
        program.trace.instructions.items()
    ):
        ops = text.split()
        tok = ops[0]
        if tok not in _OPS:
            raise UnsupportedProgram(tok)
        op = _OPS[tok]
        dst = op0 = op1_reg = -1
        imm = 0
        use_imm = 0
        factor = 0
        has_factor = 0

        def reg(tokstr):
            return int(tokstr[1:])

        def val(tokstr):
            nonlocal imm, use_imm, op1_reg
            if tokstr.startswith("r") and tokstr[1:].isdigit():
                op1_reg = int(tokstr[1:])
            else:
                use_imm = 1
                imm = int(tokstr) % g.P

        if tok in ("mov", "not"):
            dst = reg(ops[1])
            val(ops[2])
        elif tok in ("eq", "neq", "add", "mul", "and", "or", "xor", "gte"):
            dst = reg(ops[1])
            op0 = reg(ops[2])
            val(ops[3])
        elif tok == "assert":
            val(ops[1])
        elif tok == "cjmp":
            op0 = reg(ops[1])
            val(ops[2])
        elif tok in ("jmp", "call"):
            val(ops[1])
        elif tok == "ret" or tok == "end":
            pass
        elif tok == "mstore":
            # mstore rX off rD | mstore rX rY factor rD
            op0 = reg(ops[1])
            if len(ops) == 4:
                imm = int(ops[2]) % g.P
                dst = reg(ops[3])
            else:
                op1_reg = reg(ops[2])
                factor = int(ops[3]) % g.P
                has_factor = 1
                dst = reg(ops[4])
        elif tok == "mload":
            dst = reg(ops[1])
            op0 = reg(ops[2])
            if len(ops) == 4:
                imm = int(ops[3]) % g.P
            else:
                op1_reg = reg(ops[3])
                factor = int(ops[4]) % g.P
                has_factor = 1
        elif tok == "range":
            op1_reg = reg(ops[1])
        elif tok == "tload":
            dst = reg(ops[1])
            op0 = reg(ops[2])
            val(ops[3])
        elif tok == "tstore":
            op0 = reg(ops[1])
            val(ops[2])

        mask = _TOK_TO_MASK[tok].mask
        pause = 1 if pc in program.prophets else 0
        rows.append([
            op, dst & 0xFFFFFFFFFFFFFFFF, op0 & 0xFFFFFFFFFFFFFFFF,
            op1_reg & 0xFFFFFFFFFFFFFFFF, imm, use_imm, factor, has_factor,
            step, word, imm_val, imm_flag, mask, pause, pc,
        ])
    return np.array(rows, dtype=np.uint64)


@dataclass
class FastRun:
    cpu: np.ndarray        # (n, CPU_FIELDS)
    mem: np.ndarray        # (n, 16)
    rc: np.ndarray         # (n, 2)
    bw: np.ndarray         # (n, 4)
    cmp: np.ndarray        # (n, 4)
    tape: np.ndarray       # (n, 5): is_init, op, addr, value, filter
    ret: list = dfield(default_factory=list)


class _NativeMemReader:
    """mem_reader for the prophet interpreter: peeks last value (no cell)."""

    def __init__(self, lib, sess):
        self.lib = lib
        self.sess = sess

    def __call__(self, addr):
        ok = ctypes.c_int(0)
        v = self.lib.exe_mem_peek(self.sess, int(addr) % g.P, ctypes.byref(ok))
        return int(v) if ok.value else 0


def execute_fast(program, tape_cells, tp: int, max_steps: int = 1 << 31):
    """Run the native interpreter; returns FastRun. tape_cells: flat list of
    (addr, value, is_init, clk, op, filter) from init_tape."""
    if not available:
        raise UnsupportedProgram("native executor unavailable")
    table = encode_instr_table(program)
    code_len = len(program.trace.raw_binary_instructions)
    sess = _lib.exe_create()
    try:
        _lib.exe_load_code(sess, _u64p(table), len(table), code_len)
        if tape_cells:
            cols = [np.ascontiguousarray(c, dtype=np.uint64)
                    for c in zip(*tape_cells)]
            _lib.exe_init_tape(sess, _u64p(cols[0]), _u64p(cols[1]),
                               _u64p(cols[2]), _u64p(cols[3]), _u64p(cols[4]),
                               _u64p(cols[5]), len(tape_cells), tp)
        regs = np.zeros(10, dtype=np.uint64)
        _lib.exe_set_state(sess, _u64p(regs), 0, 0, tp, PSP_START_ADDR)

        psp = PSP_START_ADDR
        psp_start = PSP_START_ADDR
        hp = HP_START_ADDR
        out4 = np.zeros(4, dtype=np.uint64)
        while True:
            rc = _lib.exe_run(sess, max_steps)
            if rc == 0:
                break
            if rc == 1:  # paused after a prophet-carrying host pc
                _lib.exe_get_state(sess, _u64p(regs), _u64p(out4))
                pc, clk, tp_now = int(out4[0]), int(out4[1]), int(out4[2])
                host_pc = int(out4[3])  # err_addr doubles as pause pc
                prophet = program.prophets[host_pc]
                psp, psp_start, hp = _run_prophet_native(
                    _lib, sess, prophet, regs, clk, psp, hp
                )
                _lib.exe_set_state(sess, _u64p(regs), pc, clk, tp_now,
                                   psp_start)
                continue
            _lib.exe_get_state(sess, _u64p(regs), _u64p(out4))
            raise ProcessorError(
                f"fast executor error {rc} at addr/pc {int(out4[3])}"
            )

        n_cpu = _lib.exe_n_cpu(sess)
        cpu = np.zeros((n_cpu, CPU_FIELDS), dtype=np.uint64)
        _lib.exe_export_cpu(sess, _u64p(cpu))
        n_mem = _lib.exe_finalize_memory(sess)
        if n_mem == 0xFFFFFFFFFFFFFFFF:
            raise ProcessorError("memory rc value exceeds u32")
        mem = np.zeros((n_mem, 16), dtype=np.uint64)
        _lib.exe_export_memory(sess, _u64p(mem))
        n_rc = _lib.exe_n_rc(sess)
        rc_rows = np.zeros((n_rc, 2), dtype=np.uint64)
        _lib.exe_export_rc(sess, _u64p(rc_rows))
        n_bw = _lib.exe_n_bw(sess)
        bw = np.zeros((n_bw, 4), dtype=np.uint64)
        _lib.exe_export_bw(sess, _u64p(bw))
        n_cmp = _lib.exe_n_cmp(sess)
        cmp_rows = np.zeros((n_cmp, 4), dtype=np.uint64)
        _lib.exe_export_cmp(sess, _u64p(cmp_rows))
        n_tape = _lib.exe_n_tape(sess)
        tape = np.zeros((n_tape, 5), dtype=np.uint64)
        _lib.exe_export_tape(sess, _u64p(tape))
        n_ret = _lib.exe_n_ret(sess)
        ret = np.zeros(n_ret, dtype=np.uint64)
        _lib.exe_export_ret(sess, _u64p(ret))
        return FastRun(cpu, mem, rc_rows, bw, cmp_rows, tape,
                       [int(v) for v in ret])
    finally:
        _lib.exe_destroy(sess)


def _run_prophet_native(lib, sess, prophet: dict, regs: np.ndarray, clk: int,
                        psp: int, hp: int):
    """Mirror Process.run_prophet (process.py:949-972) against native memory."""
    values = []
    state = {"reg_index": PROPHET_INPUT_REG_START,
             "fp": PROPHET_INPUT_FP_START_OFFSET}
    out = np.zeros(1, dtype=np.uint64)

    def read_rec(addr):
        rc = lib.exe_mem_read_raw(sess, int(addr) % g.P, clk, 0, 1, 0, 0, 0,
                                  _u64p(out))
        if rc:
            raise ProcessorError(f"prophet mem read fail at {addr}")
        return int(out[0])

    for inp in prophet.get("inputs", []):
        for _ in range(max(1, inp.get("length", 1))):
            if state["reg_index"] < PROPHET_INPUT_REG_START + PROPHET_INPUT_REG_CNT:
                value = int(regs[state["reg_index"]])
                state["reg_index"] += 1
            else:
                value = read_rec(g.sub(int(regs[FP_REG]), state["fp"]))
                state["fp"] += 1
            if inp.get("is_ref", False):
                value = read_rec(value)
            values.append(value)

    interp = ProphetInterpreter(prophet["code"], _NativeMemReader(lib, sess))
    outv = interp.run(prophet, values, [(HEAP_PTR, hp)])
    if not outv:
        raise ProcessorError("prophet produced no output")
    psp_start = psp
    hp = outv[-1] % g.P
    for value in outv[:-1]:
        lib.exe_mem_write_once(sess, psp, value % g.P)
        psp += 1
    return psp, psp_start, hp
