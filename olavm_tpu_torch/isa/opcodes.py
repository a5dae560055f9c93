"""Carried from olavm_tpu/isa/opcodes.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

Ola "Algebraic RISC" ISA: 26 opcodes with one-hot bit encoding.

Bit assignments and tokens must match the reference exactly
(core/src/vm/opcodes.rs:7-110): ADD at bit 31 down to
SIGCHECK at bit 6; the opcode field of an instruction word is the one-hot
mask `1 << shift`.
"""

from __future__ import annotations

import enum


class Opcode(enum.Enum):
    ADD = 31
    MUL = 30
    EQ = 29
    ASSERT = 28
    MOV = 27
    JMP = 26
    CJMP = 25
    CALL = 24
    RET = 23
    MLOAD = 22
    MSTORE = 21
    END = 20
    RC = 19
    AND = 18
    OR = 17
    XOR = 16
    NOT = 15
    NEQ = 14
    GTE = 13
    POSEIDON = 12
    SLOAD = 11
    SSTORE = 10
    TLOAD = 9
    TSTORE = 8
    SCCALL = 7
    SIGCHECK = 6

    @property
    def shift(self) -> int:
        return self.value

    @property
    def mask(self) -> int:
        return 1 << self.value

    @property
    def token(self) -> str:
        return _TOKENS[self]


_TOKENS = {op: op.name.lower() for op in Opcode}
_TOKENS[Opcode.RC] = "range"

TOKEN_TO_OPCODE = {tok: op for op, tok in _TOKENS.items()}
SHIFT_TO_OPCODE = {op.value: op for op in Opcode}

# register encoding bit positions (core/src/vm/hardware.rs:35-78):
# rN as op0 -> bit 52+N, as op1 -> bit 42+N, as dst -> bit 32+N
NUM_REGISTERS = 10
FP_REG = 9  # r9 doubles as the frame pointer (executor/src/lib.rs:184)


def op0_mask(reg: int) -> int:
    return 1 << (52 + reg)


def op1_mask(reg: int) -> int:
    return 1 << (42 + reg)


def dst_mask(reg: int) -> int:
    return 1 << (32 + reg)
