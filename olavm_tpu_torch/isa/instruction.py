"""Carried from olavm_tpu/isa/instruction.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

Binary instruction word encode/decode.

Word layout (core/src/program/instruction.rs:6-20, binary_program.rs:82-315):
  bit 62        op1-is-immediate flag
  bits 52..61   op0 register one-hot
  bits 42..51   op1 register one-hot
  bits 32..41   dst register one-hot
  bits 6..31    opcode one-hot
Instructions are 1 word, or 2 words when an immediate / offset / factor
follows (the second word is the immediate, canonical field element).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..field import goldilocks as g
from .opcodes import (
    NUM_REGISTERS,
    Opcode,
    SHIFT_TO_OPCODE,
    dst_mask,
    op0_mask,
    op1_mask,
)

IMM_FLAG_BIT = 62


@dataclass
class Operand:
    """One of: imm value, register, register+offset, register*factor, special."""

    kind: str  # "imm" | "reg" | "reg_offset" | "reg_factor" | "special"
    reg: Optional[int] = None
    imm: Optional[int] = None  # canonical field element for imm/offset/factor
    special: Optional[str] = None  # "psp" | "pc"

    @staticmethod
    def from_imm(value: int) -> "Operand":
        return Operand("imm", imm=value % g.P)

    @staticmethod
    def from_reg(reg: int) -> "Operand":
        return Operand("reg", reg=reg)

    @property
    def has_imm_word(self) -> bool:
        return self.kind in ("imm", "reg_offset", "reg_factor")


@dataclass
class Instruction:
    opcode: Opcode
    op0: Optional[Operand] = None
    op1: Optional[Operand] = None
    dst: Optional[Operand] = None
    prophet: Optional[dict] = None

    def binary_length(self) -> int:
        n = 1
        for op in (self.op0, self.op1, self.dst):
            if op is not None and op.has_imm_word:
                n += 1
        return n

    def encode(self) -> list[str]:
        """Returns 1 or 2 hex-string words (bytecode lines)."""
        word = 0
        imm: Optional[int] = None
        is_op1_imm = False

        if self.op0 is not None:
            if self.op0.kind == "reg":
                word |= op0_mask(self.op0.reg)
            elif self.op0.kind == "reg_offset":
                word |= op0_mask(self.op0.reg)
                imm = self.op0.imm
            else:
                raise ValueError(f"op0 cannot be {self.op0.kind}")
        if self.op1 is not None:
            if self.op1.kind == "imm":
                is_op1_imm = True
                imm = self.op1.imm
            elif self.op1.kind == "reg":
                word |= op1_mask(self.op1.reg)
            elif self.op1.kind == "reg_offset":
                word |= op1_mask(self.op1.reg)
                imm = self.op1.imm
            elif self.op1.kind == "reg_factor":
                word |= op1_mask(self.op1.reg)
                imm = self.op1.imm
            elif self.op1.kind == "special":
                if self.opcode != Opcode.MOV:
                    raise ValueError("special reg operand only supported for mov")
            else:
                raise ValueError(f"op1 cannot be {self.op1.kind}")
        if self.dst is not None:
            if self.dst.kind == "reg":
                word |= dst_mask(self.dst.reg)
            elif self.dst.kind == "reg_offset":
                word |= dst_mask(self.dst.reg)
                imm = self.dst.imm
            else:
                raise ValueError(f"dst cannot be {self.dst.kind}")

        if is_op1_imm:
            word |= 1 << IMM_FLAG_BIT
        word |= self.opcode.mask
        out = [f"0x{word:016x}"]
        if imm is not None:
            out.append(f"{imm:#x}")
        return out


def _onehot_reg(word: int, base_shift: int) -> Optional[int]:
    bits = (word >> base_shift) & 0x3FF
    if bits == 0:
        return None
    return bits.bit_length() - 1


def decode_word(word: int) -> tuple[Opcode, bool, Optional[int], Optional[int], Optional[int]]:
    """word -> (opcode, is_op1_imm, op0_reg, op1_reg, dst_reg).

    Opcode selection mirrors the reference: highest set bit of the opcode
    field wins (executor/src/decode.rs:18-36).
    """
    opc_bits = word & 0xFFFFFFFF
    if opc_bits == 0:
        raise ValueError(f"no opcode bit set in word {word:#x}")
    shift = opc_bits.bit_length() - 1
    opcode = SHIFT_TO_OPCODE.get(shift)
    if opcode is None:
        raise ValueError(f"invalid opcode bit {shift} in word {word:#x}")
    is_op1_imm = bool((word >> IMM_FLAG_BIT) & 1)
    op0 = _onehot_reg(word, 52)
    op1 = _onehot_reg(word, 42)
    dst = _onehot_reg(word, 32)
    return opcode, is_op1_imm, op0, op1, dst


def instruction_length(word: int) -> int:
    opcode, is_op1_imm, _, _, _ = decode_word(word)
    if is_op1_imm or opcode in (Opcode.MLOAD, Opcode.MSTORE):
        return 2
    return 1


def decode_to_asm(word: int, imm: Optional[int]) -> tuple[str, int]:
    """Binary word (+optional imm) -> executor asm text + step count,
    mirroring decode_raw_instruction (executor/src/decode.rs:29-212)."""
    opcode, is_op1_imm, op0, op1, dst = decode_word(word)
    tok = opcode.token
    step = 1

    def imm_str():
        nonlocal step
        step = 2
        return str(imm)

    if opcode in (
        Opcode.ADD, Opcode.MUL, Opcode.AND, Opcode.OR, Opcode.XOR,
        Opcode.NEQ, Opcode.GTE, Opcode.EQ, Opcode.TLOAD, Opcode.POSEIDON,
    ):
        third = imm_str() if is_op1_imm else f"r{op1}"
        text = f"{tok} r{dst} r{op0} {third}"
    elif opcode in (Opcode.CJMP, Opcode.TSTORE, Opcode.SCCALL, Opcode.SLOAD, Opcode.SSTORE):
        second = imm_str() if is_op1_imm else f"r{op1}"
        text = f"{tok} r{op0} {second}"
    elif opcode in (Opcode.MOV, Opcode.NOT, Opcode.SIGCHECK):
        # op1 may be absent for `mov rX psp`: the reference prints the
        # REG_NOT_USED sentinel r255 and the executor maps it to psp_start
        # (executor/src/decode.rs:93-107, lib.rs:306-311)
        if is_op1_imm:
            second = imm_str()
        elif op1 is None:
            second = "r255"
        else:
            second = f"r{op1}"
        text = f"{tok} r{dst} {second}"
    elif opcode == Opcode.MSTORE:
        step = 2
        if op0 is None:
            raise ValueError("MSTORE op0 must be a reg")
        if dst is None:
            raise ValueError("MSTORE dst must be a reg")
        if is_op1_imm:
            text = f"{tok} r{op0} {imm} r{dst}"
        elif op1 is not None:
            text = f"{tok} r{op0} r{op1} {imm} r{dst}"
        else:
            raise ValueError("MSTORE op1 must be a reg or immediate")
    elif opcode == Opcode.MLOAD:
        step = 2
        if dst is None:
            raise ValueError("MLOAD dst must be a reg")
        if op0 is None:
            raise ValueError("MLOAD op0 must be a reg")
        if op1 is None and is_op1_imm:
            text = f"{tok} r{dst} r{op0} {imm}"
        elif op1 is not None:
            text = f"{tok} r{dst} r{op0} r{op1} {imm}"
        else:
            raise ValueError("MLOAD op1 must be a reg or immediate")
    elif opcode in (Opcode.ASSERT, Opcode.JMP, Opcode.CALL, Opcode.RC):
        second = imm_str() if is_op1_imm else f"r{op1}"
        text = f"{tok} {second}"
    elif opcode in (Opcode.RET, Opcode.END):
        text = tok
    else:
        raise ValueError(f"unhandled opcode {opcode}")
    return text, step
