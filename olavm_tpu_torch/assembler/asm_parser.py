"""Carried from olavm_tpu/assembler/asm_parser.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

Ola .asm text parser: rows (instructions / labels) and asm operands.

Grammar matches the reference assembler
(assembler/src/asm.rs, assembler/src/operands.rs):
- `name:` introduces a callable scope label; `.LBLn_m:` a jump label;
  `.PROPHETn_m:` a prophet attachment label; `;` starts a comment.
- operands: `[rX,rY,k]` (factored reg offset), `[rX,rY]` (factor 1),
  `[rX]` (offset 0), `[rX,±n]`, `rX`, `±n` / `0x..`, `.LBLn_m`,
  `psp`/`pc`, bare identifiers (call targets).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

from ..field import goldilocks as g
from ..isa.opcodes import Opcode, TOKEN_TO_OPCODE


def parse_imm(s: str) -> int:
    """ImmediateValue semantics (core/src/vm/operands.rs:159-190)."""
    if s.startswith("0x"):
        v = int(s, 16)
        if v >= g.P:
            raise ValueError(f"immediate overflow: {s}")
        return v
    v = int(s, 10)
    if abs(v) >= g.P:
        raise ValueError(f"immediate overflow: {s}")
    return v % g.P


@dataclass
class AsmOperand:
    kind: str  # imm | reg | reg_offset | reg_factored | special | label | ident
    reg: Optional[int] = None
    offset_reg: Optional[int] = None
    imm: Optional[int] = None
    special: Optional[str] = None
    name: Optional[str] = None

    @property
    def needs_imm_word(self) -> bool:
        return self.kind in ("imm", "reg_offset", "reg_factored", "label", "ident")


_RE_FACTORED = re.compile(r"^\[(r\d),(r\d),([+-]?\d+)\]$")
_RE_REG_REG = re.compile(r"^\[(r\d),(r\d)\]$")
_RE_REG_ONLY = re.compile(r"^\[(r\d)\]$")
_RE_REG_OFF = re.compile(r"^\[(r\d),([+-]?\d+)\]$")
_RE_REG = re.compile(r"^r(\d)$")
_RE_IMM = re.compile(r"^[+-]?\d+$")
_RE_LABEL = re.compile(r"^\.LBL\d+_\d+$")
_RE_IDENT = re.compile(r"^_*[A-Za-z]+\w*$")


def _reg_num(tok: str) -> int:
    n = int(tok[1:])
    if n > 9:
        raise ValueError(f"invalid register {tok}")
    return n


def parse_operand(s: str) -> AsmOperand:
    m = _RE_FACTORED.match(s)
    if m:
        return AsmOperand(
            "reg_factored",
            reg=_reg_num(m.group(1)),
            offset_reg=_reg_num(m.group(2)),
            imm=parse_imm(m.group(3)),
        )
    m = _RE_REG_REG.match(s)
    if m:
        return AsmOperand(
            "reg_factored",
            reg=_reg_num(m.group(1)),
            offset_reg=_reg_num(m.group(2)),
            imm=1,
        )
    m = _RE_REG_ONLY.match(s)
    if m:
        return AsmOperand("reg_offset", reg=_reg_num(m.group(1)), imm=0)
    m = _RE_REG_OFF.match(s)
    if m:
        return AsmOperand(
            "reg_offset", reg=_reg_num(m.group(1)), imm=parse_imm(m.group(2))
        )
    m = _RE_REG.match(s)
    if m:
        return AsmOperand("reg", reg=int(m.group(1)))
    if _RE_IMM.match(s) or s.startswith("0x"):
        return AsmOperand("imm", imm=parse_imm(s))
    if _RE_LABEL.match(s):
        return AsmOperand("label", name=s)
    if s in ("psp", "pc"):
        return AsmOperand("special", special=s)
    if _RE_IDENT.match(s):
        return AsmOperand("ident", name=s)
    raise ValueError(f"invalid asm operand: {s}")


@dataclass
class AsmInstruction:
    asm: str
    opcode: Opcode
    op0: Optional[AsmOperand]
    op1: Optional[AsmOperand]
    dst: Optional[AsmOperand]

    def binary_length(self) -> int:
        n = 1
        for op in (self.op0, self.op1):
            if op is not None and op.needs_imm_word:
                n += 1
        return n


# operand arity/positions per opcode (assembler/src/asm.rs:132-200)
_THREE_OP = {
    Opcode.ADD, Opcode.MUL, Opcode.AND, Opcode.OR, Opcode.XOR,
    Opcode.EQ, Opcode.NEQ, Opcode.GTE, Opcode.TLOAD, Opcode.POSEIDON,
}
_TWO_OP_DST_FIRST = {Opcode.MOV, Opcode.NOT, Opcode.MLOAD, Opcode.SIGCHECK}
_TWO_OP_SRC = {Opcode.MSTORE, Opcode.CJMP, Opcode.TSTORE, Opcode.SCCALL,
               Opcode.SLOAD, Opcode.SSTORE}
_ONE_OP = {Opcode.JMP, Opcode.CALL, Opcode.RC, Opcode.ASSERT}
_ZERO_OP = {Opcode.RET, Opcode.END}


def parse_instruction(line: str) -> AsmInstruction:
    text = line.split(";")[0].strip()
    pieces = text.split()
    if not pieces:
        raise ValueError(f"empty asm line: {line!r}")
    opcode = TOKEN_TO_OPCODE.get(pieces[0])
    if opcode is None:
        raise ValueError(f"invalid opcode token: {pieces[0]}")
    ops = [parse_operand(p) for p in pieces[1:]]

    if opcode in _THREE_OP:
        if len(ops) != 3:
            raise ValueError(f"invalid operand count: {line}")
        dst, op0, op1 = ops
        return AsmInstruction(text, opcode, op0, op1, dst)
    if opcode in _TWO_OP_DST_FIRST:
        if len(ops) != 2:
            raise ValueError(f"invalid operand count: {line}")
        dst, op1 = ops
        return AsmInstruction(text, opcode, None, op1, dst)
    if opcode in _TWO_OP_SRC:
        if len(ops) != 2:
            raise ValueError(f"invalid operand count: {line}")
        op0, op1 = ops
        return AsmInstruction(text, opcode, op0, op1, None)
    if opcode in _ONE_OP:
        if len(ops) != 1:
            raise ValueError(f"invalid operand count: {line}")
        return AsmInstruction(text, opcode, None, ops[0], None)
    if opcode in _ZERO_OP:
        if ops:
            raise ValueError(f"invalid operand count: {line}")
        return AsmInstruction(text, opcode, None, None, None)
    raise ValueError(f"unhandled opcode {opcode}")


_RE_LABEL_CALL = re.compile(r"^(\w+):$")
_RE_LABEL_JMP = re.compile(r"^(\.LBL\d+_\d+):$")
_RE_LABEL_PROPHET = re.compile(r"^(\.PROPHET\d+_\d+):$")


@dataclass
class Row:
    kind: str  # "inst" | "call_label" | "jmp_label" | "prophet_label"
    inst: Optional[AsmInstruction] = None
    label: Optional[str] = None


def parse_row(line: str) -> Row:
    m = _RE_LABEL_CALL.match(line)
    if m:
        return Row("call_label", label=m.group(1))
    m = _RE_LABEL_JMP.match(line)
    if m:
        return Row("jmp_label", label=m.group(1))
    m = _RE_LABEL_PROPHET.match(line)
    if m:
        return Row("prophet_label", label=m.group(1))
    return Row("inst", inst=parse_instruction(line))


def strip_line(line: str) -> str:
    return line.split(";")[0].strip()
