"""Carried from olavm_tpu/assembler/encoder.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

asm JSON bundle -> relocation -> BinaryProgram encoding.

Pipeline matches the reference assembler (assembler/src/relocate.rs:111-228,
assembler/src/encoder.rs:11-258): scopes are re-sorted so `main` comes first;
call/jump labels resolve to the pc of the NEXT instruction; prophet labels
attach to the pc of the PREVIOUS instruction (its host).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..isa.binary_program import BinaryProgram, Prophet
from ..isa.instruction import Instruction, Operand
from ..isa.opcodes import Opcode
from .asm_parser import AsmInstruction, AsmOperand, Row, parse_row, strip_line


@dataclass
class RelocatedBundle:
    instructions: list[AsmInstruction]
    prophets: dict[int, dict]  # host pc -> prophet json
    label_call: dict[str, int]
    label_jmp: dict[str, int]


def _sorted_scopes(program: str) -> list[list[str]]:
    scopes: list[tuple[str, list[str]]] = []
    label = ""
    lines: list[str] = []
    for raw in program.split("\n"):
        line = strip_line(raw)
        if not line:
            continue
        row = parse_row(line)
        if row.kind == "call_label":
            if lines:
                scopes.append((label, lines))
            label = row.label
            lines = [line]
        else:
            lines.append(line)
    if lines:
        scopes.append((label, lines))
    if not scopes:
        raise ValueError("no scope found")
    # stable sort: main first, others keep order
    scopes.sort(key=lambda s: 0 if s[0] == "main" else 1)
    if scopes[0][0] != "main":
        raise ValueError("no main scope found")
    return [s[1] for s in scopes]


def relocate(bundle: dict) -> RelocatedBundle:
    scopes = _sorted_scopes(bundle["program"])
    all_lines = [line for scope in scopes for line in scope]

    instructions: list[AsmInstruction] = []
    label_call: dict[str, int] = {}
    label_jmp: dict[str, int] = {}
    label_prophet: dict[str, int] = {}
    pending: list[Row] = []
    counter = 0
    prev_counter = 0

    for line in all_lines:
        row = parse_row(line)
        if row.kind == "inst":
            for cached in pending:
                if cached.kind == "call_label":
                    label_call[cached.label] = counter
                elif cached.kind == "jmp_label":
                    label_jmp[cached.label] = counter
                elif cached.kind == "prophet_label":
                    label_prophet[cached.label] = prev_counter
            pending.clear()
            instructions.append(row.inst)
            prev_counter = counter
            counter += row.inst.binary_length()
        else:
            pending.append(row)

    prophets: dict[int, dict] = {}
    for p in bundle.get("prophets", []):
        host = label_prophet.get(p["label"])
        if host is None:
            raise ValueError(f"prophet cannot find host: {p['label']}")
        prophets[host] = p
    return RelocatedBundle(instructions, prophets, label_call, label_jmp)


def _mem_operands(asm: AsmInstruction) -> tuple[Operand, Operand, Operand]:
    """MLOAD/MSTORE re-shuffle (encoder.rs:118-211): the addressed operand
    splits into (anchor reg -> op0, offset imm / factored reg -> op1); the
    value register becomes dst."""
    value_op = asm.dst if asm.opcode == Opcode.MLOAD else asm.op1
    addr_op = asm.op1 if asm.opcode == Opcode.MLOAD else asm.op0
    if value_op.kind != "reg":
        raise ValueError(f"mem value operand must be a reg: {asm.asm}")
    if addr_op.kind == "reg_offset":
        op1 = Operand("imm", imm=addr_op.imm)
    elif addr_op.kind == "reg_factored":
        op1 = Operand("reg_factor", reg=addr_op.offset_reg, imm=addr_op.imm)
    else:
        raise ValueError(f"mem address operand invalid: {asm.asm}")
    return (
        Operand.from_reg(addr_op.reg),
        op1,
        Operand.from_reg(value_op.reg),
    )


def _to_binary_operand(
    op: AsmOperand | None, label_call: dict, label_jmp: dict
) -> Operand | None:
    if op is None:
        return None
    if op.kind == "imm":
        return Operand("imm", imm=op.imm)
    if op.kind == "reg":
        return Operand.from_reg(op.reg)
    if op.kind == "special":
        return None  # psp handled implicitly (mov only)
    if op.kind == "label":
        if op.name not in label_jmp:
            raise ValueError(f"invalid label {op.name}")
        return Operand("imm", imm=label_jmp[op.name])
    if op.kind == "ident":
        if op.name not in label_call:
            raise ValueError(f"invalid identifier {op.name}")
        return Operand("imm", imm=label_call[op.name])
    raise ValueError(f"unexpected operand kind {op.kind}")


def encode_to_binary(bundle: RelocatedBundle) -> BinaryProgram:
    lines: list[str] = []
    prophets: list[Prophet] = []
    debug_info: dict[int, str] = {}
    counter = 0
    for asm in bundle.instructions:
        if asm.opcode in (Opcode.MLOAD, Opcode.MSTORE):
            op0, op1, dst = _mem_operands(asm)
        else:
            op0 = _to_binary_operand(asm.op0, bundle.label_call, bundle.label_jmp)
            op1 = _to_binary_operand(asm.op1, bundle.label_call, bundle.label_jmp)
            dst = _to_binary_operand(asm.dst, bundle.label_call, bundle.label_jmp)
        inst = Instruction(asm.opcode, op0, op1, dst)
        if counter in bundle.prophets:
            p = bundle.prophets[counter]
            prophets.append(
                Prophet(
                    host=counter,
                    code=p["code"],
                    inputs=p.get("inputs", []),
                    outputs=p.get("outputs", []),
                )
            )
        debug_info[counter] = asm.asm
        lines.extend(inst.encode())
        counter += asm.binary_length()
    return BinaryProgram("\n".join(lines), prophets, debug_info)


def encode_asm_bundle(bundle: dict) -> BinaryProgram:
    return encode_to_binary(relocate(bundle))


def encode_asm_from_json_file(path: str) -> BinaryProgram:
    with open(path) as f:
        return encode_asm_bundle(json.load(f))
