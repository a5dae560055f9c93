"""Carried from olavm_tpu/runtime/dump.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

Crash dumps: serialize machine state + partial trace on execution failure
for offline debugging (reference executor/src/trace.rs:416 gen_dump_file,
core/src/trace/dump.rs:6-33 DumpStep/DumpMemoryRow/DumpTapeRow/DumpTrace)."""

from __future__ import annotations

import json


def _dump_steps(trace, limit: int = 0) -> list[dict]:
    steps = trace.exec[-limit:] if limit else trace.exec
    out = []
    for s in steps:
        out.append({
            "env_idx": s.env_idx,
            "clk": s.clk,
            "pc": s.pc,
            "tp": s.tp,
            "instruction": s.instruction,
            "op1_imm": s.op1_imm,
            "opcode": s.opcode,
            "regs": [int(r) for r in s.regs],
            "is_ext_line": s.is_ext_line,
            "asm": trace.instructions.get(s.pc, ("?",))[0],
        })
    return out


def gen_dump_file(process, program, path: str, error: Exception | None = None):
    """Write a JSON crash dump: registers, pointers, memory, tape, and the
    executed steps up to the failure."""
    memory = {}
    for addr, cells in process.memory.trace.items():
        memory[str(addr)] = [
            {"clk": c.clk, "op": c.op, "is_write": c.is_write, "value": c.value}
            for c in cells
        ]
    tape = {}
    for addr, cells in process.tape.trace.items():
        tape[str(addr)] = [
            {"clk": c.clk, "is_init": c.is_init, "op": c.op, "value": c.value}
            for c in cells
        ]
    dump = {
        "error": repr(error) if error else None,
        "env_idx": process.env_idx,
        "clk": process.clk,
        "pc": process.pc,
        "tp": process.tp,
        "psp": process.psp,
        "hp": process.hp,
        "registers": [int(r) for r in process.registers],
        "addr_storage": [int(v) for v in process.addr_storage],
        "addr_code": [int(v) for v in process.addr_code],
        "exec": _dump_steps(program.trace),
        "memory": memory,
        "tape": tape,
    }
    with open(path, "w") as f:
        json.dump(dump, f)
    return path


def load_dump_file(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
