"""Carried from olavm_tpu/isa/binary_program.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

BinaryProgram: the on-disk program format (JSON with newline-joined hex
bytecode + prophets), matching core/src/program/binary_program.rs:16-70."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Prophet:
    host: int
    code: str
    inputs: list[dict]
    outputs: list[dict]
    ctx: list = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "host": self.host,
            "code": self.code,
            "ctx": self.ctx,
            "inputs": self.inputs,
            "outputs": self.outputs,
        }

    @staticmethod
    def from_json(d: dict) -> "Prophet":
        return Prophet(
            host=d["host"],
            code=d["code"],
            inputs=d.get("inputs", []),
            outputs=d.get("outputs", []),
            ctx=d.get("ctx", []),
        )


@dataclass
class BinaryProgram:
    bytecode: str  # newline-joined hex words
    prophets: list[Prophet]
    debug_info: Optional[dict] = None

    def bytecode_u64(self) -> list[int]:
        return [int(line, 16) for line in self.bytecode.split("\n")]

    def to_json(self) -> dict:
        return {
            "bytecode": self.bytecode,
            "prophets": [p.to_json() for p in self.prophets],
        }

    def dumps(self) -> str:
        return json.dumps(self.to_json())

    @staticmethod
    def from_json(d: dict) -> "BinaryProgram":
        return BinaryProgram(
            bytecode=d["bytecode"],
            prophets=[Prophet.from_json(p) for p in d.get("prophets", [])],
        )

    @staticmethod
    def loads(s: str) -> "BinaryProgram":
        return BinaryProgram.from_json(json.loads(s))

    @staticmethod
    def load_file(path: str) -> "BinaryProgram":
        with open(path) as f:
            return BinaryProgram.from_json(json.load(f))
