"""Carried from olavm_tpu/isa/__init__.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.
"""

from .opcodes import Opcode
from .instruction import Instruction, Operand
from .binary_program import BinaryProgram, Prophet

__all__ = ["Opcode", "Instruction", "Operand", "BinaryProgram", "Prophet"]
