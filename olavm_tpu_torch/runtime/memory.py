"""Carried from olavm_tpu/runtime/memory.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

VM memory, tape, and storage journals.

Memory model (core/src/vm/memory.rs): address space = field; three regions —
read-write stack/low region, heap (hp init at HP_START_ADDR = p - 2*(2^32-1)),
write-once prophet region (PSP_START_ADDR = p - (2^32-1)). Every access is
journaled per address; the journals become the memory/tape sub-trace tables.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..field import goldilocks as g

MEM_SPAN_SIZE = 0xFFFFFFFF  # u32::MAX
PSP_START_ADDR = g.P - MEM_SPAN_SIZE
HP_START_ADDR = g.P - 2 * MEM_SPAN_SIZE

# MemoryType
MEM_WRITE_ONCE = 0
MEM_READ_WRITE = 1
# MemoryOperation
MEM_READ = 0
MEM_WRITE = 1


class MemVisitError(Exception):
    def __init__(self, addr):
        super().__init__(f"invalid memory visit at addr {addr}")
        self.addr = addr


@dataclass(slots=True)
class MemoryCell:
    env_idx: int
    clk: int
    is_rw: int
    op: int
    is_write: int
    filter_looked_for_main: int
    region_prophet: int
    region_heap: int
    value: int


def region_flags(addr: int) -> tuple[int, int, int]:
    """(is_rw, region_prophet, region_heap) for a normal (non-write-once-
    violating) access; prophet-region accesses are (WriteOnce, 1, 0)."""
    if addr >= PSP_START_ADDR:
        return MEM_WRITE_ONCE, 1, 0
    if addr >= HP_START_ADDR:
        return MEM_READ_WRITE, 0, 1
    return MEM_READ_WRITE, 0, 0


class MemoryTree:
    """Per-address access journal (BTreeMap<addr, Vec<MemoryCell>>)."""

    def __init__(self):
        self.trace: dict[int, list[MemoryCell]] = {}

    def read(self, addr, clk, op, is_rw, is_write, filter_main,
             region_prophet, region_heap, env_idx) -> int:
        cells = self.trace.get(addr)
        if not cells:
            raise MemVisitError(addr)
        last = cells[-1].value
        cells.append(MemoryCell(env_idx, clk, is_rw, op, is_write,
                                filter_main, region_prophet, region_heap, last))
        return last

    def write(self, addr, clk, op, is_rw, is_write, filter_main,
              region_prophet, region_heap, value, env_idx):
        cell = MemoryCell(env_idx, clk, is_rw, op, is_write,
                          filter_main, region_prophet, region_heap, value)
        self.trace.setdefault(addr, []).append(cell)


@dataclass(slots=True)
class TapeCell:
    clk: int
    is_init: int
    op: int
    filter_looked: int
    value: int


class TapeVisitError(Exception):
    def __init__(self, addr):
        super().__init__(f"invalid tape visit at addr {addr}")
        self.addr = addr


class TapeTree:
    def __init__(self):
        self.trace: dict[int, list[TapeCell]] = {}

    def read(self, addr, clk, op, filter_looked) -> int:
        cells = self.trace.get(addr)
        if not cells:
            raise TapeVisitError(addr)
        last = cells[-1]
        cells.append(TapeCell(clk, last.is_init, op, filter_looked, last.value))
        return last.value

    def read_without_trace(self, addr) -> int:
        cells = self.trace.get(addr)
        if not cells:
            raise TapeVisitError(addr)
        return cells[-1].value

    def write(self, addr, clk, op, is_init, filter_looked, value):
        self.trace.setdefault(addr, []).append(
            TapeCell(clk, is_init, op, filter_looked, value)
        )


@dataclass(slots=True)
class StorageCell:
    env_idx: int
    clk: int
    op: int
    root: tuple
    addr: tuple
    value: tuple


class StorageTree:
    """In-execution storage journal keyed by hashed tree key (executor/src/
    storage.rs). read() returns the previously-written value if present."""

    def __init__(self):
        self.trace: dict[tuple, list[StorageCell]] = {}

    def read(self, clk, op, addr, root, value, env_idx) -> tuple:
        cells = self.trace.get(addr)
        if cells:
            last = cells[-1].value
            cells.append(StorageCell(env_idx, clk, op, root, addr, last))
            return last
        self.trace[addr] = [StorageCell(env_idx, clk, op, root, addr, value)]
        return value

    def write(self, clk, op, addr, value, root, env_idx):
        self.trace.setdefault(addr, []).append(
            StorageCell(env_idx, clk, op, root, addr, value)
        )
