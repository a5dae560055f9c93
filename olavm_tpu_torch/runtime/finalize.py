"""Carried from olavm_tpu/runtime/finalize.py: the card has no jax, so this copy imports
only jax-free modules; its code is unchanged.

Post-execution table finalizers (executor/src/trace.rs:20-414):
the sorted memory table with diff columns + rangecheck rows, and the tape
table. Storage-hash finalization lives in the tree module (needs the SMT).
"""

from __future__ import annotations

from ..field import goldilocks as g
from ..runtime.memory import HP_START_ADDR, MEM_SPAN_SIZE
from ..runtime.trace import MemoryRow, TapeRow

U32_MAX = 0xFFFFFFFF

# rangecheck filter tuples: (mem_sort, cpu, cmp, storage, mem_region)
_MEM_SORT = 0
_MEM_REGION = 1


def gen_memory_table(process, program):
    origin_addr = 0
    origin_clk = 0
    first_row_flag = True
    first_heap_row_flag = True

    # drop the synthetic heap-pointer init cell's first entry
    hp_cells = process.memory.trace.get(HP_START_ADDR)
    if hp_cells is None:
        raise ValueError("missing heap pointer init cell")
    hp_cells.pop(0)

    for addr in sorted(process.memory.trace.keys()):
        cells = process.memory.trace[addr]
        new_addr_flag = True
        canonical_addr = addr % g.P
        for cell in cells:
            rc_insert = []
            write_once_region_flag = False
            if cell.region_prophet == 1:
                diff_addr_cond = g.P - canonical_addr
                write_once_region_flag = True
            elif cell.region_heap == 1:
                diff_addr_cond = g.P - MEM_SPAN_SIZE - canonical_addr
            else:
                diff_addr_cond = 0

            if first_row_flag:
                row = MemoryRow(
                    env_idx=cell.env_idx, addr=canonical_addr, clk=cell.clk,
                    is_rw=cell.is_rw, op=cell.op, is_write=cell.is_write,
                    diff_addr=0, diff_addr_inv=0, diff_clk=0,
                    diff_addr_cond=diff_addr_cond,
                    filter_looked_for_main=cell.filter_looked_for_main,
                    rw_addr_unchanged=0, region_prophet=cell.region_prophet,
                    region_heap=cell.region_heap, value=cell.value, rc_value=0,
                )
                program.trace.memory.append(row)
                first_row_flag = False
                new_addr_flag = False
                if cell.region_heap == 1:
                    first_heap_row_flag = False
            elif new_addr_flag:
                diff_addr = canonical_addr - origin_addr
                if write_once_region_flag:
                    diff_addr_inv = 0
                    rc_value = diff_addr_cond
                    rc_insert.append((diff_addr_cond, _MEM_REGION))
                elif cell.region_heap == 1 and first_heap_row_flag:
                    diff_addr = 0
                    diff_addr_inv = 0
                    rc_value = 0
                    rc_insert.append((diff_addr_cond, _MEM_REGION))
                    first_heap_row_flag = False
                else:
                    diff_addr_inv = g.inv(diff_addr) if diff_addr else 0
                    rc_value = diff_addr
                    rc_insert.append((rc_value, _MEM_SORT))
                    if cell.region_heap == 1:
                        rc_insert.append((diff_addr_cond, _MEM_REGION))
                row = MemoryRow(
                    env_idx=cell.env_idx, addr=canonical_addr, clk=cell.clk,
                    is_rw=cell.is_rw, op=cell.op, is_write=cell.is_write,
                    diff_addr=diff_addr, diff_addr_inv=diff_addr_inv, diff_clk=0,
                    diff_addr_cond=diff_addr_cond,
                    filter_looked_for_main=cell.filter_looked_for_main,
                    rw_addr_unchanged=0, region_prophet=cell.region_prophet,
                    region_heap=cell.region_heap, value=cell.value,
                    rc_value=rc_value,
                )
                program.trace.memory.append(row)
                new_addr_flag = False
            else:
                diff_clk = cell.clk - origin_clk
                rw_addr_unchanged = 1
                if cell.is_rw == 0:
                    rw_addr_unchanged = 0
                    rc_value = diff_addr_cond
                    rc_insert.append((rc_value, _MEM_REGION))
                else:
                    rc_value = diff_clk
                    rc_insert.append((rc_value, _MEM_SORT))
                if cell.region_heap == 1:
                    rc_insert.append((diff_addr_cond, _MEM_REGION))
                row = MemoryRow(
                    env_idx=cell.env_idx, addr=canonical_addr, clk=cell.clk,
                    is_rw=cell.is_rw, op=cell.op, is_write=cell.is_write,
                    diff_addr=0, diff_addr_inv=0, diff_clk=diff_clk,
                    diff_addr_cond=diff_addr_cond,
                    filter_looked_for_main=cell.filter_looked_for_main,
                    rw_addr_unchanged=rw_addr_unchanged,
                    region_prophet=cell.region_prophet,
                    region_heap=cell.region_heap, value=cell.value,
                    rc_value=rc_value,
                )
                program.trace.memory.append(row)

            for value, _kind in rc_insert:
                if value > U32_MAX:
                    raise ValueError(f"memory rc value exceeds u32: {value}")
            for value, kind in rc_insert:
                if kind == _MEM_SORT:
                    program.trace.insert_rangecheck(value, (1, 0, 0, 0, 0))
                else:
                    program.trace.insert_rangecheck(value, (0, 0, 0, 0, 1))
            origin_clk = cell.clk
        origin_addr = canonical_addr


def gen_tape_table(process, program):
    for addr in sorted(process.tape.trace.keys()):
        for cell in process.tape.trace[addr]:
            program.trace.tape.append(
                TapeRow(
                    is_init=cell.is_init == 1,
                    opcode=cell.op,
                    addr=addr,
                    value=cell.value,
                    filter_looked=cell.filter_looked,
                )
            )


def gen_storage_table(process, program, hash_roots):
    """Sorted storage access table (executor/src/trace.rs:361-398)."""
    from ..runtime.trace import StorageRow

    if not hash_roots:
        return
    cells = [c for cells in process.storage.trace.values() for c in cells]
    cells.sort(key=lambda c: (c.env_idx, c.clk))
    for cell, root in zip(cells, hash_roots):
        program.trace.builtin_storage.append(
            StorageRow(
                env_idx=cell.env_idx, clk=cell.clk, diff_clk=0, opcode=cell.op,
                root=tuple(root), addr=cell.addr, value=cell.value,
            )
        )
        program.trace.insert_rangecheck(0, (0, 0, 0, 1, 0))
    process.storage.trace = {}


def gen_storage_hash_table(process, program, account_tree):
    """Replay storage+program logs through the SMT and emit StorageHashRow
    witnesses (executor/src/trace.rs:280-359). Returns per-access root hashes
    and moves program-hash rows into trace.builtin_program_hash."""
    from ..tree.smt import ROOT_TREE_DEPTH, tree_key_to_int
    from ..runtime.trace import StorageHashRow

    storage_log_len = len(process.storage_log)
    logs = list(process.storage_log) + list(process.program_log)
    process.storage_log = []
    process.program_log = []
    pre_root = account_tree.root_hash()
    hash_traces = account_tree.process_block(logs)
    account_tree.save()

    LEAF_LAYER = 255
    root_hashes = []
    all_rows = []
    for chunk_idx, log in enumerate(logs):
        chunk = hash_traces[chunk_idx * ROOT_TREE_DEPTH:(chunk_idx + 1) * ROOT_TREE_DEPTH]
        is_write = {"read": 0, "initial": 1, "repeated": 2}[log["kind"]]
        root_hash = tuple(chunk[-1].row.output[:4])
        root_hashes.append(root_hash)
        acc = 0
        key_int = tree_key_to_int(log["key"])
        hash_type = 0
        rows = []
        for item_idx, item in enumerate(reversed(chunk)):
            layer_bit = (key_int >> (LEAF_LAYER - item_idx)) & 1
            layer = item_idx + 1
            if item_idx == LEAF_LAYER:
                hash_type = 1
            acc = (acc * 2 + layer_bit) % g.P
            rows.append(
                StorageHashRow(
                    storage_access_idx=chunk_idx + 1,
                    pre_root=tuple(pre_root),
                    root=root_hash,
                    is_write=is_write,
                    hash_type=hash_type,
                    pre_hash=tuple(item.pre_hash),
                    hash=tuple(item.row.output[:4]),
                    layer=layer,
                    layer_bit=layer_bit,
                    addr_acc=acc,
                    addr=tuple(log["key"]),
                    pre_path=tuple(item.pre_path),
                    path=tuple(item.path),
                    sibling=tuple(item.sibling),
                )
            )
            if layer % 64 == 0:
                acc = 0
            program.trace.builtin_poseidon.append(item.row)
            program.trace.builtin_poseidon.append(item.pre_row)
        pre_root = root_hash
        all_rows.extend(rows)

    split = storage_log_len * ROOT_TREE_DEPTH
    program.trace.builtin_storage_hash = (
        program.trace.builtin_storage_hash + all_rows[:split]
    )
    program.trace.builtin_program_hash = all_rows[split:]
    return root_hashes
