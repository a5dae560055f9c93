"""Carried from olavm_tpu/runtime/harness.py: the card has no jax, so this copy imports
only jax-free modules; its code is unchanged.

End-to-end run harness: assemble -> SMT setup -> execute -> finalize all
tables. Mirrors the reference test harness (circuits/src/test_utils.rs and
executor/src/tests.rs:25-148)."""

from __future__ import annotations

from ..assembler.encoder import encode_asm_from_json_file
from ..hash import poseidon as pos
from ..tree.smt import AccountTree
from .finalize import gen_storage_hash_table, gen_storage_table
from ..runtime.load_tx import init_tape, mock_tx_ctx
from .process import Process, Program

CALLEE = (9, 10, 11, 12)
CALLER = (17, 18, 19, 20)
CALLEE_EXE = (13, 14, 15, 16)


def encode_addr(addr) -> str:
    return ":".join(str(int(x)) for x in addr)


def run_program_full(asm_path: str, calldata=None, account_tree=None,
                     callee=CALLEE, caller=CALLER, callee_exe=CALLEE_EXE,
                     from_binary: bool = False,
                     dump_on_failure: str | None = None):
    """Full pipeline: returns (process, program, account_tree).

    from_binary: asm_path is an already-assembled BinaryProgram JSON
    (the `ola run` input format, client/src/main.rs:90-95)."""
    if from_binary:
        from ..isa.binary_program import BinaryProgram

        bp = BinaryProgram.load_file(asm_path)
    else:
        bp = encode_asm_from_json_file(asm_path)
    program = Program.from_binary_program(bp)
    code = [int(w, 16) for w in program.instructions]
    code_hash = tuple(pos.hash_no_pad(code))

    process = Process()
    if calldata is not None:
        process.tp = 0
        init_tape(process, calldata, caller, callee, callee_exe, mock_tx_ctx())
    process.addr_code = callee_exe
    process.addr_storage = callee

    program.trace.addr_program_hash[encode_addr(callee_exe)] = code

    if account_tree is None:
        account_tree = AccountTree()
    account_tree.process_block(
        [{"kind": "initial", "key": callee_exe, "value": code_hash}]
    )
    account_tree.save()
    start_root = account_tree.root_hash()

    process.program_log.append(
        {"kind": "read", "key": callee_exe, "value": code_hash}
    )

    try:
        process.execute(program, account_tree=account_tree)
    except Exception as e:
        if dump_on_failure:
            # crash dump for offline debugging (executor/src/trace.rs:416)
            from ..runtime.dump import gen_dump_file

            gen_dump_file(process, program, dump_on_failure, error=e)
        raise

    hash_roots = gen_storage_hash_table(process, program, account_tree)
    gen_storage_table(process, program, hash_roots)
    program.trace.start_end_roots = (start_root, account_tree.root_hash())
    return process, program, account_tree


def run_program_fast(asm_path: str, calldata=None, account_tree=None,
                     callee=CALLEE, caller=CALLER, callee_exe=CALLEE_EXE,
                     from_binary: bool = False):
    """Fast pipeline: native executor (runtime/fast_executor) + SoA journals.
    Returns (fast_run, process, program, account_tree). Raises
    UnsupportedProgram for programs using storage/poseidon/sccall/sigcheck
    opcodes — callers fall back to run_program_full."""
    from .fast_executor import execute_fast
    from .process import gen_program_hash_rows

    if from_binary:
        from ..isa.binary_program import BinaryProgram

        bp = BinaryProgram.load_file(asm_path)
    else:
        bp = encode_asm_from_json_file(asm_path)
    program = Program.from_binary_program(bp)
    code = [int(w, 16) for w in program.instructions]
    code_hash = tuple(pos.hash_no_pad(code))

    process = Process()
    if calldata is not None:
        process.tp = 0
        init_tape(process, calldata, caller, callee, callee_exe, mock_tx_ctx())
    process.addr_code = callee_exe
    process.addr_storage = callee

    program.trace.addr_program_hash[encode_addr(callee_exe)] = code

    if account_tree is None:
        account_tree = AccountTree()
    account_tree.process_block(
        [{"kind": "initial", "key": callee_exe, "value": code_hash}]
    )
    account_tree.save()
    start_root = account_tree.root_hash()
    process.program_log.append(
        {"kind": "read", "key": callee_exe, "value": code_hash}
    )

    # Process.execute prologue equivalents: decode + program-hash sponge rows
    process.execute_decode(program)
    gen_program_hash_rows(program, code)

    tape_cells = [
        (addr, c.value, c.is_init, c.clk, c.op, c.filter_looked)
        for addr in sorted(process.tape.trace)
        for c in process.tape.trace[addr]
    ]
    fast_run = execute_fast(program, tape_cells, process.tp)

    hash_roots = gen_storage_hash_table(process, program, account_tree)
    gen_storage_table(process, program, hash_roots)
    program.trace.start_end_roots = (start_root, account_tree.root_hash())
    return fast_run, process, program, account_tree
