"""Carried from olavm_tpu/node/olavm.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

OlaVM node API: contract deployment and transaction execution with
cross-contract call orchestration (reference zk-vm/src/lib.rs:37-421).

On `VMState::SCCall` the current (process, program, addrs) context is pushed
and a fresh Process continues in the callee sharing tape/tp/return_data; on
`ExeEnd` the context is popped, the callee trace is recorded per env, the
caller's cpu trace receives the callee's end step (with caller clk/env), and
the last sccall row's clk_callee_end is patched (lib.rs:291-408)."""

from __future__ import annotations

import json

from ..isa.binary_program import BinaryProgram
from ..runtime.load_tx import init_tape, mock_tx_ctx
from ..runtime.finalize import gen_storage_hash_table, gen_storage_table
from ..runtime.process import ExeEnd, Process, Program, SCCall
from ..tree.smt import AccountTree

ENTRY_POINT_ADDR = (0, 0, 0, 32769)


def encode_addr(addr) -> str:
    return ":".join(str(int(x)) for x in addr)


class OlaVM:
    def __init__(self, tree_db_path: str | None = None,
                 state_db_path: str | None = None, ctx_info=None):
        from ..state.node_state import NodeState

        self.account_tree = AccountTree(tree_db_path)
        self.ola_state = NodeState(state_db_path)
        self.process_ctx: list[tuple] = []
        self.ctx_info = ctx_info or mock_tx_ctx()
        self.tx_cache: dict = {}

    # ------------------------------------------------------------------
    # deployment (zk-vm/src/lib.rs:213-256)
    # ------------------------------------------------------------------
    def manual_deploy(self, contract_path_or_bp, addr: tuple) -> tuple:
        if isinstance(contract_path_or_bp, BinaryProgram):
            bp = contract_path_or_bp
        else:
            bp = BinaryProgram.load_file(contract_path_or_bp)
        code = [int(w, 16) for w in bp.bytecode.split("\n")]
        code_hash = self.ola_state.save_contract(code)
        self.ola_state.save_program(code_hash, bp.dumps())
        if bp.debug_info is not None:
            self.ola_state.save_debug_info(code_hash, bp.debug_info)
        self.ola_state.save_prophet(
            code_hash, {str(p.host): p.to_json() for p in bp.prophets}
        )
        self.ola_state.save_contract_map(addr, code_hash)
        self.account_tree.process_block(
            [{"kind": "repeated", "key": tuple(addr), "value": code_hash}]
        )
        self.account_tree.save()
        return code_hash

    # ------------------------------------------------------------------
    # program loading (zk-vm/src/lib.rs:147-204 contract_run get_code half)
    # ------------------------------------------------------------------
    def _load_program(self, process: Process, program: Program,
                      exe_code_addr: tuple):
        code_hash = self.ola_state.get_contract_map(exe_code_addr)
        bp = BinaryProgram.loads(self.ola_state.get_program(code_hash))
        loaded = Program.from_binary_program(bp)
        program.instructions = loaded.instructions
        program.prophets = loaded.prophets
        program.debug_info = loaded.debug_info
        process.program_log.append(
            {"kind": "read", "key": tuple(exe_code_addr), "value": code_hash}
        )
        program.trace.addr_program_hash[encode_addr(exe_code_addr)] = [
            int(w, 16) for w in program.instructions
        ]

    def _contract_run(self, process: Process, program: Program,
                      exe_code_addr: tuple, get_code: bool):
        if get_code:
            self._load_program(process, program, exe_code_addr)
        return process.execute(
            program, account_tree=self.account_tree, tx_cache=self.tx_cache
        )

    # ------------------------------------------------------------------
    # transaction execution (zk-vm/src/lib.rs:258-411)
    # ------------------------------------------------------------------
    def execute_tx(self, caller_addr: tuple, code_exe_addr: tuple,
                   calldata: list[int], debug_flag: bool = False):
        env_idx = 0
        sc_cnt = 0
        process = Process()
        process.block_timestamp = self.ctx_info.block_timestamp
        process.env_idx = env_idx
        process.call_sc_cnt = sc_cnt
        process.addr_storage = tuple(caller_addr)
        process.addr_code = tuple(code_exe_addr)
        process.tp = 0
        init_tape(
            process, calldata, tuple(caller_addr), tuple(code_exe_addr),
            tuple(code_exe_addr), self.ctx_info,
        )
        program = Program(instructions=[])
        program.print_flag = debug_flag

        caller = tuple(caller_addr)
        code_exe = tuple(code_exe_addr)
        start_root = self.account_tree.root_hash()
        res = self._contract_run(process, program, code_exe, True)

        while True:
            if isinstance(res, SCCall):
                tape_tree = process.tape
                tp = process.tp
                return_data = list(process.return_data)
                self.process_ctx.append((process, program, caller, code_exe))
                env_idx += 1
                sc_cnt += 1

                prev_storage_access_idx = process.storage_access_idx
                process = Process()
                process.block_timestamp = self.ctx_info.block_timestamp
                process.tape = tape_tree
                process.tp = tp
                process.env_idx = sc_cnt
                process.call_sc_cnt = sc_cnt
                process.return_data = return_data
                # storage-access indices are global across envs (the merged
                # storage_access table numbers accesses chronologically)
                process.storage_access_idx = prev_storage_access_idx

                program = Program(instructions=[])
                program.print_flag = debug_flag

                if res.is_delegate:
                    code_exe = tuple(res.callee)  # caller (storage ctx) kept
                else:
                    caller = tuple(res.callee)
                    code_exe = tuple(res.callee)
                process.addr_storage = caller
                process.addr_code = code_exe
                res = self._contract_run(process, program, code_exe, True)

            elif isinstance(res, ExeEnd):
                if not self.process_ctx:
                    assert env_idx == 0
                    hash_roots = gen_storage_hash_table(
                        process, program, self.account_tree
                    )
                    gen_storage_table(process, program, hash_roots)
                    program.trace.start_end_roots = (
                        start_root, self.account_tree.root_hash()
                    )
                    self.ola_state.txs_trace[process.env_idx] = program.trace
                    self.ola_state.storage_queries.extend(process.storage_queries)
                    self.ola_state.return_data = list(process.return_data)
                    return

                trace = program.trace
                tape_tree = process.tape
                tp = process.tp
                clk = process.clk
                return_data = list(process.return_data)
                env_id = process.env_idx
                program_log = process.program_log
                witness_log = process.storage_log
                storage_queries = process.storage_queries
                storage_trace = process.storage.trace
                callee_storage_access_idx = process.storage_access_idx

                callee_call_sc_cnt = process.call_sc_cnt
                process, program, caller, code_exe = self.process_ctx.pop()
                process.storage_access_idx = callee_storage_access_idx
                # call_sc_cnt is the GLOBAL sc counter: the resumed caller
                # continues from the callee's final count so a later sccall
                # numbers its env correctly
                process.call_sc_cnt = callee_call_sc_cnt

                step = res.end_step
                assert step is not None, "callee ended without end step"
                assert program.trace.sc_call, "caller has no sccall row"
                sccall_row = program.trace.sc_call[-1]
                sccall_row.clk_callee_end = clk
                # the END ext line in the caller's trace must mirror the
                # sccall row's CTL view (sccall_stark.rs ctl_data_sccall_end):
                # caller env/ctx, clk_caller_call, caller call-time regs,
                # callee env (aux0), callee end clk (aux1)
                step.clk = sccall_row.clk_caller_call
                step.env_idx = process.env_idx
                step.addr_storage = process.addr_storage
                step.addr_code = process.addr_code
                step.regs = tuple(sccall_row.regs)
                trace.exec.append(step)
                program.trace.exec.extend(trace.exec)
                trace.exec = []
                process.storage_log.extend(witness_log)
                process.program_log.extend(program_log)
                process.storage.trace.update(storage_trace)
                self.ola_state.txs_trace[env_id] = trace
                self.ola_state.storage_queries.extend(storage_queries)
                env_idx -= 1
                process.tp = tp
                process.tape = tape_tree
                process.return_data = return_data
                res = self._contract_run(process, program, code_exe, False)
            else:
                raise RuntimeError(f"unexpected VM state {res!r}")

    def finish_batch(self, block_number: int):
        """Run the system entry-point contract (zk-vm/src/lib.rs:413-420)."""
        calldata = [block_number, 1, 2190639505]
        return self.execute_tx(ENTRY_POINT_ADDR, ENTRY_POINT_ADDR, calldata)
