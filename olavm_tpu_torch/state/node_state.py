"""Carried from olavm_tpu/state/node_state.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

NodeState: contract registry + per-tx trace collection (reference
core/src/state/mod.rs:18-185, state_storage.rs, contracts.rs)."""

from __future__ import annotations

import json

import numpy as np

from ..hash import poseidon as pos
from ..runtime.trace import Trace
from .store import Database, KVStore


def _key4(value4) -> bytes:
    return np.asarray(list(value4), dtype=np.uint64).tobytes()


class NodeState:
    """Contracts by code-hash, address->code-hash map, prophets, debug info,
    and the per-env trace map merged by gen_tx_trace."""

    def __init__(self, db_path: str | None = None):
        self.db = KVStore(Database.SEQUENCER, db_path)
        self.txs_trace: dict[int, Trace] = {}
        self.storage_queries: list = []
        self.return_data: list[int] = []

    # -- contracts (code words stored under their Poseidon hash) --
    def save_contract(self, code_words: list[int]) -> tuple:
        code_hash = tuple(pos.hash_no_pad([int(w) for w in code_words]))
        self.db.put(
            "contracts", _key4(code_hash),
            np.asarray(code_words, dtype=np.uint64).tobytes(),
        )
        return code_hash

    def get_contract(self, code_hash) -> list[int]:
        raw = self.db.get("contracts", _key4(code_hash))
        if raw is None:
            raise KeyError(f"unknown contract {code_hash}")
        return [int(v) for v in np.frombuffer(raw, dtype=np.uint64)]

    def save_program(self, code_hash, program_json: str):
        """Store the full BinaryProgram JSON under the code hash
        (the reference's bincode-serialized program blob)."""
        self.db.put("state", _key4(code_hash), program_json.encode())

    def get_program(self, code_hash) -> str:
        raw = self.db.get("state", _key4(code_hash))
        if raw is None:
            raise KeyError(f"unknown program {code_hash}")
        return raw.decode()

    def save_contract_map(self, contract_addr, code_hash):
        self.db.put("contract_map", _key4(contract_addr), _key4(code_hash))

    def get_contract_map(self, contract_addr) -> tuple:
        raw = self.db.get("contract_map", _key4(contract_addr))
        if raw is None:
            raise KeyError(f"no contract deployed at {contract_addr}")
        return tuple(int(v) for v in np.frombuffer(raw, dtype=np.uint64))

    def save_prophet(self, code_hash, prophets: dict):
        self.db.put("prophets", _key4(code_hash), json.dumps(prophets).encode())

    def get_prophet(self, code_hash) -> dict:
        raw = self.db.get("prophets", _key4(code_hash))
        return json.loads(raw.decode()) if raw else {}

    def save_debug_info(self, code_hash, debug_info):
        self.db.put("debug_info", _key4(code_hash), json.dumps(debug_info).encode())

    def get_debug_info(self, code_hash):
        raw = self.db.get("debug_info", _key4(code_hash))
        return json.loads(raw.decode()) if raw else None

    # -- trace merging (core/src/state/mod.rs:123-166) --
    def gen_tx_trace(self) -> Trace:
        trace = Trace()
        env0 = self.txs_trace.get(0)
        assert env0 is not None, "no env-0 trace recorded"
        trace.tape = env0.tape
        trace.exec = env0.exec
        trace.builtin_storage_hash = env0.builtin_storage_hash
        trace.builtin_program_hash = env0.builtin_program_hash
        trace.ret = env0.ret
        trace.start_end_roots = env0.start_end_roots
        trace.instructions = dict(env0.instructions)
        trace.raw_binary_instructions = list(env0.raw_binary_instructions)
        env0.tape = []
        env0.exec = []
        for env_id in sorted(self.txs_trace):
            item = self.txs_trace[env_id]
            trace.memory.extend(item.memory)
            trace.builtin_bitwise_combined.extend(item.builtin_bitwise_combined)
            trace.builtin_cmp.extend(item.builtin_cmp)
            trace.builtin_rangecheck.extend(item.builtin_rangecheck)
            trace.builtin_poseidon.extend(item.builtin_poseidon)
            trace.builtin_poseidon_chunk.extend(item.builtin_poseidon_chunk)
            trace.builtin_storage.extend(item.builtin_storage)
            trace.addr_program_hash.update(item.addr_program_hash)
            trace.sc_call.extend(item.sc_call)
        self.txs_trace.clear()
        return trace
