"""Carried from olavm_tpu/runtime/trace_io.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

Trace <-> JSON serialization, matching the reference serde field names
(core/src/trace/trace.rs:320-343 `Trace` and its row structs) so traces can
be inspected by the same tooling and moved between CLI stages
(client/src/main.rs:168 writes, :183 reads).
"""

from __future__ import annotations

import dataclasses
import json

from .trace import (
    BitwiseRow,
    CmpRow,
    MemoryRow,
    PoseidonChunkRow,
    PoseidonRow,
    RangeCheckRow,
    RegisterSelector,
    SCCallRow,
    Step,
    StorageHashRow,
    StorageRow,
    TapeRow,
    Trace,
)


def _enc(obj):
    if dataclasses.is_dataclass(obj):
        return {
            f.name: _enc(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, (list, tuple)):
        return [_enc(v) for v in obj]
    if isinstance(obj, bool):
        return int(obj)
    return obj


_TABLE_ROW_TYPES = {
    "exec": Step,
    "memory": MemoryRow,
    "builtin_rangecheck": RangeCheckRow,
    "builtin_bitwise_combined": BitwiseRow,
    "builtin_cmp": CmpRow,
    "builtin_poseidon": PoseidonRow,
    "builtin_poseidon_chunk": PoseidonChunkRow,
    "builtin_storage": StorageRow,
    "builtin_storage_hash": StorageHashRow,
    "builtin_program_hash": StorageHashRow,
    "tape": TapeRow,
    "sc_call": SCCallRow,
}


def trace_to_dict(trace: Trace) -> dict:
    out = {
        "instructions": {
            str(pc): list(_enc(v)) for pc, v in trace.instructions.items()
        },
        "raw_instructions": {},
        "raw_binary_instructions": list(trace.raw_binary_instructions),
        "addr_program_hash": {
            k: list(v) for k, v in trace.addr_program_hash.items()
        },
        "start_end_roots": [
            list(trace.start_end_roots[0]), list(trace.start_end_roots[1])
        ],
        "ret": list(trace.ret),
    }
    for name in _TABLE_ROW_TYPES:
        out[name] = [_enc(r) for r in getattr(trace, name)]
    return out


def trace_to_json(trace: Trace) -> str:
    return json.dumps(trace_to_dict(trace))


def _dec_row(cls, d: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = d[f.name]
        if f.name == "register_selector":
            v = RegisterSelector(**{
                k: (list(x) if isinstance(x, list) else x) for k, x in v.items()
            })
        elif isinstance(v, list):
            v = tuple(v) if cls is not RegisterSelector else list(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def trace_from_dict(d: dict) -> Trace:
    trace = Trace()
    trace.instructions = {
        int(pc): tuple(v) for pc, v in d.get("instructions", {}).items()
    }
    trace.raw_binary_instructions = list(d.get("raw_binary_instructions", []))
    trace.addr_program_hash = {
        k: [int(x) for x in v] for k, v in d.get("addr_program_hash", {}).items()
    }
    ser = d.get("start_end_roots", [[0, 0, 0, 0], [0, 0, 0, 0]])
    trace.start_end_roots = (tuple(ser[0]), tuple(ser[1]))
    trace.ret = [int(x) for x in d.get("ret", [])]
    for name, cls in _TABLE_ROW_TYPES.items():
        setattr(trace, name, [_dec_row(cls, r) for r in d.get(name, [])])
    return trace


def trace_from_json(s: str) -> Trace:
    return trace_from_dict(json.loads(s))
