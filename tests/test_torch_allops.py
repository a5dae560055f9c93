"""The instruction-set fixture (tests/fixtures/allops_asm.json) through the
port's interpreter path, against olavm_tpu, on the CPU.

The fixture is a loop of K iterations that executes 24 of the 26 opcodes
(all but SCCALL, which the node golden covers, and SIGCHECK), so that
PoseidonStark, PoseidonChunkStark, StorageAccessStark and TapeStark hold
rows and their CTLs are live. At chip_smoke.ALLOPS_K:

- the port's run_program_full (calldata 0, 0) and generate_traces give
  olavm_tpu's 12 tables, every column (tolerance 0), its public values and
  its compress challenges;
- the CPU table executes exactly the 24 opcodes;
- each golden (tests/fixtures/allops_golden*.json, made by olavm_tpu's host
  prover through tests/test_torch_golden.py --allops K) describes this
  program: its K, calldata and the sha256 of the assembled bytecode, and at
  ALLOPS_K the table shapes. test_torch_golden.py's slow test recomputes
  each golden with olavm_tpu.
"""

import dataclasses
import hashlib
import json
import os
import tempfile

import numpy as np
import pytest

from chip_smoke import (
    ALLOPS_CALLDATA,
    ALLOPS_K,
    ALLOPS_K_FULL,
    allops_traces,
    write_allops_program,
)
from olavm_tpu_torch.assembler.encoder import encode_asm_from_json_file
from olavm_tpu_torch.isa.opcodes import SHIFT_TO_OPCODE, Opcode
from olavm_tpu_torch.tables import cpu
import torch_threads  # noqa: F401  (torch's share of the cores)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
GOLDENS = {"allops_golden.json": ALLOPS_K,
           "allops_golden_poseidon.json": ALLOPS_K,
           "allops_golden_full.json": ALLOPS_K_FULL}
TABLES = ["CpuStark", "MemoryStark", "BitwiseStark", "CmpStark",
          "RangeCheckStark", "PoseidonStark", "PoseidonChunkStark",
          "StorageAccessStark", "TapeStark", "SCCallStark", "ProgramStark",
          "ProgChunkStark"]


@pytest.fixture(scope="module")
def port():
    return allops_traces(ALLOPS_K)


@pytest.fixture(scope="module")
def reference():
    return allops_traces(ALLOPS_K, "olavm_tpu")


@pytest.mark.parametrize("table", range(len(TABLES)), ids=lambda t: TABLES[t])
def test_table_matches_olavm_tpu(table, port, reference):
    got, want = port[0][table], reference[0][table]
    assert type(port[2].starks[table]).__name__ == TABLES[table]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_public_values_and_challenges_match_olavm_tpu(port, reference):
    assert dataclasses.astuple(port[1]) == dataclasses.astuple(reference[1])
    assert port[2].compress_challenges() == reference[2].compress_challenges()
    assert port[3] == reference[3]


def test_fixture_executes_24_opcodes(port):
    opcodes = port[0][0][cpu.COL_OPCODE]
    executed = {SHIFT_TO_OPCODE[int(op).bit_length() - 1]
                for op in np.unique(opcodes) if int(op)}
    assert executed == set(Opcode) - {Opcode.SCCALL, Opcode.SIGCHECK}


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_golden_describes_this_program(name, port):
    with open(os.path.join(FIXTURES, name)) as f:
        golden = json.load(f)
    k = GOLDENS[name]
    assert golden["K"] == k and golden["calldata"] == ALLOPS_CALLDATA
    assert golden.get("merkle_hasher", "blake3") == (
        "poseidon" if "poseidon" in name else "blake3")
    with tempfile.TemporaryDirectory() as d:
        bytecode = encode_asm_from_json_file(
            write_allops_program(k, d)).bytecode
    assert golden["program_sha256"] == hashlib.sha256(
        bytecode.encode()).hexdigest()
    if k == ALLOPS_K:
        assert golden["table_shapes"] == [list(t.shape) for t in port[0]]
        pv = port[1]
        assert golden["public_values"] == {
            "pre_root": [int(x) for x in pv.pre_state_root],
            "post_root": [int(x) for x in pv.post_state_root]}
    assert len(golden["proof_sha256"]) == 64 and golden["proof_bytes"] > 0
