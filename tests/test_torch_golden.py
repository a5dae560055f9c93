"""Golden for the port's 12-table parity check on the card.

tests/fixtures/fib_loop_golden.json holds, for the fib-loop fixture at N=10,
the public values and the sha256 and byte length of serialize_all_proof of
olavm_tpu's host prover with StarkConfig.standard_fast_config().
chip_smoke.py proves the same program with the port on the card and compares
against it. The slow test recomputes the golden with olavm_tpu; running this
file as a script (`python tests/test_torch_golden.py`) rewrites it.
"""

import hashlib
import json
import os
import tempfile

import pytest

from chip_smoke import write_fib_program

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
GOLDEN = os.path.join(FIXTURES, "fib_loop_golden.json")
GOLDEN_N = 10


def golden_record(n: int = GOLDEN_N) -> dict:
    from olavm_tpu.runtime.harness import run_program_fast
    from olavm_tpu.stark.config import StarkConfig
    from olavm_tpu.stark.proof import PublicValues
    from olavm_tpu.stark.prover import prove_with_traces
    from olavm_tpu.stark.serialization import serialize_all_proof
    from olavm_tpu.tables.fast_gen import generate_traces_fast
    from olavm_tpu.tables.ola_stark import OlaStark

    with tempfile.TemporaryDirectory() as d:
        fast_run, process, program, _ = run_program_fast(
            write_fib_program(n, d), calldata=None)
    ola = OlaStark()
    traces = generate_traces_fast(fast_run, program, ola, process)
    pre, post = program.trace.start_end_roots
    pv = PublicValues(tuple(pre), tuple(post), 0)
    proof = prove_with_traces(ola, StarkConfig.standard_fast_config(), traces,
                              public_values=pv)
    data = serialize_all_proof(proof)
    return {
        "N": n,
        "public_values": {"pre_root": [int(x) for x in pre],
                          "post_root": [int(x) for x in post]},
        "proof_sha256": hashlib.sha256(data).hexdigest(),
        "proof_bytes": len(data),
    }


@pytest.mark.slow
def test_golden_matches_reference_prover():
    with open(GOLDEN) as f:
        assert golden_record() == json.load(f)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    with open(GOLDEN, "w") as f:
        json.dump(golden_record(), f, indent=1)
        f.write("\n")
