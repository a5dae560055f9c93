"""Goldens for the port's parity checks on the card, made by olavm_tpu on
the CPU.

- tests/fixtures/fib_loop_golden.json: the fib-loop fixture at N=10, the
  public values and the sha256 and byte length of serialize_all_proof of
  olavm_tpu's host prover with StarkConfig.standard_fast_config() (blake3
  Merkle caps);
- tests/fixtures/fib_loop_golden_poseidon.json: the same with
  merkle_hasher="poseidon";
- tests/fixtures/cli_fib_golden.json: the proof that olavm_tpu's `ola` CLI
  writes for the same program through asm, run (calldata 0, 0) and
  `prove -b host` (chip_smoke.cli_stages);
- tests/fixtures/fib_loop_golden_full.json and
  fib_loop_golden_full_poseidon.json: the first two at the full size,
  N=94000 (2^20 CPU rows; chip_smoke.FULL_N);
- tests/fixtures/node_sccall_golden.json: the node path: olavm_tpu's OlaVM
  deploys the sccall fixture pair (sccall_caller_asm.json,
  sccall_callee_asm.json), runs the caller's tx, and its host prover proves
  the tx's tables (chip_smoke.node_tx), blake3 caps.

chip_smoke.py proves the same programs with the port on the card and
compares against them. The slow tests recompute each golden with
olavm_tpu; running this file as a script (`python tests/test_torch_golden.py`)
rewrites the three at N=10, with `--node` the node golden (minutes), and
with `--full blake3` or `--full poseidon` one of the full-size goldens (tens
of minutes and tens of GiB of host memory each: run it alone). It prints each golden's seconds and the
process's peak resident memory.
"""

import functools
import hashlib
import json
import os
import sys
import tempfile

import pytest
import torch_threads  # noqa: F401  (torch's share of the cores)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
GOLDEN = os.path.join(FIXTURES, "fib_loop_golden.json")
GOLDEN_POSEIDON = os.path.join(FIXTURES, "fib_loop_golden_poseidon.json")
GOLDEN_CLI = os.path.join(FIXTURES, "cli_fib_golden.json")
GOLDEN_NODE = os.path.join(FIXTURES, "node_sccall_golden.json")
GOLDEN_FULL = {
    "blake3": os.path.join(FIXTURES, "fib_loop_golden_full.json"),
    "poseidon": os.path.join(FIXTURES, "fib_loop_golden_full_poseidon.json"),
}
GOLDEN_N = 10
GOLDEN_ALLOPS = os.path.join(FIXTURES, "allops_golden.json")
GOLDEN_ALLOPS_POSEIDON = os.path.join(FIXTURES, "allops_golden_poseidon.json")
GOLDEN_ALLOPS_FULL = os.path.join(FIXTURES, "allops_golden_full.json")


def golden_record(n: int = GOLDEN_N, merkle_hasher: str = "blake3") -> dict:
    from chip_smoke import write_fib_program
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
    config = StarkConfig.standard_fast_config()
    config.merkle_hasher = merkle_hasher
    proof = prove_with_traces(ola, config, traces, public_values=pv)
    data = serialize_all_proof(proof)
    record = {"N": n}
    if merkle_hasher != "blake3":
        record["merkle_hasher"] = merkle_hasher
    record.update({
        "public_values": {"pre_root": [int(x) for x in pre],
                          "post_root": [int(x) for x in post]},
        "proof_sha256": hashlib.sha256(data).hexdigest(),
        "proof_bytes": len(data),
    })
    return record


def cli_golden_record(n: int = GOLDEN_N) -> dict:
    from chip_smoke import cli_stages
    from olavm_tpu.cli.main import main

    with tempfile.TemporaryDirectory() as d:
        argvs, out = cli_stages(n, d)
        for stage in ("asm", "run"):
            main(argvs[stage])
        main(argvs["prove"] + ["-b", "host"])
        with open(out["prove"], "rb") as f:
            data = f.read()
    return {"N": n, "calldata": [0, 0], "backend": "host",
            "proof_sha256": hashlib.sha256(data).hexdigest(),
            "proof_bytes": len(data)}


def full_golden_record(merkle_hasher: str) -> dict:
    from chip_smoke import FULL_N

    return golden_record(FULL_N, merkle_hasher)


def node_golden_record() -> dict:
    from chip_smoke import NODE_CALLEE, NODE_CALLER, node_tx
    from olavm_tpu.stark.config import StarkConfig
    from olavm_tpu.stark.prover import prove_with_traces
    from olavm_tpu.stark.serialization import serialize_all_proof

    _, trace, traces, pv, ola = node_tx("olavm_tpu")
    proof = prove_with_traces(ola, StarkConfig.standard_fast_config(), traces,
                              public_values=pv)
    data = serialize_all_proof(proof)
    return {"contracts": [{"program": name, "address": list(addr)}
                          for name, addr in (NODE_CALLER, NODE_CALLEE)],
            "steps": len(trace.exec), "sccall_rows": len(trace.sc_call),
            "table_shapes": [list(t.shape) for t in traces],
            "public_values": {
                "pre_root": [int(x) for x in pv.pre_state_root],
                "post_root": [int(x) for x in pv.post_state_root]},
            "proof_sha256": hashlib.sha256(data).hexdigest(),
            "proof_bytes": len(data)}


def allops_golden_record(k: int | None = None,
                         merkle_hasher: str = "blake3") -> dict:
    from chip_smoke import ALLOPS_CALLDATA, allops_traces
    from olavm_tpu.stark.config import StarkConfig
    from olavm_tpu.stark.prover import prove_with_traces
    from olavm_tpu.stark.serialization import serialize_all_proof

    from chip_smoke import ALLOPS_K

    k = ALLOPS_K if k is None else k
    traces, pv, ola, program_sha256 = allops_traces(k, "olavm_tpu")
    config = StarkConfig.standard_fast_config()
    config.merkle_hasher = merkle_hasher
    proof = prove_with_traces(ola, config, traces, public_values=pv)
    data = serialize_all_proof(proof)
    record = {"K": k, "calldata": ALLOPS_CALLDATA,
              "program_sha256": program_sha256}
    if merkle_hasher != "blake3":
        record["merkle_hasher"] = merkle_hasher
    record.update({
        "table_shapes": [list(t.shape) for t in traces],
        "public_values": {
            "pre_root": [int(x) for x in pv.pre_state_root],
            "post_root": [int(x) for x in pv.post_state_root]},
        "proof_sha256": hashlib.sha256(data).hexdigest(),
        "proof_bytes": len(data),
    })
    return record


def allops_full_golden_record() -> dict:
    from chip_smoke import ALLOPS_K_FULL

    return allops_golden_record(ALLOPS_K_FULL)


RECORDS = {
    GOLDEN: golden_record,
    GOLDEN_POSEIDON: lambda: golden_record(merkle_hasher="poseidon"),
    GOLDEN_CLI: cli_golden_record,
    GOLDEN_NODE: node_golden_record,
    GOLDEN_ALLOPS: allops_golden_record,
    GOLDEN_ALLOPS_POSEIDON: lambda: allops_golden_record(
        merkle_hasher="poseidon"),
    GOLDEN_ALLOPS_FULL: allops_full_golden_record,
    **{path: functools.partial(full_golden_record, hasher)
       for hasher, path in GOLDEN_FULL.items()},
}


@pytest.mark.slow
@pytest.mark.parametrize("path", sorted(RECORDS), ids=os.path.basename)
def test_golden_matches_reference_prover(path):
    with open(path) as f:
        want = json.load(f)
    want.pop("host_prover", None)  # the time and memory it took to make
    assert RECORDS[path]() == want


if __name__ == "__main__":
    import argparse
    import resource
    import time

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--full", choices=sorted(GOLDEN_FULL),
                        help="rewrite this hasher's full-size golden only")
    parser.add_argument("--node", action="store_true",
                        help="rewrite the node golden only")
    parser.add_argument("--allops", type=int, metavar="K",
                        help="rewrite the instruction-set goldens at K loop "
                             "iterations: chip_smoke.ALLOPS_K (both hashers) "
                             "or chip_smoke.ALLOPS_K_FULL (blake3)")
    args = parser.parse_args()
    # the repository root, for chip_smoke
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    from chip_smoke import ALLOPS_K, ALLOPS_K_FULL

    jax.config.update("jax_platforms", "cpu")
    if args.allops is not None:
        if args.allops not in (ALLOPS_K, ALLOPS_K_FULL):
            parser.error(f"--allops takes {ALLOPS_K} or {ALLOPS_K_FULL}")
        paths = ([GOLDEN_ALLOPS, GOLDEN_ALLOPS_POSEIDON]
                 if args.allops == ALLOPS_K else [GOLDEN_ALLOPS_FULL])
    elif args.full:
        paths = [GOLDEN_FULL[args.full]]
    elif args.node:
        paths = [GOLDEN_NODE]
    else:
        paths = [GOLDEN, GOLDEN_POSEIDON, GOLDEN_CLI]
    for path in paths:
        t0 = time.perf_counter()
        result = RECORDS[path]()
        seconds = time.perf_counter() - t0
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20  # KiB
        if path in (GOLDEN_ALLOPS, GOLDEN_ALLOPS_POSEIDON, GOLDEN_ALLOPS_FULL):
            # what olavm_tpu's host prover took, on this host's cores
            result["host_prover"] = {
                "seconds": round(seconds, 1), "peak_resident_gib":
                round(peak, 2), "cpu_count": os.cpu_count()}
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")
        print(f"{os.path.basename(path)}: {seconds:.1f} s, "
              f"peak resident {peak:.2f} GiB so far")
