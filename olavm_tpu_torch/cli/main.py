"""`ola-torch` CLI: asm | run | prove | verify; counterpart of
olavm_tpu/cli/main.py (reference client/src/main.rs:35-242), with the same
options and outputs.

Stages communicate through files, exactly like the reference pipeline:
asm JSON -> BinaryProgram JSON -> Trace JSON -> proof bytes. `prove` can
therefore resume from a saved trace.

The one difference is the prover backend: `-b device` (the default) proves
on the CUDA card and raises where there is none; `-b host` runs the numpy
prover (stark/prover.py). Nothing drops to the CPU by itself.
"""

from __future__ import annotations

import argparse
import sys
import time


def cmd_asm(args):
    from ..assembler.encoder import encode_asm_from_json_file

    bp = encode_asm_from_json_file(args.input)
    with open(args.output, "w") as f:
        f.write(bp.dumps())
    print("Asm done!")


def cmd_run(args):
    from ..runtime.harness import run_program_full
    from ..runtime.trace_io import trace_to_json

    with open(args.args) as f:
        calldata = [int(line.strip()) for line in f if line.strip()]
    if len(calldata) < 2:
        raise SystemExit("args length must be larger than 2")

    t0 = time.time()
    _, program, _ = run_program_full(
        args.input, calldata, from_binary=True,
        dump_on_failure=args.output + ".dump.json",
    )
    print(f"exec time: {int((time.time() - t0) * 1000)}ms")

    t0 = time.time()
    with open(args.output, "w") as f:
        f.write(trace_to_json(program.trace))
    print(f"write time: {int((time.time() - t0) * 1000)}ms")
    print("Run done!")


def cmd_prove(args):
    from ..runtime.trace_io import trace_from_json
    from ..stark.config import StarkConfig
    from ..stark.proof import PublicValues
    from ..stark.serialization import serialize_all_proof
    from ..tables.ola_stark import OlaStark, generate_traces
    from ..utils.timing import TimingTree

    if args.backend == "device":
        import torch

        # its default device is the card
        from ..stark.prover_device import (
            prove_with_traces_device as prove_with_traces,
        )

        if not torch.cuda.is_available():  # before the trace is read
            raise RuntimeError("prove -b device: no CUDA device is available; "
                               "pass -b host to prove with the host prover")
    else:
        from ..stark.prover import prove_with_traces

    with open(args.input) as f:
        trace = trace_from_json(f.read())

    class _P:  # adapter: generate_traces only needs .trace
        pass

    prog = _P()
    prog.trace = trace
    ola = OlaStark()
    t0 = time.time()
    traces = generate_traces(prog, ola)
    print(f"trace-gen time: {time.time() - t0:.3f}s")

    pre, post = trace.start_end_roots
    pv = PublicValues(tuple(pre), tuple(post), 0)
    timing = TimingTree()
    t0 = time.time()
    proof = prove_with_traces(
        ola, StarkConfig.standard_fast_config(), traces, public_values=pv,
        timing=timing,
    )
    print(f"prove time: {time.time() - t0:.3f}s")
    data = serialize_all_proof(proof)
    with open(args.output, "wb") as f:
        f.write(data)
    print(f"proof size: {len(data)}")
    print("Prove done!")


def cmd_verify(args):
    from ..stark.config import StarkConfig
    from ..stark.serialization import deserialize_all_proof
    from ..stark.verifier import verify_proof
    from ..tables.ola_stark import OlaStark

    with open(args.input, "rb") as f:
        proof = deserialize_all_proof(f.read())
    ola = OlaStark()
    ola.set_compress_challenges(proof.compress_challenges)
    t0 = time.time()
    verify_proof(ola, proof, StarkConfig.standard_fast_config())
    print(f"verify time: {time.time() - t0:.3f}s")
    print("Verify succeed!")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ola-torch",
                                     description="Olavm cli (PyTorch/CUDA)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("asm", help="assemble .asm JSON to executable code")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.set_defaults(fn=cmd_asm)

    p = sub.add_parser("run", help="run a program from a binary code file")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-a", "--args", required=True, help="calldata file, one u64/line")
    p.add_argument("-o", "--output", required=True)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("prove", help="generate proof from an execution trace")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-b", "--backend", choices=["device", "host"],
                   default="device",
                   help="prover backend: device (the CUDA card; raises where "
                        "there is none) or host (the numpy prover)")
    p.set_defaults(fn=cmd_prove)

    p = sub.add_parser("verify", help="verify a generated proof")
    p.add_argument("-i", "--input", required=True)
    p.set_defaults(fn=cmd_verify)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
