#!/usr/bin/env python3
"""Drive the PyTorch port's main path (olavm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card; builds the kernels

Phases, in order; each raises on failure and the script then exits nonzero
without printing a result:

1. environment: the card's name and power limit; build every kernel of
   olavm_tpu_torch/csrc with nvcc (one process per source, in parallel),
   then K6, the 12 tables' generated constraint kernels
   (stark/constraint_codegen.py), one nvcc per table, in parallel;
2. each kernel against its plain PyTorch version on the card, bit-exact
   (tolerance 0: every value is exact field or hash arithmetic), with
   CUDA-event times of both and the least time the card could take for the
   same work (`bound_ms`, from the shapes of this run): K1 at every log n
   from 1 to 26, the absorb kernels of the streamed commit at every leaf
   width class (a streamed leaf hash also against the one-shot leaf kernel,
   at (94, 2^23) too), K5 at every edge of its launch plan and at every
   shape of an N=94000 prove (K5_SHAPES), timed at (94, 2^20) x 28 and x 4
   points; K6 on one residue class of each table at N=94000's shapes and
   K=512's PoseidonStark (134, 2^20) and StorageAccessStark (48, 2^19)
   (QUOTIENT_SHAPES): the class (coset scaling, K1, selectors, K6) against
   the op-by-op quotient_class_ops and the slices against their plain
   version, exactly, each timed, with K6's bound, and a class whose values
   are EDGE_VALUES (p - 1, EPSILON, ...: the lazy helpers' PTX reaches
   2^64 - 1) against both; no K6 slice may spill (ptxas -v); the coset
   scaling and selector kernels against their plain versions at (94, 2^20);
   K7, inversion, in the base field at 2^21 (the permutation Z's) and in
   the extension at 2^24 (the largest LDE of the FRI composition, which
   inverted with it until K10), and K8, the grand-product scan, inclusive
   and exclusive, into a new array and in place, at the main path's
   shapes (SCAN_SHAPES: CpuStark's 78 CTL Zs at 2^20 in one launch and in
   a group of 26, BitwiseStark's 8 permutation batches at 2^18,
   ProgramStark's 4 Zs at 2^21, single rows) and at lengths 1, 3 and a
   tile + 1, each with edge values and zeros (all zeros, a zero in every
   chunk of a thread), each SCAN_SHAPES shape timed; K9 and K10, the FRI
   composition's combine and quotient passes, at the composition's shapes
   of CpuStark at N=94000 and N=376000 and PoseidonStark at K=512 (n =
   2^20 or 2^22, an LDE of 8 n, three batches) and on edge values with a
   zero norm, K9 timed at each, and the composition they make against the
   op-by-op chain it replaced (fri_composition_ops); K11, a CTL Z's row
   combination, on
   the widest view of CpuStark (2^20 rows) and ProgramStark (2^21) at
   N=94000 and of PoseidonStark at K=512 (2^20 rows, 25 trace columns),
   on every view at 2^10 rows of edge values (filters of 0, 1, 2 and
   p - 1) and on a view without columns; K12, the FRI fold, at 2^24 and
   2^20 by 16, at every arity on edge values and on a slice that starts
   past the vector's start (a mesh rank's rows); each timed beside the
   op-by-op chain it replaced; K13, power tables, in the extension at
   every table degree of an N=94000 prove, N=376000's largest and ragged
   lengths, for every edge base, and in the base field as the query
   points' (28, n) rows and on one base, timed at 2^21 beside the
   log-doubling chain it replaced; and ROADMAP Queue 3, item 1: goldilocks.cuh's
   lazy helpers on every pair of edge words, and 160-bit sums started at
   a multiple of p that take terms off (LAZY_SOURCE), built by nvcc and
   run on the card, word for word against the same source built by g++
   and against Python's integers mod p;
3. parity with the JAX package: the fib-loop fixture at N=10 proved on the
   card four times on one trace generation, as a capture and a replay with
   each Merkle hasher: with blake3 caps (its programs captured), then
   Poseidon caps (replaying them under other challenges), then, with the
   programs dropped, Poseidon (captured) and blake3 (replayed); each must
   serialize to the sha256 and length of the golden that olavm_tpu's host
   prover produced (tests/fixtures/fib_loop_golden.json,
   fib_loop_golden_poseidon.json), the port's verifier must accept it, and
   each replaying prove must capture no program;
4. full size: the fixture at N=94000 (2^20 CPU rows) through
   run_program_fast -> generate_traces_fast, then prove_with_traces_device
   -> verify_proof four times on those traces in the same turns, each proof
   equal to the golden that olavm_tpu's host prover made at N=94000
   (tests/fixtures/fib_loop_golden_full.json and
   fib_loop_golden_full_poseidon.json);
4b. the instruction set, with N=94000's programs still held: the fixture
   tests/fixtures/allops_asm.json (24 of the 26 opcodes in a loop of K
   iterations; PoseidonStark, PoseidonChunkStark, StorageAccessStark and
   TapeStark hold rows) through the interpreter path, run_program_full ->
   generate_traces, at K=ALLOPS_K proved with blake3 caps (capturing) and
   Poseidon caps (replaying), then at K=ALLOPS_K_FULL (PoseidonStark (134,
   2^20), StorageAccessStark (48, 2^19)) proved twice with blake3 caps
   (capturing, then replaying), each proof equal to the golden that
   olavm_tpu's host prover made (tests/fixtures/allops_golden.json,
   allops_golden_poseidon.json, allops_golden_full.json); then N=376000
   (2^22 CPU rows) with blake3 caps, proved and verified on top of every
   earlier size's programs (no golden exists at this size); then, with the
   programs dropped, K=ALLOPS_K with Poseidon caps (capturing) and blake3
   caps (replaying);
5. the node: olavm_tpu_torch.node's OlaVM deploys the sccall fixture pair
   (manual_deploy), runs the caller's tx (execute_tx), merges its envs
   (gen_tx_trace) and generates its tables; the card proves them, the
   verifier accepts, and the proof must equal
   tests/fixtures/node_sccall_golden.json (olavm_tpu's node and host
   prover);
6. the CLI on the card: ola-torch asm, run (calldata 0, 0), prove (its
   default backend, the card) and verify at N=10, in this process through
   olavm_tpu_torch.cli.main.main; the proof must equal
   tests/fixtures/cli_fib_golden.json, which olavm_tpu's `ola` CLI wrote
   with its host prover;
7. the sharded prover (olavm_tpu_torch/parallel/sharded.py), one process
   per rank spawned by run_ranks with the kernels of phase 1: two ranks on
   cuda:0 over gloo prove phase 4's N=94000 traces with blake3 caps and
   phase 3's N=10 traces with Poseidon caps, one rank over NCCL proves
   N=10 with blake3 caps; every rank's proof must equal the golden of its
   single-device path, and in the group of two every sharded phase (the
   column-sharded iNTT, the commit, the quotient's classes, the FRI fold
   and trees) must have run on every rank.

Every prove runs with the device prover's programs (olavm_tpu_torch/utils/
jitcache.py: CUDA graphs captured at their first use in the process and
replayed after, and dropped only where phases 3, 4 and 4b cross their
turns: a prove that outgrows the programs' buffers frees those of the
graphs it does not use, so the sizes need no clear() between them; the
ranks of phase 7 capture their own). Every prove of phases 3-5, and every
rank's prove of phase 7, is one run of the main path: each
kernel's launch count is reset just before it and read just after it (in
the rank's own process), counting the launches the host issued and those
that graph replays ran (each capture records its graph's launches, and
each replay adds them); the run must have launched its
hasher's kernels (K1, K2, K3, add, K5, K6 with the coset scaling and
selector kernels, K7 in the base field, K8, K9, K10, K11, K12, K13 in both
fields, and the hasher's leaf, absorb and level kernels), none of the other
hasher's, no K7 in the extension and no sub kernel, no K3, add or sub
inside a quotient, CTL Z or FRI fold program, none of those or K7 inside a FRI composition program, no
plain inversion, scan, composition pass, CTL row combination, fold or
log-doubling power table on a CUDA tensor (the chains K7-K13 replaced
refuse one during the prove), no gf.power_rows outside ntt.twiddles, no
graph node of an openings' power table (extpows) or FRI re-FFT
(fri_refft) program but its kernels (K13; gl_scale_powers and K1) and its
outputs' copies (so no K3, add, sub, cat or fill), no graph node of a
table's CTL Zs (ctlz: K11 a view, one K8 and its scratch's fill) or
permutation batches (permz: the num and den chains' K3, add and fills,
one K7, K3 and K8) but those (program_kernels), and its leaf and absorb
kernels as often as its commits' shapes need. Each records prove and verify seconds
(a group verifies on rank 0), peak device memory and the host's peak
resident memory.

At the end neither jax nor any module of olavm_tpu may have been loaded, in
this process or in any rank. The
last lines are every prove's seconds, peak memory, launch counts and
sha256, the programs (per tag at N=94000, per prove the launches the host
issued and those replayed, the reserved peak and the programs' bytes
beside the card's memory, and K3's launches by program tag), the nanoseconds per permutation of K2 and of the Poseidon leaf and
level kernels at their largest shapes, the `kernels` JSON line (launches
summed over the proves), the card's nvidia-smi line and the result line
{"ok": true, "device": {...}}. A longer report goes to
chip_smoke_out/report.json.
"""

from __future__ import annotations

import ast
import contextlib
import hashlib
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
REPORT_DIR = os.path.join(ROOT, "chip_smoke_out")
FULL_N = 94000  # 1,034,005 steps -> 2^20 CPU rows
SEED = 0  # random kernel inputs
_P, _EPSILON = 0xFFFFFFFF00000001, 0xFFFFFFFF  # Goldilocks p, 2^64 mod p
# lanes at which the plain Poseidon Merkle versions are timed: at the full
# 2^23 they would need (12, 12, 2^23) int64 temporaries (9.7 GB each)
PLAIN_N = 1 << 16

# The card's peaks for `bound_ms` (NVIDIA's H100 SXM data sheet): 3.35 TB/s of
# device memory, and 67 TFLOP/s of float32 outside the tensor cores, which is
# 128 lanes per SM doing one 2-flop multiply-add per clock. Integer work runs
# on two pipes of 64 lanes per SM each, one 32-bit result per lane per clock:
# the multiply pipe (IMAD, a quarter of the float32 figure) takes the
# multiplies, the ALU pipe takes logic, shifts, three-term adds, compares and
# selects, and two-term adds, carries and moves issue on either (ptxas writes
# them as IMAD.IADD, IMAD.X, IMAD.MOV). The four schedulers issue at most 128
# lanes per SM per clock between them: half the float32 figure.
PEAK_BYTES_PER_S = 3.35e12
PEAK_PIPE_OPS_PER_S = 67e12 / 4
PEAK_ISSUE_OPS_PER_S = 67e12 / 2
# 32-bit integer operations that one Goldilocks operation needs, operands
# being two 32-bit words: a general 64x64->128 product is 4 products of
# 32x32->64, each a low and a high word on the multiply pipe (8), with the
# cross terms' adds fused into them as multiply-adds and 2 carries left
# (~10); reducing its 128 bits to a canonical word is ~10 more; an add or a
# sub is a 2-word add, a compare and a 2-word correction. Of these, only the
# multiplies are tied to a pipe here: the compares and selects of the
# reductions go to the either-pipe share, which can only lower the bound.
OPS_PRODUCT, OPS_REDUCE, OPS_ADD = 10, 10, 6
MUL_PRODUCT = 8
OPS_MUL = OPS_PRODUCT + OPS_REDUCE  # 20, of which 8 multiplies
# A dot product of full-size values needs one reduction, not one per term:
# each product is added unreduced into a 3-word sum (lo, hi, top: a 4-limb
# add with carries and the carry into top, ~5), and the sum is reduced once
# (top x EPSILON folded into hi: a shift-subtract, a 2-word add and a
# correction, ~4; then the 128-bit reduction).
OPS_ACCUMULATE = 5
OPS_REDUCE_WIDE = 4 + OPS_REDUCE  # 14
# one blake3 compression: 7 rounds x 8 G x (4 adds, two of them of three
# terms, which the card does as one instruction, + 4 xors + 4 rotates), and 8
# xors for the truncated output; all but the two two-term adds of each G are
# ALU-only
OPS_BLAKE3 = 7 * 8 * 12 + 8  # 680
ALU_BLAKE3 = 7 * 8 * 10 + 8  # 568
# One Poseidon permutation, counted by what the function needs.
# The MDS entries are constants of at most 41 (6 bits), and a row's entries
# sum to at most 264, so a word cut into limbs of 22, 22 and 20 bits (an and;
# a shift and an and; a shift: 4) gives row sums of entry x limb below 2^31:
# a term c x s_j is three 32-bit multiply-adds of one result (3 multiplies,
# not the 4 results of two 32x32->64 products). An output
# puts its three sums together and folds the bits above 2^64 (two shifts
# and 2-word adds, a carry, the top bits, one fold times EPSILON; ~14). Row 0
# has the diagonal's 8 as a 13th term.
MUL_MDS_TERM = 3
OPS_MDS_SPLIT = 4
OPS_MDS_OUTPUT = 12 * MUL_MDS_TERM + 14  # 50, against 13 * 20 + 12 * 6 = 332 in general
OPS_MDS_LAYER = 12 * OPS_MDS_SPLIT + 12 * OPS_MDS_OUTPUT + MUL_MDS_TERM  # 651
MUL_MDS_LAYER = (12 * 12 + 1) * MUL_MDS_TERM  # 435
# a full round: 12 constant adds, 12 x^7 of 4 general products (a chain, so
# each product reduced), the MDS layer: 72 + 960 + 651 = 1683, of which
# 48 x 8 + 435 = 819 multiplies
OPS_FULL_ROUND = 12 * OPS_ADD + 12 * 4 * OPS_MUL + OPS_MDS_LAYER  # 1683
MUL_FULL_ROUND = 12 * 4 * MUL_PRODUCT + MUL_MDS_LAYER  # 819
# a 64-bit word times a small constant added into a wider sum: two 32x32->64
# products (4 multiplies)
MUL_SMALL_TERM = 4


def ops_dot(k: int) -> int:
    """A dot product of k full-size terms: k products and accumulates, one
    wide reduction (k x 8 of them multiplies)."""
    return k * (OPS_PRODUCT + OPS_ACCUMULATE) + OPS_REDUCE_WIDE


# before the partial rounds: 12 constant adds and the dense 11x11 matrix of
# full-size constants, 11 dot products of 11 terms:
# 72 + 11 x (11 x 15 + 14) = 2041 (3152 when every product was reduced),
# of which 121 x 8 = 968 multiplies
OPS_PARTIAL_ENTRY = 12 * OPS_ADD + 11 * ops_dot(11)  # 2041
MUL_PARTIAL_ENTRY = 11 * 11 * MUL_PRODUCT  # 968
# a partial round: one x^7 (80), one constant add (6); word 0 is
# 25 * s0 (a small-constant term: 4 multiplies into the sum) plus the W_HATS
# row, one dot product of 11 terms (4 + 179); each of the 11 other words is
# s_i + s0 * VS_i, a product, s_i added into its 128 bits, one reduction
# (11 x 25): 80 + 6 + 183 + 275 = 544 (671 when every product was reduced),
# of which 4 x 8 + 4 + 11 x 8 + 11 x 8 = 212 multiplies
OPS_PARTIAL_ROUND = (4 * OPS_MUL + OPS_ADD + MUL_SMALL_TERM + ops_dot(11)
                     + 11 * (OPS_PRODUCT + OPS_ACCUMULATE + OPS_REDUCE))  # 544
MUL_PARTIAL_ROUND = 4 * MUL_PRODUCT + MUL_SMALL_TERM + 2 * 11 * MUL_PRODUCT  # 212
# 8 full rounds, 22 partial rounds (the last adds no constant):
# 8 x 1683 + 2041 + 22 x 544 - 6 = 27,467 operations, of which
# 8 x 819 + 968 + 22 x 212 = 12,184 multiplies. Per SM and clock that is
# 12,184 / 64 = 190.4 clocks on the multiply pipe and 27,467 / 128 = 214.6
# clocks of issue: the issue rate bounds it, 0.2149 ms at (12, 2^18)
# (with the MDS term as two 32x32->64 products: 27,955 and 13,344,
# 0.2188 ms).
OPS_POSEIDON = (8 * OPS_FULL_ROUND + OPS_PARTIAL_ENTRY
                + 22 * OPS_PARTIAL_ROUND - OPS_ADD)
MUL_POSEIDON = 8 * MUL_FULL_ROUND + MUL_PARTIAL_ENTRY + 22 * MUL_PARTIAL_ROUND


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def write_fib_program(n: int, directory: str) -> str:
    """The fib-loop fixture with N substituted, as an asm JSON file."""
    with open(os.path.join(FIXTURES, "fib_loop_asm.json")) as f:
        spec = json.load(f)
    spec["program"] = spec["program"].replace("{N}", str(n))
    path = os.path.join(directory, f"fib_loop_{n}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return path


# the instruction-set program (tests/fixtures/allops_asm.json): 24 of the 26
# opcodes (all but SCCALL and SIGCHECK) in a loop of K iterations, run through
# run_program_full with this calldata (which sets up the tape); PoseidonStark
# has about 2^11 K rows, StorageAccessStark 2^10 K
ALLOPS_K = 4
ALLOPS_K_FULL = 512  # PoseidonStark (134, 2^20), StorageAccessStark (48, 2^19)
ALLOPS_CALLDATA = [0, 0]


def write_allops_program(k: int, directory: str) -> str:
    """The instruction-set fixture with K substituted, as an asm JSON file."""
    with open(os.path.join(FIXTURES, "allops_asm.json")) as f:
        spec = json.load(f)
    spec["program"] = spec["program"].replace("{K}", str(k))
    path = os.path.join(directory, f"allops_{k}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return path


def allops_traces(k: int, package: str = "olavm_tpu_torch"):
    """The instruction-set fixture at K=k through `package`'s
    run_program_full (calldata ALLOPS_CALLDATA) and generate_traces.
    Returns (traces, public_values, ola, program_sha256), the last the sha256
    of the assembled bytecode."""
    import importlib

    encoder = importlib.import_module(f"{package}.assembler.encoder")
    harness = importlib.import_module(f"{package}.runtime.harness")
    ola_stark = importlib.import_module(f"{package}.tables.ola_stark")
    proof = importlib.import_module(f"{package}.stark.proof")

    with tempfile.TemporaryDirectory() as d:
        path = write_allops_program(k, d)
        bytecode = encoder.encode_asm_from_json_file(path).bytecode
        _, program, _ = harness.run_program_full(path, calldata=ALLOPS_CALLDATA)
    ola = ola_stark.OlaStark()
    traces = ola_stark.generate_traces(program, ola)
    pre, post = program.trace.start_end_roots
    public_values = proof.PublicValues(tuple(pre), tuple(post), 0)
    return (traces, public_values, ola,
            hashlib.sha256(bytecode.encode()).hexdigest())


# the node path: a caller and a callee written by hand in the fixtures' asm
# JSON, deployed at these addresses; the caller's tx makes one SCCALL (op1 0)
NODE_CALLER = ("sccall_caller_asm.json", (1, 1, 1, 1))
NODE_CALLEE = ("sccall_callee_asm.json", (1, 0, 1, 0))


def node_tx(package: str = "olavm_tpu_torch"):
    """Deploy the sccall fixture pair on a fresh in-memory node of `package`
    (OlaVM.manual_deploy), run the caller's tx (execute_tx), merge its envs
    (gen_tx_trace) and generate the 12 tables (generate_traces). Returns
    (node, trace, traces, public_values, ola)."""
    import importlib

    encoder = importlib.import_module(f"{package}.assembler.encoder")
    olavm = importlib.import_module(f"{package}.node.olavm")
    ola_stark = importlib.import_module(f"{package}.tables.ola_stark")
    proof = importlib.import_module(f"{package}.stark.proof")

    node = olavm.OlaVM()
    for name, addr in (NODE_CALLER, NODE_CALLEE):
        node.manual_deploy(encoder.encode_asm_from_json_file(
            os.path.join(FIXTURES, name)), addr)
    node.execute_tx(NODE_CALLER[1], NODE_CALLER[1], list(NODE_CALLEE[1]))
    trace = node.ola_state.gen_tx_trace()

    class Executed:  # what generate_traces reads of a program
        pass

    program = Executed()
    program.trace = trace
    ola = ola_stark.OlaStark()
    traces = ola_stark.generate_traces(program, ola)
    pre, post = trace.start_end_roots
    public_values = proof.PublicValues(tuple(pre), tuple(post), 0)
    return node, trace, traces, public_values, ola


def cli_stages(n: int, directory: str):
    """The argv of the CLI's asm, run, prove and verify stages on the fib-loop
    fixture at N=n with calldata 0, 0, all files in `directory` (the program
    and the calldata are written there first). Returns (argvs by stage,
    output paths by stage)."""
    program = write_fib_program(n, directory)
    calldata = os.path.join(directory, "calldata.txt")
    with open(calldata, "w") as f:
        f.write("0\n0\n")
    out = {stage: os.path.join(directory, name) for stage, name in (
        ("asm", "fib.bin.json"), ("run", "trace.json"), ("prove", "proof.bin"))}
    argvs = {
        "asm": ["asm", "-i", program, "-o", out["asm"]],
        "run": ["run", "-i", out["asm"], "-a", calldata, "-o", out["run"]],
        "prove": ["prove", "-i", out["run"], "-o", out["prove"]],
        "verify": ["verify", "-i", out["prove"]],
    }
    return argvs, out


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device milliseconds per call of the kernels `fn` launches, from
    torch.profiler: at shapes where a call takes less than the host needs
    to issue it, CUDA events around back-to-back calls time the host. A
    trace that shows no device time (seen once on the card, between traces
    that did) is taken again; after three such, CUDA events time `fn`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(getattr(e, "device_time_total", None)
                       or getattr(e, "cuda_time_total", 0.0)
                       for e in prof.key_averages())
        if total_us > 0:
            return total_us / 1e3 / reps
    log("  device_ms: the profiler saw no device time; CUDA events instead")
    return cuda_ms(fn, reps)


def bound(nbytes: float, int_ops: float, mul: float = 0, alu: float = 0) -> dict:
    """The least time the card could take: every input byte read once and
    every output byte written once at the memory's rate, or the 32-bit integer
    operations at their rates, whichever is larger. Of the `int_ops`, `mul`
    run only on the multiply pipe and `alu` only on the ALU pipe; the rest
    issue on either."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = max(mul / PEAK_PIPE_OPS_PER_S, alu / PEAK_PIPE_OPS_PER_S,
                 int_ops / PEAK_ISSUE_OPS_PER_S) * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "int32_ops": int_ops, "mul_ops": mul,
            "alu_ops": alu}


def max_abs_err(a, b) -> int:
    """Largest |a - b| over the canonical values; 0 when bit-exact."""
    import numpy as np
    import torch

    from olavm_tpu_torch.field import gf

    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {tuple(a.shape)} {tuple(b.shape)}")
    if torch.equal(a, b):
        return 0
    x, y = gf.to_u64(a), gf.to_u64(b)
    return int(np.where(x > y, x - y, y - x).max())


def check_kernels(device, rng) -> dict:
    """Every kernel against its plain version at the main path's shapes."""
    import numpy as np
    import torch

    from olavm_tpu_torch import kernels
    from olavm_tpu_torch.field import gf
    from olavm_tpu_torch.hash import poseidon as pos
    from olavm_tpu_torch.merkle import device as dmerkle
    from olavm_tpu_torch.ntt import ntt as dntt

    def rand(shape):
        return gf.from_u64(rng.integers(0, gf.P, shape, dtype=np.uint64), device)

    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 31)))

    def rand_on_card(shape, high=1 << 62):
        # canonical values made on the card, for the shapes too large to make
        # on the host in reasonable time
        return torch.randint(0, high, shape, generator=gen, device=device)

    results = {}

    def record(name, err, ms, plain_ms, least, detail):
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         **least, "library_ms": None, "checked": detail}
        log(f"  {name}: max_abs_err={err} kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {least['bound_ms']:.4f} ms by "
            f"{least['bound_by']} ({detail})")
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version")

    # K3 and its add/sub siblings: 2^24 elements with the edge values, full
    # operands and a 0-dim operand on either side
    edge = np.array([0, 1, gf.P - 1, 2**32 - 1, 2**32], dtype=np.uint64)
    n = 1 << 24
    av = np.concatenate([edge, rng.integers(0, gf.P, n - 5, dtype=np.uint64)])
    bv = np.concatenate([edge[::-1], edge,
                         rng.integers(0, gf.P, n - 10, dtype=np.uint64)])
    a, b = gf.from_u64(av, device), gf.from_u64(bv, device)
    grid = gf.from_u64(np.repeat(edge, 5), device)
    grid_t = gf.from_u64(np.tile(edge, 5), device)
    for name, fn, plain, ops, mul in (
            ("gf_mul", gf.mul, gf.mul_plain, OPS_MUL, MUL_PRODUCT),
            ("gf_add", gf.add, gf.add_plain, OPS_ADD, 0),
            ("gf_sub", gf.sub, gf.sub_plain, OPS_ADD, 0)):
        err = max_abs_err(fn(a, b), plain(a, b))
        err = max(err, max_abs_err(fn(grid, grid_t), plain(grid, grid_t)))
        for v in edge:
            s = gf.scalar(int(v), device)
            err = max(err, max_abs_err(fn(a, s), plain(a, s)),
                      max_abs_err(fn(s, b), plain(s, b)))
        ms = cuda_ms(lambda: fn(a, b), 20)
        plain_ms = cuda_ms(lambda: plain(a, b), 5)
        record(name, err, ms, plain_ms, bound(24 * n, ops * n, mul * n),
               "2^24 elements, edge grid, 0-dim operand on each side")
    del a, b

    # K1: forward and inverse at every log n from 1 to 26 at a small batch (so
    # every split of the stages into passes runs, with blocks whose last
    # columns are empty), then at the commit shapes; (18, 2^24) is
    # ProgramStark's x8 LDE at 2^20 CPU rows, and the 2^22-row prove reaches
    # LDEs of 2^25 and 2^26 points
    err = 0
    times = {}
    passes = {}
    shapes = [(3 if k <= 20 else 1, 1 << k) for k in range(1, 27)]
    shapes += [(5, 1024), (134, 1024), (94, 1 << 20), (16, 1 << 23),
               (18, 1 << 24)]
    for shape in shapes:
        log_n = shape[1].bit_length() - 1
        passes[log_n] = kernels.lib("ntt").gl_ntt_passes(log_n)
        x = rand(shape) if shape[0] * shape[1] <= 1 << 22 else rand_on_card(shape)
        for inverse in (False, True):
            err = max(err, max_abs_err(dntt._ntt_cuda(x, inverse),
                                       dntt.ntt_plain(x, inverse)))
        if shape == (16, 1 << 23):
            times["ms"] = cuda_ms(lambda: dntt._ntt_cuda(x, False), 10)
            times["plain_ms"] = cuda_ms(lambda: dntt.ntt_plain(x, False), 2)
            count = shape[0] * shape[1]
            # the array in and out and the n/2 twiddles; one add and one sub
            # per butterfly, and one multiply except where the twiddle is 1:
            # the first butterfly of every group, n - 1 of a row's
            # (n / 2) log n
            butterflies = (count // 2) * log_n
            products = butterflies - shape[0] * (shape[1] - 1)
            times["least"] = bound(
                16 * count + 4 * shape[1],
                butterflies * 2 * OPS_ADD + products * OPS_MUL,
                products * MUL_PRODUCT)
        del x
    want = {k: 1 if k <= 13 else 2 if k <= 20 else 3 for k in passes}
    if passes != want:
        raise AssertionError(f"ntt launches per transform {passes}, not {want}")
    results["ntt_launches_per_transform"] = passes
    record("ntt", err, times["ms"], times["plain_ms"], times["least"],
           "forward+inverse at (3,2^k) k=1..20, (1,2^k) k=21..26, (5,1024) "
           "(134,1024) (94,2^20) (16,2^23) (18,2^24); times at (16,2^23)")

    # K2: the PoW grind's batch against the plain version; the edge states
    # against both the plain version and permute_np, and 64 random states
    # against permute_np; the MDS tables are compiled in, so init must
    # refuse others
    st = rand((pos.WIDTH, 1 << 18))
    err = max_abs_err(pos.permute(st), pos.permute_plain(st))
    edge_st = gf.from_u64(pos.edge_states().T.copy(), device)
    err = max(err, max_abs_err(pos.permute(edge_st), pos.permute_plain(edge_st)))
    host = np.concatenate([pos.edge_states(), rng.integers(
        0, gf.P, (64, pos.WIDTH), dtype=np.uint64)])
    got = gf.to_u64(pos.permute(gf.from_u64(host.T.copy(), device))).T
    if not np.array_equal(got, pos.permute_np(host)):
        raise AssertionError("poseidon kernel disagrees with permute_np")
    tables = pos._kernel_tables()
    tables[1] = tables[1] + np.uint64(1)
    if kernels.lib("poseidon").gl_poseidon_init(*[t.ctypes.data for t in tables]) != -1:
        raise AssertionError("gl_poseidon_init took MDS tables other than its own")
    ms = cuda_ms(lambda: pos.permute(st), 20)
    plain_ms = cuda_ms(lambda: pos.permute_plain(st), 3)
    results["permutations"] = {"poseidon": 1 << 18}
    record("poseidon", err, ms, plain_ms,
           bound(2 * 8 * pos.WIDTH * (1 << 18), OPS_POSEIDON * (1 << 18),
                 MUL_POSEIDON * (1 << 18)),
           "(12,2^18) vs plain; edge states (all 0, p-1, 2^32-1, 2^32, "
           "2^64-2^32-1; 0 and p-1 alternating) vs plain and permute_np; 64 "
           "random states vs permute_np; init refuses another MDS table")
    del st

    # K4: leaf digests at every block structure (noop leaves, a partial last
    # block, exactly one chunk, two chunks, the 256-column limit), then the
    # CpuStark LDE's shape with times
    err = 0
    widths = (1, 4, 5, 8, 9, 18, 29, 32, 94, 128, 129, 134, 256)
    for C in widths:
        cols = rand((C, 1000))
        got = dmerkle.leaf_digests(cols)
        plain = (dmerkle.leaf_digests_plain(cols) if C > dmerkle.NOOP_MAX
                 else dmerkle.leaf_digests(cols.cpu()).to(device))
        err = max(err, max_abs_err(got, plain))
    C, n = 94, 1 << 23
    lde = rand_on_card((C, n))
    digs = dmerkle.leaf_digests(lde)
    err = max(err, max_abs_err(digs, dmerkle.leaf_digests_plain(lde)))
    ms = cuda_ms(lambda: dmerkle.leaf_digests(lde), 5)
    plain_ms = cuda_ms(lambda: dmerkle.leaf_digests_plain(lde), 1)
    compressions = (C + 7) // 8 + (1 if C > dmerkle.CHUNK_COLS else 0)
    record("blake3_leaves", err, ms, plain_ms,
           bound(8 * C * n + 64 * n, OPS_BLAKE3 * compressions * n,
                 alu=ALU_BLAKE3 * compressions * n),
           f"C in {widths} at n=1000; (94,2^23) with times")
    del lde

    # K4: one tree level over those digests, 2^23 -> 2^22, and the smallest
    err = max_abs_err(dmerkle.compress_level(digs),
                      dmerkle.compress_level_plain(digs))
    small = rand_on_card((8, 2), 1 << 32)
    err = max(err, max_abs_err(dmerkle.compress_level(small),
                               dmerkle.compress_level_plain(small)))
    ms = cuda_ms(lambda: dmerkle.compress_level(digs), 10)
    plain_ms = cuda_ms(lambda: dmerkle.compress_level_plain(digs), 3)
    record("blake3_level", err, ms, plain_ms,
           bound(64 * n + 32 * n, OPS_BLAKE3 * (n // 2),
                 alu=ALU_BLAKE3 * (n // 2)),
           "(8,2) and (8,2^23) -> (8,2^22); times at 2^23")
    del digs

    # the Poseidon leaf sponge: every width class (a partial last chunk at
    # 9, 17 and 134 = 16 x 8 + 6) at n = 2^14 with leaves of all p-1, all 0
    # and the two alternating; the noop widths through leaf_digests; then
    # the CpuStark LDE's shape with times, its first and last 2^14 leaves
    # against the plain version (the plain version at full size would need
    # (12, 12, 2^23) temporaries and minutes)
    def rand_edges(shape):
        x = rng.integers(0, gf.P, shape, dtype=np.uint64)
        x[:, 0] = gf.P - 1
        x[:, 1] = 0
        x[0::2, 2] = gf.P - 1
        x[1::2, 2] = 0
        return gf.from_u64(x, device)

    err = 0
    small = 1 << 14
    # csrc/poseidon.cu runs one block of 640 threads per SM from 320 items
    # per SM: the widths at both launch shapes, the big one with 77 threads
    # going round the grid a second time
    big = torch.cuda.get_device_properties(device).multi_processor_count * 640 + 77
    widths = (1, 2, 3, 4, 5, 8, 9, 16, 17, 32, 94, 134)
    for C in widths:
        for n_leaves in (small, big):
            cols = rand_edges((C, n_leaves))
            err = max(err, max_abs_err(pos.leaves(cols), pos.leaves_plain(cols)))
        if C <= dmerkle.NOOP_MAX:
            err = max(err, max_abs_err(
                dmerkle.leaf_digests(cols, "poseidon"),
                dmerkle.leaf_digests(cols.cpu(), "poseidon").to(device)))
    C, n = 94, 1 << 23
    lde = rand_on_card((C, n))
    digs = pos.leaves(lde)
    for part in (slice(0, small), slice(n - small, n)):
        err = max(err, max_abs_err(digs[:, part],
                                   pos.leaves_plain(lde[:, part].contiguous())))
    ms = cuda_ms(lambda: pos.leaves(lde), 3)
    plain_cols = lde[:, :PLAIN_N].contiguous()
    plain_ms = cuda_ms(lambda: pos.leaves_plain(plain_cols), 1)
    perms = (C + pos.RATE - 1) // pos.RATE * n
    results["permutations"]["poseidon_leaves"] = perms
    record("poseidon_leaves", err, ms, plain_ms,
           bound(8 * C * n + 64 * n, OPS_POSEIDON * perms, MUL_POSEIDON * perms),
           f"C in {widths} at n=2^14 and n={big} (edge leaves; C<=4 also "
           f"through leaf_digests' noop rule); (94,2^23) with times, its first "
           f"and last 2^14 leaves vs plain; plain timed at (94,{PLAIN_N})")
    results["poseidon_leaves"]["plain_shape"] = [C, PLAIN_N]
    del lde, plain_cols

    # one Poseidon tree level: 2^16 -> 2^15 and 2 * big -> big against the
    # plain version, the smallest level, then 2^23 -> 2^22 over the digests
    # above with times
    level_in = pos.leaves(rand_edges((4, 1 << 16)))
    err = max_abs_err(pos.level(level_in), pos.level_plain(level_in))
    pair = level_in[:, :2].contiguous()
    err = max(err, max_abs_err(pos.level(pair), pos.level_plain(pair)))
    level_big = rand_on_card((8, 2 * big), 1 << 32)
    err = max(err, max_abs_err(pos.level(level_big), pos.level_plain(level_big)))
    del level_big
    parents = pos.level(digs)
    err = max(err, max_abs_err(parents[:, :small],
                               pos.level_plain(digs[:, :2 * small].contiguous())))
    ms = cuda_ms(lambda: pos.level(digs), 10)
    plain_in = digs[:, :PLAIN_N].contiguous()
    plain_ms = cuda_ms(lambda: pos.level_plain(plain_in), 2)
    results["permutations"]["poseidon_level"] = n // 2
    record("poseidon_level", err, ms, plain_ms,
           bound(64 * n + 32 * n, OPS_POSEIDON * (n // 2),
                 MUL_POSEIDON * (n // 2)),
           f"(8,2^16) -> (8,2^15), (8,{2 * big}) -> (8,{big}), (8,2) -> "
           f"(8,1), the first 2^14 parents of (8,2^23) -> (8,2^22); times at "
           f"2^23, plain timed at {PLAIN_N}")
    results["poseidon_level"]["plain_shape"] = [8, PLAIN_N]
    del digs, parents, plain_in
    torch.cuda.synchronize()
    return results


def check_stream_kernels(device, rng) -> dict:
    """The streamed commit's absorb kernels and K5 against their plain
    versions, at every leaf width class and at the main path's shapes."""
    import numpy as np
    import torch

    from olavm_tpu_torch import kernels
    from olavm_tpu_torch.field import gf
    from olavm_tpu_torch.hash import poseidon as pos
    from olavm_tpu_torch.merkle import device as dmerkle
    from olavm_tpu_torch.merkle.device import LeafStream
    from olavm_tpu_torch.ntt import ntt as dntt
    from olavm_tpu_torch.stark.oracle_device import DevicePolynomialBatch

    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 31)))

    def rand(shape, high=1 << 62):
        # canonical values below 2^62 (and p - 1 in the first leaf), on the card
        x = torch.randint(0, high, shape, generator=gen, device=device)
        if high > 1 << 32 and len(shape) == 2:
            x[:, 0] = gf._i64(gf.P - 1)
        return x

    def stream(cols, hasher):
        # the leaves absorbed in blocks of 16 columns, as a commit does
        st = LeafStream(cols.shape[0], cols.shape[1], hasher)
        for start in range(0, cols.shape[0], dmerkle.STREAM_BLOCK_COLS):
            st.absorb(cols[start:start + dmerkle.STREAM_BLOCK_COLS].contiguous())
        return st.finalize()

    results = {}

    def record(name, err, ms, plain_ms, least, detail):
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         **least, "library_ms": None, "checked": detail}
        log(f"  {name}: max_abs_err={err} kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {least['bound_ms']:.4f} ms by "
            f"{least['bound_by']} ({detail})")
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version")

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    # the Poseidon kernels' big launch shape from 320 leaves per SM, going
    # round the grid a second time; 2^14 + 77 leaves: not a multiple of a
    # block of threads
    sizes = {"blake3": (1 << 14, (1 << 14) + 77),
             "poseidon": (1 << 14, sms * 640 + 77)}
    widths = {"blake3": (5, 8, 9, 16, 17, 29, 94, 128, 129, 134, 256),
              "poseidon": (5, 8, 9, 16, 17, 29, 94, 134)}
    n = 1 << 23
    for hasher, name in (("blake3", "blake3_absorb"),
                         ("poseidon", "poseidon_absorb")):
        # the plain version of a leaf's absorbs is the plain sponge or chunk
        # chain over all its columns at once
        one_shot, plain_all = {
            "blake3": (dmerkle.leaf_digests, dmerkle.leaf_digests_plain),
            "poseidon": (pos.leaves, pos.leaves_plain)}[hasher]
        err = 0
        for C in widths[hasher]:
            for n_leaves in sizes[hasher]:
                cols = rand((C, n_leaves))
                got = stream(cols, hasher)
                err = max(err, max_abs_err(got, plain_all(cols)),
                          max_abs_err(got, one_shot(cols)))
        # C <= 4: a commit's leaves are its LDE values, streamed or not
        for C in (1, 4):
            coeffs = rand((C, 1 << 11))
            batch = DevicePolynomialBatch.from_coeffs(coeffs, 3, 4, hasher)
            lde = dntt.coset_lde(coeffs, 3)
            err = max(err, max_abs_err(
                batch.levels[0],
                dmerkle.leaf_digests(lde, hasher)[
                    :, dntt.bitrev_perm(lde.shape[1], device)]))
        # one (16, 2^23) block on states left by an earlier block, timed;
        # the plain version timed at (16, PLAIN_N) for Poseidon
        block = rand((16, n))
        if hasher == "blake3":
            state = rand((8, n), 1 << 32)
            meta = dmerkle.absorb_block_meta(32)
            args = [m[2:4] for m in meta]

            def kernel():
                return dmerkle.blake3_absorb(block, state.clone(), None, *args)

            def plain():
                return dmerkle.blake3_absorb_plain(block, state, None, *args)

            want = plain()
            plain_shape = [16, n]
            least = bound(8 * 16 * n + 2 * 64 * n, OPS_BLAKE3 * 2 * n,
                          alu=ALU_BLAKE3 * 2 * n)
        else:
            state = pos.absorb(rand((8, n)), None, False)

            def kernel():
                return pos.absorb(block, state.clone(), False)

            plain_block = block[:, :PLAIN_N].contiguous()
            plain_state = state[:, :PLAIN_N].contiguous()

            def plain():
                return pos.absorb_plain(plain_block, plain_state, False)

            want = plain()
            plain_shape = [16, PLAIN_N]
            least = bound(8 * 16 * n + 2 * 96 * n, OPS_POSEIDON * 2 * n,
                          MUL_POSEIDON * 2 * n)
        got = kernel()
        err = max(err, max_abs_err(got[:, :want.shape[1]], want))
        # the clone of the state is timed apart and taken off
        clone_ms = cuda_ms(lambda: state.clone(), 10)
        ms = cuda_ms(kernel, 10) - clone_ms
        plain_ms = cuda_ms(plain, 1)
        del block, state, got, want
        # a streamed leaf hash of the CpuStark LDE's shape equals the
        # one-shot leaf kernel
        lde = rand((94, n))
        err = max(err, max_abs_err(stream(lde, hasher), one_shot(lde)))
        del lde
        record(name, err, ms, plain_ms, least,
               f"LeafStream of C in {widths[hasher]} at n in {sizes[hasher]} vs the "
               f"plain leaf hash and the one-shot kernel; a commit's noop "
               f"leaves at C in (1, 4); (16,2^23) block with "
               f"times (plain at {plain_shape}); streamed (94,2^23) vs one-shot")
        results[name]["plain_shape"] = plain_shape
        torch.cuda.empty_cache()

    # K5 at every edge of its plan (register tile, sub-tile, point groups,
    # chunks) and at every shape the N=94000 prove gives it, bit-exact; timed
    # at the FRI query leaves of the CpuStark trace batch, (94, 2^20) x 28,
    # and at its openings, x 4
    chunk = gf.eval_plan_on(device, 94, 1 << 20, 28).chunk_len
    edges = [(C, n_terms, k)
             for C in sorted({1, gf.EVAL_RC - 1, gf.EVAL_RC, gf.EVAL_RC + 1,
                              134})
             for k in (1, 2, 3, 4, 5, 28, 32, 33, 40)
             for n_terms in (1, 2, 17, gf.EVAL_TERMS - 1, gf.EVAL_TERMS + 1,
                             chunk - 1, chunk + 1)]
    err = 0
    for C, n_terms, k in edges + list(K5_SHAPES):
        coeffs, pows = rand((C, n_terms)), rand((k, n_terms))
        err = max(err, max_abs_err(gf.eval_points(coeffs, pows),
                                   gf.eval_points_plain(coeffs, pows)))
    timed = {}
    for k in (28, 4):
        C, n_terms = 94, 1 << 20
        coeffs, pows = rand((C, n_terms)), rand((k, n_terms))
        err = max(err, max_abs_err(gf.eval_points(coeffs, pows),
                                   gf.eval_points_plain(coeffs, pows)))
        terms = k * C * n_terms
        timed[k] = {
            "ms": cuda_ms(lambda: gf.eval_points(coeffs, pows), 10),
            "plain_ms": cuda_ms(lambda: gf.eval_points_plain(coeffs, pows), 1),
            "least": bound(8 * (C + k) * n_terms + 8 * k * C,
                           k * C * ops_dot(n_terms), MUL_PRODUCT * terms)}
    record("eval_points", err, timed[28]["ms"], timed[28]["plain_ms"],
           timed[28]["least"],
           f"{len(edges)} edge shapes, {len(K5_SHAPES)} main-path shapes; "
           f"(94,2^20)x28 and x4 with times")
    results["eval_points"]["at_4_points"] = {
        "ms": timed[4]["ms"], "plain_ms": timed[4]["plain_ms"],
        **timed[4]["least"]}
    log(f"  eval_points (94,2^20)x4: kernel {timed[4]['ms']:.4f} ms, plain "
        f"{timed[4]['plain_ms']:.4f} ms, bound "
        f"{timed[4]['least']['bound_ms']:.4f} ms by "
        f"{timed[4]['least']['bound_by']}")
    del coeffs, pows
    torch.cuda.synchronize()
    return results


def plain_by_rows(k6, inp, rows: int = 1 << 16):
    """K6's plain version (constraint_tape.evaluate_plain) on windows of
    `rows` rows at a time, each window's next rows gathered for it: the
    same values as on all rows at once, in a fraction of the memory (a
    slice's cone of CpuStark at 2^20 rows would take tens of GB)."""
    import torch

    from olavm_tpu_torch.stark import constraint_tape as ct

    m = inp.rows
    nxt = (torch.arange(m, device=inp.sel.device) + inp.nshift) % m
    parts = []
    for lo in range(0, m, rows):
        hi = min(m, lo + rows)
        zh = inp.zh_inv if inp.zh_inv.numel() == 1 else inp.zh_inv[lo:hi]
        parts.append(ct.evaluate_plain(k6.plan, ct.Inputs(
            inp.lv[:, lo:hi], inp.nv[:, nxt[lo:hi]], inp.zl[:, lo:hi],
            inp.zn[:, nxt[lo:hi]], 0, inp.sel[:, lo:hi], inp.bank, inp.pool,
            zh)))
    return torch.cat(parts, dim=1)


def k6_bound(k6, inp) -> dict:
    """K6's least time for one class: its input columns read once (the
    trace and Z values, the selectors) and the accumulators written, or the
    field operations that the quotient needs (constraint_tape.required_ops:
    each distinct operation of the lowered tape once, no product by a
    pooled 0 or 1, a product and a sum per constraint and alpha) at
    bound()'s rates. Beside it the operations the slices run
    (constraint_tape.plan_ops: the nodes each slice computes, recomputed
    cones included) and the share of those that the quotient does not
    need."""
    from olavm_tpu_torch.stark import constraint_tape as ct

    m = inp.rows
    cols = inp.lv.shape[0] + inp.zl.shape[0] + inp.sel.shape[0]
    ops = ct.required_ops(k6.graph)
    run = ct.plan_ops(k6.plan)
    small = ops["add"] + ops["sub"] + ops["neg"] + ops["ieq"]
    least = bound(8 * m * (cols + k6.tape.num_alphas),
                  m * (ops["mul"] * OPS_MUL + small * OPS_ADD),
                  m * ops["mul"] * MUL_PRODUCT)
    return {**least, "field_ops_per_row": ops, "kernel_field_ops_per_row": run,
            "kernel_ops_not_needed": 1 - sum(ops.values()) / sum(run.values())}


_PTXAS_ENTRY = re.compile(r"Compiling entry function '\w*?slice(\d+)\w*'")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_slices(log: str) -> list:
    """[{"registers", "spill_stores", "spill_loads"}] per K6 slice kernel,
    from what ptxas -v printed when its source was built ([] if it was
    not built in this process)."""
    out, k = {}, None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            k = int(m.group(1))
            out[k] = {"registers": None, "spill_stores": 0, "spill_loads": 0}
            continue
        if k is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            out[k]["spill_stores"] = int(m.group(1))
            out[k]["spill_loads"] = int(m.group(2))
        m = _PTXAS_REGS.search(line)
        if m:
            out[k]["registers"] = int(m.group(1))
            k = None
    return [out[k] for k in sorted(out)]


def check_edge_class(k6, case, cls, pool, seed: int) -> int:
    """K6 on a class whose trace and Z values are EDGE_VALUES (the
    coefficients their inverse coset NTT), against quotient_class_ops and
    the plain version: the largest difference. Sums of p - 1 and EPSILON
    reach 2^64 - 1 in the lazy helpers' PTX."""
    import numpy as np
    import torch

    from olavm_tpu_torch.field import gf
    from olavm_tpu_torch.ntt import ntt as dntt
    from olavm_tpu_torch.stark import constraint_codegen as cg
    from olavm_tpu_torch.stark import prover_device as tpd

    rng = np.random.default_rng(seed)
    shift = int(cls[0]) % (1 << 64)
    values = [gf.from_u64(edge_values(rng, tuple(x.shape)), cls.device)
              for x in (case["coeffs"], case["zs_coeffs"])]
    coeffs, zs = (dntt.coset_ifft(v, shift) for v in values)
    inp = tpd.quotient_inputs(coeffs, zs, cls, case["bank"], pool)
    if not (torch.equal(inp.lv, values[0]) and torch.equal(inp.zl, values[1])):
        raise AssertionError("the edge class's coset values are not the edge "
                             "values")
    got = cg.evaluate(k6, inp)
    want = tpd.quotient_class_ops(case["stark"], coeffs, zs, cls, case["bank"],
                                  **case["static"])
    err = max(max_abs_err(got, want), max_abs_err(got, plain_by_rows(k6, inp)))
    del inp, coeffs, zs, values
    return err


def check_quotient_kernels(device, rng) -> dict:
    """K6 and the quotient's fixed kernels on the card. For one residue
    class of each table of QUOTIENT_SHAPES (N=94000's tables and K=512's
    PoseidonStark and StorageAccessStark): the class through quotient_class
    (gl_scale_powers, K1, gl_quotient_selectors, the K6 slices) against
    quotient_class_ops, the op-by-op quotient of K3, add and sub, exactly,
    and the K6 slices alone against their plain version (plain_by_rows),
    with the times of each and K6's bound; the fixed kernels against their
    plain versions at CpuStark's (94, 2^20), their "ms" the device time
    (device_ms: the selectors take less time than a call needs to issue).
    The kernel line's K6 entry is CpuStark's class at (94, 2^20)."""
    import torch

    from olavm_tpu_torch import kernels
    from olavm_tpu_torch.field import gf
    from olavm_tpu_torch.stark import constraint_codegen as cg
    from olavm_tpu_torch.stark import prover_device as tpd

    results, tables = {}, {}
    for table, degree in QUOTIENT_SHAPES:
        case = quotient_case(table, degree, rng, device)
        stark, coeffs, zs = case["stark"], case["coeffs"], case["zs_coeffs"]
        bits = degree.bit_length() - 1
        name = f"{type(stark).__name__} ({coeffs.shape[0]}, 2^{bits})"
        k6 = tpd.quotient_kernels(stark, coeffs.shape[0], zs.shape[0],
                                  **case["static"])
        pool = gf.from_u64(k6.tape.pool, device)
        qdb = tpd.quotient_degree_bits(stark, case["config"])
        cls = tpd.class_constants(degree.bit_length() - 1, qdb, 1, device)
        args = (stark, coeffs, zs, cls)
        inp = tpd.quotient_inputs(coeffs, zs, cls, case["bank"], pool)
        got = {}
        k6_ms = cuda_ms(lambda: got.__setitem__("k6", cg.evaluate(k6, inp)),
                        3 if degree >= 1 << 19 else 20)
        class_ms = cuda_ms(lambda: got.__setitem__("class", tpd.quotient_class(
            *args, case["bank"], pool, **case["static"])),
            3 if degree >= 1 << 19 else 20)
        ops_ms = cuda_ms(lambda: got.__setitem__("ops", tpd.quotient_class_ops(
            *args, case["bank"], **case["static"])),
            2 if degree >= 1 << 19 else 5)
        timed_plain = table == 0
        plain_ms = (cuda_ms(lambda: got.__setitem__("plain", plain_by_rows(
            k6, inp)), 1) if timed_plain else None)
        if not timed_plain:
            got["plain"] = plain_by_rows(k6, inp)
        err = max(max_abs_err(got["class"], got["ops"]),
                  max_abs_err(got["k6"], got["ops"]),
                  max_abs_err(got["k6"], got["plain"]))
        edge_err = check_edge_class(k6, case, cls, pool, table)
        least = k6_bound(k6, inp)
        ptxas = ptxas_slices(kernels.BUILD_LOG.get(k6.name, ""))
        spilled = [k for k, sl in enumerate(ptxas)
                   if sl["spill_stores"] or sl["spill_loads"]]
        tables[name] = {
            "slices": len(k6.plan.slices), "launches": len(k6.plan.slices) + 1,
            "scratch_columns": k6.plan.scratch, "ptxas": ptxas,
            "warps_per_sm": [b * 4 for b in k6.occupancy()],
            "max_abs_err": err,
            "edge_max_abs_err": edge_err, "k6_ms": k6_ms,
            "class_ms": class_ms, "ops_ms": ops_ms, "plain_ms": plain_ms,
            "bound_ms": least["bound_ms"], "bound_by": least["bound_by"],
            "share": least["bound_ms"] / k6_ms,
            "field_ops_per_row": least["field_ops_per_row"],
            "kernel_field_ops_per_row": least["kernel_field_ops_per_row"],
            "kernel_ops_not_needed": least["kernel_ops_not_needed"]}
        log(f"  K6 {name}: {len(k6.plan.slices)} slices, {k6.plan.scratch} "
            f"scratch columns, max_abs_err={err} (class against "
            f"quotient_class_ops, slices against their plain version), edge "
            f"class {edge_err}, slices {k6_ms:.4f} ms, class {class_ms:.4f} ms, "
            f"op by op {ops_ms:.4f} ms, plain {plain_ms}, bound "
            f"{least['bound_ms']:.4f} ms by {least['bound_by']}, "
            f"{least['kernel_ops_not_needed']:.3f} of the slices' operations "
            f"not needed")
        if err != 0 or edge_err != 0:
            raise AssertionError(f"K6 {name} disagrees")
        if spilled:
            raise AssertionError(f"K6 {name}: ptxas spills in slices "
                                 f"{spilled}: {ptxas}")
        if table == 0 and degree == FULL_CPU_ROWS:
            results["constraints"] = {
                "max_abs_err": err, "ms": k6_ms, "plain_ms": plain_ms,
                **least, "library_ms": None,
                "checked": f"{name} class 1; every table's class in k6_tables"}
            x, base = coeffs, cls[0]
            for kname, fn, plain, least in (
                    ("scale_powers", lambda: cg.scale_powers(x, base),
                     lambda: cg.scale_powers_plain(x, base),
                     bound(16 * x.numel(), OPS_MUL * (x.numel() + degree),
                           MUL_PRODUCT * (x.numel() + degree))),
                    ("quotient_selectors",
                     lambda: cg.selectors(cls, degree.bit_length() - 1),
                     lambda: cg.selectors_plain(cls, degree.bit_length() - 1),
                     bound(24 * degree, OPS_MUL * SELECTOR_PRODUCTS * degree,
                           MUL_PRODUCT * SELECTOR_PRODUCTS * degree))):
                out = {}
                event_ms = cuda_ms(lambda: out.__setitem__("k", fn()), 10)
                ms = device_ms(fn, 10)
                plain_ms = cuda_ms(lambda: out.__setitem__("p", plain()), 1)
                err = max_abs_err(out["k"], out["p"])
                results[kname] = {"max_abs_err": err, "ms": ms,
                                  "event_ms": event_ms,
                                  "plain_ms": plain_ms, **least,
                                  "library_ms": None,
                                  "checked": f"{name} class 1"}
                log(f"  {kname}: max_abs_err={err} kernel {ms:.4f} ms "
                    f"(device; {event_ms:.4f} ms a call by CUDA events), "
                    f"plain {plain_ms:.4f} ms, bound "
                    f"{least['bound_ms']:.4f} ms by {least['bound_by']}")
                if err != 0:
                    raise AssertionError(f"{kname} disagrees with its plain "
                                         f"version")
        del case, coeffs, zs, inp, got, args
        torch.cuda.empty_cache()
    results["k6_tables"] = tables
    return results


# products a point that inversion by batch needs: the running product and
# two on the walk back; the extension's norm (a^2, b^2, 7 b^2) and its two
# parts times the norm's inverse more (and the conjugate's negation, a sum)
INV_PRODUCTS = 3
EXT_INV_PRODUCTS = INV_PRODUCTS + 3 + 2
# products a point of the scan: n - 1 in all, whatever the order
SCAN_PRODUCTS = 1
# K8's tile, csrc/scan.cu's THREADS * ITEMS
SCAN_TILE = 2048
# K8's shapes on the main path: (rows, n) of one launch. At N=94000
# CpuStark's 78 CTL Zs are three groups of 26 (ctl_device.ctl_groups),
# BitwiseStark's permutation batches 8 rows of 2^18, ProgramStark's 4 CTL
# Zs and 2 batches rows of 2^21; the rest are single rows or fewer,
# shorter rows. (78, 2^20) is CpuStark's Zs in one launch.
SCAN_SHAPES = {"CpuStark's Zs, one group": (26, 1 << 20),
               "CpuStark's Zs": (78, 1 << 20),
               "BitwiseStark's batches": (8, 1 << 18),
               "ProgramStark's Zs": (4, 1 << 21),
               "one row of 2^21": (1, 1 << 21),
               "one row of 2^17": (1, 1 << 17)}
SCAN_TIMED = "CpuStark's Zs, one group"
# K7's points a thread, csrc/gf_inv.cu's CHUNK and EXT_CHUNK
INV_CHUNK, EXT_INV_CHUNK = 16, 8


def check_inv_scan_kernels(device, rng) -> dict:
    """K7 (gf_inv, gf_ext_inv) and K8 (prefix_prod) against their plain
    versions, exactly, on edge values (EDGE_VALUES, (0, 0) and every pair of
    them in the extension), all zeros and a zero in every chunk of a thread,
    at the main path's shapes: the permutation Z's inversion at 2^21
    (ProgramStark's trace), the FRI composition's extension inversion at
    2^24 (its largest LDE), the scan at SCAN_SHAPES inclusive and
    exclusive, into a new array and in place, and at lengths 1, 3 and a
    tile + 1; timed by device time (torch.profiler: the scan's time is its
    scratch's fill and its launch), the scan at every SCAN_SHAPES shape in
    place."""
    import numpy as np
    import torch

    from olavm_tpu_torch.field import gf, gfe

    results = {}

    def record(name, err, ms, plain_ms, least, detail):
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         **least, "library_ms": None, "checked": detail}
        log(f"  {name}: max_abs_err={err} kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {least['bound_ms']:.4f} ms by "
            f"{least['bound_by']} ({least['bound_ms'] / ms:.0%}; {detail})")
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version")

    edge = np.array(EDGE_VALUES, dtype=np.uint64)

    def points(n, chunk):
        """{case: uint64 array}: random with the edge values first, all
        zeros, a zero first in every chunk of a thread."""
        x = rng.integers(0, gf.P, n, dtype=np.uint64)
        x[:min(n, len(edge))] = edge[:n]
        every = x.copy()
        every[:-(-n // chunk)] = 0
        return {"random": x, "zeros": np.zeros(n, dtype=np.uint64),
                "zero in every chunk": every}

    # K7, base field: the shapes, then the permutation Z's 2^21
    err = 0
    for n in (1, 17, 1000, 1 << 21):
        for case, x in points(n, INV_CHUNK).items():
            t = gf.from_u64(x, device)
            err = max(err, max_abs_err(gf.inv(t), gf.inv_plain(t)))
            if case == "random":
                timed = t
    t = timed
    ms = device_ms(lambda: gf.inv(t), 20)
    plain_ms = cuda_ms(lambda: gf.inv_plain(t), 2)
    record("gf_inv", err, ms, plain_ms,
           bound(16 * n, INV_PRODUCTS * OPS_MUL * n,
                 INV_PRODUCTS * MUL_PRODUCT * n),
           "n = 1, 17, 1000, 2^21: edge values, all zeros, a zero in every "
           "chunk; times at 2^21")
    del t

    # K7, extension: (0, 0) and every pair of edge values, then the FRI
    # composition's 2^24
    err = 0
    for n in (1, 9, 1000, 1 << 24):
        for case, x in points(n, EXT_INV_CHUNK).items():
            y = rng.integers(0, gf.P, n, dtype=np.uint64)
            if case == "random":
                pairs = min(n, len(edge) ** 2)
                x[:pairs] = np.repeat(edge, len(edge))[:pairs]
                y[:pairs] = np.tile(edge, len(edge))[:pairs]
            y[x == 0] = 0
            a = gfe.GFE(gf.from_u64(x, device), gf.from_u64(y, device))
            got, want = gfe.inv(a), gfe.inv_plain(a)
            err = max(err, max_abs_err(got.re, want.re),
                      max_abs_err(got.im, want.im))
            del got, want
            if case == "random":
                timed = a
    a = timed
    del timed
    ms = device_ms(lambda: gfe.inv(a), 20)
    plain_ms = cuda_ms(lambda: gfe.inv_plain(a), 1)
    record("gf_ext_inv", err, ms, plain_ms,
           bound(32 * n, EXT_INV_PRODUCTS * OPS_MUL * n + 2 * OPS_ADD * n,
                 EXT_INV_PRODUCTS * MUL_PRODUCT * n),
           "n = 1, 9, 1000, 2^24: (0, 0), every pair of edge values, all "
           "zeros, a zero in every chunk; times at 2^24")
    del a
    torch.cuda.empty_cache()

    # K8: lengths around a tile and two rows, then the main path's shapes
    # (SCAN_SHAPES: a table's CTL Zs in one launch, its permutation batches,
    # single rows), each inclusive and exclusive, into a new array and in
    # place
    err = 0
    shapes = [(1, 1), (1, 3), (1, SCAN_TILE + 1), (1, 40 * SCAN_TILE + 7),
              (3, 5 * SCAN_TILE + 1), *SCAN_SHAPES.values()]
    timed = {}
    for rows, n in shapes:
        x = rng.integers(0, gf.P, (rows, n), dtype=np.uint64)
        x.reshape(-1)[:min(x.size, len(edge))] = edge[:x.size]
        if rows > 1:
            x[1, n // 2] = 0  # the rest of that row's products are 0
        t = gf.from_u64(x, device)
        for exclusive in (False, True):
            want = gf.prefix_prod_plain(t, exclusive=exclusive)
            err = max(err, max_abs_err(gf.prefix_prod(t, exclusive=exclusive),
                                       want))
            y = t.clone()
            gf.prefix_prod(y, exclusive=exclusive, out=y)
            err = max(err, max_abs_err(y, want))
            del want, y
        name = next((k for k, v in SCAN_SHAPES.items() if v == (rows, n)),
                    None)
        if name is not None:
            y = t.clone()
            ms = device_ms(lambda: gf.prefix_prod(y, out=y), 20)
            excl_ms = device_ms(lambda: gf.prefix_prod(
                y, exclusive=True, out=y), 20)
            timed[name] = {"ms": ms, "exclusive_ms": excl_ms,
                           "bound_ms": bound(16 * rows * n, 0)["bound_ms"]}
            log(f"  prefix_prod at {name} ({rows}, {n}) in place: {ms:.4f} ms, "
                f"exclusive {excl_ms:.4f} ms, bound "
                f"{timed[name]['bound_ms']:.4f} ms")
            del y
        del t
        torch.cuda.empty_cache()
    rows, n = SCAN_SHAPES[SCAN_TIMED]
    t = gf.from_u64(rng.integers(0, gf.P, (rows, n), dtype=np.uint64), device)
    plain_ms = cuda_ms(lambda: gf.prefix_prod_plain(t), 1)
    record("prefix_prod", err, timed[SCAN_TIMED]["ms"], plain_ms,
           bound(16 * rows * n, SCAN_PRODUCTS * OPS_MUL * rows * n,
                 SCAN_PRODUCTS * MUL_PRODUCT * rows * n),
           f"inclusive and exclusive, out of place and in place, at "
           f"{shapes} (edge values, a zero); times at {SCAN_TIMED} "
           f"({rows}, {n}) in place")
    results["prefix_prod"]["times"] = timed
    del t
    torch.cuda.synchronize()
    return results


# ROADMAP Queue 3, item 1: K6 sums that took terms off a 160-bit sum started
# at a multiple of p were once wrong on the card and right in the g++
# build, avoided by sums that only add, never explained. This source
# builds goldilocks.cuh's lazy helpers and that subtracting form three ways
# (64-bit PTX borrows, 32-bit PTX borrows, 64-bit compares) beside the
# form the kernels use now (an added and a subtracted sum, each reduced,
# then gl::sub_ll), once with nvcc for the card and once with g++ (the
# helpers' host twins), and check_lazy_sums holds the card's words to the
# host's, bit for bit, and each result to Python's integers mod p.
LAZY_TERMS = 8
LAZY_HELPERS = 8
LAZY_FORMS = 4
LAZY_SOURCE = r"""
#ifndef __CUDACC__
#define __device__
#define __forceinline__ inline
#endif
#include <cstdint>

#include "goldilocks.cuh"

namespace lazy {

constexpr int TERMS = %(terms)d, HELPERS = %(helpers)d, FORMS = %(forms)d;
constexpr int SUM_WORDS = 3 + 3 * TERMS;

// acc -= x, the borrow out of 128 bits taken from acc.top: 64-bit borrows
__device__ __forceinline__ void sub_u64(gl::u160& acc, gl::u128 x) {
#ifdef __CUDA_ARCH__
  asm("sub.cc.u64  %%0, %%0, %%3;\n\t"
      "subc.cc.u64 %%1, %%1, %%4;\n\t"
      "subc.u32    %%2, %%2, 0;"
      : "+l"(acc.lo), "+l"(acc.hi), "+r"(acc.top)
      : "l"(x.lo), "l"(x.hi));
#else
  const unsigned __int128 a =
      (static_cast<unsigned __int128>(acc.hi) << 64) | acc.lo;
  const unsigned __int128 b =
      (static_cast<unsigned __int128>(x.hi) << 64) | x.lo;
  acc.top -= a < b;
  acc.lo = static_cast<uint64_t>(a - b);
  acc.hi = static_cast<uint64_t>((a - b) >> 64);
#endif
}

// the same on 32-bit limbs
__device__ __forceinline__ void sub_u32(gl::u160& acc, gl::u128 x) {
#ifdef __CUDA_ARCH__
  uint32_t a0 = static_cast<uint32_t>(acc.lo), a1 = acc.lo >> 32;
  uint32_t a2 = static_cast<uint32_t>(acc.hi), a3 = acc.hi >> 32;
  asm("sub.cc.u32  %%0, %%0, %%5;\n\t"
      "subc.cc.u32 %%1, %%1, %%6;\n\t"
      "subc.cc.u32 %%2, %%2, %%7;\n\t"
      "subc.cc.u32 %%3, %%3, %%8;\n\t"
      "subc.u32    %%4, %%4, 0;"
      : "+r"(a0), "+r"(a1), "+r"(a2), "+r"(a3), "+r"(acc.top)
      : "r"(static_cast<uint32_t>(x.lo)),
        "r"(static_cast<uint32_t>(x.lo >> 32)),
        "r"(static_cast<uint32_t>(x.hi)),
        "r"(static_cast<uint32_t>(x.hi >> 32)));
  acc.lo = (static_cast<uint64_t>(a1) << 32) | a0;
  acc.hi = (static_cast<uint64_t>(a3) << 32) | a2;
#else
  sub_u64(acc, x);
#endif
}

// the same with 64-bit compares for the borrows (no carry flag)
__device__ __forceinline__ void sub_cmp(gl::u160& acc, gl::u128 x) {
  const uint64_t b0 = acc.lo < x.lo;
  const uint32_t b1 = acc.hi < x.hi || (acc.hi == x.hi && b0);
  acc.lo -= x.lo;
  acc.hi = acc.hi - x.hi - b0;
  acc.top -= b1;
}

// the helpers on one pair of words
__device__ __forceinline__ void helpers(uint64_t a, uint64_t b, uint64_t* o) {
  o[0] = gl::sub_small(a, static_cast<uint32_t>(b));
  o[1] = gl::sub_ll(a, b);
  o[2] = gl::add_ll(a, b);
  o[3] = gl::add_eps(a, static_cast<uint32_t>(b));
  o[4] = gl::reduce128_lazy(a, b);
  o[5] = gl::reduce160_lazy({a, b, static_cast<uint32_t>(a ^ (b >> 32))});
  o[6] = gl::mul_lazy(a, b);
  o[7] = gl::add_lazy(a, gl::canonical(b));
}

// one sum: in = [start lo, hi, top, TERMS x (a, b, taken off)]
__device__ __forceinline__ void sums(const uint64_t* in, uint64_t* o) {
  gl::u160 s0 = {in[0], in[1], static_cast<uint32_t>(in[2])};
  gl::u160 s1 = s0, s2 = s0, plus = {0, 0, 0}, minus = {0, 0, 0};
  for (int t = 0; t < TERMS; ++t) {
    const gl::u128 w = gl::mul_wide(in[3 + 3 * t], in[4 + 3 * t]);
    if (in[5 + 3 * t]) {
      sub_u64(s0, w);
      sub_u32(s1, w);
      sub_cmp(s2, w);
      gl::acc_add(minus, w);
    } else {
      gl::acc_add(s0, w);
      gl::acc_add(s1, w);
      gl::acc_add(s2, w);
      gl::acc_add(plus, w);
    }
  }
  o[0] = gl::reduce160_lazy(s0);
  o[1] = gl::reduce160_lazy(s1);
  o[2] = gl::reduce160_lazy(s2);
  o[3] = gl::sub_ll(gl::reduce160_lazy(plus), gl::reduce160_lazy(minus));
}

__device__ __forceinline__ void run(int64_t i, const uint64_t* pairs,
                                    int64_t npairs, const uint64_t* sum_in,
                                    int64_t nsums, uint64_t* out) {
  if (i < npairs) {
    helpers(pairs[2 * i], pairs[2 * i + 1], out + HELPERS * i);
  } else if (i < npairs + nsums) {
    const int64_t k = i - npairs;
    sums(sum_in + SUM_WORDS * k, out + HELPERS * npairs + FORMS * k);
  }
}

}  // namespace lazy

#ifdef __CUDACC__
__global__ void lazy_kernel(const uint64_t* pairs, int64_t npairs,
                            const uint64_t* sum_in, int64_t nsums,
                            uint64_t* out) {
  lazy::run(static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x,
            pairs, npairs, sum_in, nsums, out);
}

extern "C" int lazy_run(const void* pairs, int64_t npairs, const void* sum_in,
                        int64_t nsums, void* out, void* stream) {
  const int64_t n = npairs + nsums;
  lazy_kernel<<<static_cast<unsigned>((n + 127) / 128), 128, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(pairs), npairs,
      static_cast<const uint64_t*>(sum_in), nsums,
      static_cast<uint64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
#else
extern "C" int lazy_run(const void* pairs, int64_t npairs, const void* sum_in,
                        int64_t nsums, void* out, void*) {
  for (int64_t i = 0; i < npairs + nsums; ++i)
    lazy::run(i, static_cast<const uint64_t*>(pairs), npairs,
              static_cast<const uint64_t*>(sum_in), nsums,
              static_cast<uint64_t*>(out));
  return 0;
}
#endif
""" % {"terms": LAZY_TERMS, "helpers": LAZY_HELPERS, "forms": LAZY_FORMS}
# words at the lazy helpers' edges beside EDGE_VALUES: the lazy words a
# helper may return (2^64 - 1, 2^64 - 2^32 and around them)
LAZY_EXTRA_WORDS = ((1 << 64) - 1, (1 << 64) - 2, (1 << 64) - (1 << 32),
                    0xFFFFFFFF00000002, (1 << 63) - 1, (1 << 32) - 2)


def lazy_inputs(rng, random_sums: int = 4096):
    """Every pair of EDGE_VALUES and LAZY_EXTRA_WORDS for the helpers; sums
    started at multiples of p (p 2^e for e = 64 .. 95, random multiples
    below 2^160, 0 and p, whose sums may leave [0, 2^160)) with LAZY_TERMS
    terms of those words or random words, each added or taken off.
    Returns (pairs, sums), uint64 arrays of (n, 2) and (m, 3 + 3 terms)."""
    import numpy as np

    words = np.array(EDGE_VALUES + LAZY_EXTRA_WORDS, dtype=np.uint64)
    pairs = np.stack([np.repeat(words, len(words)),
                      np.tile(words, len(words))], axis=1)
    starts = [_P << e for e in range(64, 96)] + [0, _P]
    while len(starts) < random_sums:
        k = int(rng.integers(1, 1 << 62, dtype=np.uint64)) << int(
            rng.integers(0, 34))
        starts.append(k * _P)
    rows = []
    for start in starts:
        row = [start & ((1 << 64) - 1), (start >> 64) & ((1 << 64) - 1),
               start >> 128]
        for _ in range(LAZY_TERMS):
            if rng.integers(2):
                a, b = (int(v) for v in words[rng.integers(0, len(words), 2)])
            else:
                a, b = (int(v) for v in rng.integers(0, 1 << 64, 2,
                                                     dtype=np.uint64))
            row += [a, b, int(rng.integers(2))]
        rows.append(row)
    return pairs, np.array(rows, dtype=np.uint64)


def lazy_expected(pairs, sums):
    """What each output must be congruent to mod p (None where the
    subtracting sum leaves [0, 2^160), which no form promises)."""
    out = []
    for a, b in ((int(x), int(y)) for x, y in pairs):
        top = (a ^ (b >> 32)) & 0xFFFFFFFF
        out += [a - (b & 0xFFFFFFFF), a - b, a + b,
                a + (b & 0xFFFFFFFF) * _EPSILON, a + (b << 64),
                a + (b << 64) + (top << 128), a * b, a + b % _P]
    for row in sums:
        row = [int(v) for v in row]
        total = row[0] + (row[1] << 64) + (row[2] << 128)
        for t in range(LAZY_TERMS):
            a, b, off = row[3 + 3 * t:6 + 3 * t]
            total += -a * b if off else a * b
        whole = total if 0 <= total < 1 << 160 else None
        out += [whole, whole, whole, total]
    return [None if v is None else v % _P for v in out]


def lazy_host(pairs, sums, workdir: str):
    """LAZY_SOURCE built by g++ (goldilocks.cuh's host twins) and run on
    these inputs: the outputs' words."""
    import ctypes
    import shutil

    import numpy as np

    from olavm_tpu_torch import kernels

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("the lazy-sum check needs g++ beside nvcc")
    src = os.path.join(workdir, "lazy_host.cpp")
    so = os.path.join(workdir, "liblazyhost.so")
    with open(src, "w") as f:
        f.write(LAZY_SOURCE)
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I",
                    str(kernels.CSRC), src, "-o", so], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    out = np.zeros(LAZY_HELPERS * len(pairs) + LAZY_FORMS * len(sums),
                   dtype=np.uint64)
    pairs, sums = np.ascontiguousarray(pairs), np.ascontiguousarray(sums)
    lib.lazy_run(ctypes.c_void_p(pairs.ctypes.data), ctypes.c_int64(len(pairs)),
                 ctypes.c_void_p(sums.ctypes.data), ctypes.c_int64(len(sums)),
                 ctypes.c_void_p(out.ctypes.data), None)
    return out


def lazy_card(pairs, sums, device):
    """LAZY_SOURCE built by nvcc (kernels.generated, the kernels' flags) and
    run on the card on these inputs: the outputs' words."""
    import ctypes

    import torch

    from olavm_tpu_torch import kernels
    from olavm_tpu_torch.field import gf

    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib = kernels.generated(kernels.generated_name("lazy", LAZY_SOURCE),
                            LAZY_SOURCE,
                            {"lazy_run": [vp, i64, vp, i64, vp, vp]})
    p, s = gf.from_u64(pairs, device), gf.from_u64(sums, device)
    out = torch.zeros(LAZY_HELPERS * len(pairs) + LAZY_FORMS * len(sums),
                      dtype=torch.int64, device=device)
    kernels.check(lib.lazy_run(p.data_ptr(), len(pairs), s.data_ptr(),
                               len(sums), out.data_ptr(),
                               kernels.stream_ptr(out)), "lazy_run")
    return gf.to_u64(out)


LAZY_NAMES = ("sub_small", "sub_ll", "add_ll", "add_eps", "reduce128_lazy",
              "reduce160_lazy", "mul_lazy", "add_lazy")
LAZY_FORM_NAMES = ("subtracting, 64-bit PTX borrows",
                   "subtracting, 32-bit PTX borrows",
                   "subtracting, 64-bit compares",
                   "added and subtracted sums, then sub_ll")


def lazy_mismatches(got, pairs, sums, want_words=None) -> dict:
    """{output name: cases} where `got` is not congruent to Python's value
    mod p, or (with `want_words`) differs from those words."""
    want = lazy_expected(pairs, sums)
    names = [LAZY_NAMES[k % LAZY_HELPERS] for k in range(
        LAZY_HELPERS * len(pairs))] + [LAZY_FORM_NAMES[k % LAZY_FORMS]
                                       for k in range(LAZY_FORMS * len(sums))]
    bad: dict = {}
    for k, (g_, w) in enumerate(zip(got, want)):
        if (w is not None and int(g_) % _P != w) or (
                want_words is not None and g_ != want_words[k]):
            bad[names[k]] = bad.get(names[k], 0) + 1
    return bad


def check_lazy_sums(device, rng) -> dict:
    """ROADMAP Queue 3, item 1, on the card: LAZY_SOURCE by nvcc against its
    g++ build, word for word, and both against Python's integers mod p, on
    every pair of edge words and on sums started at multiples of p. Raises
    with the outputs that disagree."""
    pairs, sums = lazy_inputs(rng)
    with tempfile.TemporaryDirectory() as workdir:
        host = lazy_host(pairs, sums, workdir)
    card = lazy_card(pairs, sums, device)
    result = {"pairs": len(pairs), "sums": len(sums),
              "host_vs_python": lazy_mismatches(host, pairs, sums),
              "card_vs_host": lazy_mismatches(card, pairs, sums, host)}
    log(f"  lazy helpers and 160-bit sums (Queue 3, item 1): {len(pairs)} "
        f"pairs, {len(sums)} sums; card against g++ and Python: "
        f"{result['card_vs_host'] or 'equal'}; g++ against Python: "
        f"{result['host_vs_python'] or 'equal'}")
    if result["host_vs_python"] or result["card_vs_host"]:
        raise AssertionError(f"lazy helpers or sums disagree: {result}")
    return result


# K9 and K10 (csrc/fri.cu), the FRI composition, at the main path's shapes:
# (trace, Z, quotient) widths, the permutation Zs among the Zs (the CTL Zs
# follow them) and log2 of the rows, of CpuStark at N=94000 and of
# PoseidonStark at K=512
FRI_SHAPES = {"N=94000 CpuStark": ((94, 78, 12), 0, 20),
              "K=512 PoseidonStark": ((134, 6, 12), 0, 20),
              "N=376000 CpuStark": ((94, 78, 12), 0, 22)}
FRI_RATE_BITS = 3


def fri_case(widths, num_perm: int, n: int, rng, device, edge: bool = False):
    """A FRI composition of fri_instance_for_stark's shape (batch 0 at zeta
    over the trace, Z and quotient oracles, batch 1 at g zeta over the
    trace and the Zs, batch 2 at g^-1 over the CTL Zs, rows num_perm on)
    with n coefficients an oracle: random alpha, points and openings
    (numpy, from `rng`), planned by prover_device.composition_bank; with
    `edge` the coefficients and the whole bank are EDGE_VALUES, and batch
    1's point is a point of the LDE coset (a zero norm). Returns (the
    oracles' coefficient tensors, the bank, the plan)."""
    import numpy as np
    import torch

    from olavm_tpu_torch.field import gf
    from olavm_tpu_torch.field import goldilocks as g
    from olavm_tpu_torch.stark.fri import FriBatchInfo, FriInstance
    from olavm_tpu_torch.stark.prover_device import composition_bank

    def ext():
        return tuple(int(v) for v in rng.integers(0, gf.P, 2, dtype=np.uint64))

    trace, zs, quot = widths
    rows = ([(0, i) for i in range(trace)] + [(1, i) for i in range(zs)],
            [(2, i) for i in range(quot)])
    log_n = n.bit_length() - 1
    points = [ext(), ext(), (g.inv(g.primitive_root_of_unity(log_n)), 0)]
    polys = [rows[0] + rows[1], rows[0], [(1, i) for i in range(num_perm, zs)]]
    instance = FriInstance([FriBatchInfo(np.asarray(p, dtype=np.uint64), q)
                            for p, q in zip(points, polys)])
    plan, bank = composition_bank(instance, ext(), [ext() for _ in polys])
    if edge:
        size = n << FRI_RATE_BITS
        x = g.MULTIPLICATIVE_GROUP_GENERATOR * pow(
            g.primitive_root_of_unity(log_n + FRI_RATE_BITS),
            int(rng.integers(size)), g.P) % g.P
        bank = edge_values(rng, len(bank))
        bank[plan[1][1]:plan[1][1] + 2] = (x, 0)
        coeffs = [gf.from_u64(edge_values(rng, (w, n)), device)
                  for w in widths]
    else:
        gen = torch.Generator(device=device).manual_seed(
            int(rng.integers(1 << 31)))
        coeffs = [torch.randint(0, 1 << 62, (w, n), generator=gen,
                                device=device) for w in widths]
    return coeffs, gf.from_u64(np.asarray(bank, dtype=np.uint64), device), plan


def fri_combine_bound(plan, n: int, rate_bits: int) -> dict:
    """K9's least time: each row that a batch reads once (8 bytes a
    column), the (B, 2, size) output written; two products a row and
    column for each distinct run of alpha powers that reads it (batches
    whose plan shares a run's bank words share its products), added into
    each batch's 160-bit sums (batch 0's rows that nest batch 1's once,
    into batch 1's: fri_kernels.nested), each sum reduced once and times
    shift^j, and shift's next power a column."""
    from olavm_tpu_torch.stark import fri_kernels as fk

    rows = {(oi, p0 + r) for runs, _ in plan for oi, p0, k, _ in runs
            for r in range(k)}
    products = 2 * n * len({(oi, p0 + r, roff + r) for runs, _ in plan
                            for oi, p0, k, roff in runs for r in range(k)})
    terms = 2 * n * sum(k for runs, _ in plan for _, _, k, _ in runs)
    if len(plan) > 1 and fk.nested(fk.segments(plan)):
        terms -= 2 * n * sum(k for _, _, k, _ in plan[1][0])
    sums = 2 * len(plan) * n
    return bound(8 * n * len(rows) + 16 * len(plan) * (n << rate_bits),
                 products * OPS_PRODUCT + terms * OPS_ACCUMULATE
                 + sums * (OPS_REDUCE_WIDE + OPS_MUL) + n * OPS_MUL,
                 (products + sums + n) * MUL_PRODUCT)


# K10's work a point of batch b (csrc/fri.cu): the norm's square, its
# inversion by batch (3 products), the quotient times 1/N (2); the
# numerator times the conjugate as two sums of two unreduced products;
# x - z_re, the norm's difference and the numerator's two; from the second
# batch on, F alpha^len + q as two more sums of two products and q. A point
# adds the step of x and the bump F x (3 products)
FRI_Q_PRODUCTS, FRI_Q_TERMS, FRI_Q_SUMS, FRI_Q_ADDS = 6, 4, 2, 4
FRI_Q_LATER_TERMS, FRI_Q_LATER_SUMS = 4, 2
FRI_Q_POINT_PRODUCTS = 3


def fri_quotient_bound(batches: int, size: int) -> dict:
    """K10's least time: the (B, 2, size) values read and (2, size)
    written, against the work a point above."""
    later = batches - 1
    products = batches * FRI_Q_PRODUCTS + FRI_Q_POINT_PRODUCTS
    terms = batches * FRI_Q_TERMS + later * FRI_Q_LATER_TERMS
    sums = batches * FRI_Q_SUMS + later * FRI_Q_LATER_SUMS
    ops = (products * OPS_MUL + terms * (OPS_PRODUCT + OPS_ACCUMULATE)
           + later * 2 * OPS_ACCUMULATE + sums * OPS_REDUCE_WIDE
           + batches * FRI_Q_ADDS * OPS_ADD)
    return bound(16 * (batches + 1) * size, ops * size,
                 (products + terms) * MUL_PRODUCT * size)


def check_fri_kernels(device, rng) -> dict:
    """K9 (fri_combine) and K10 (fri_quotient) against their plain versions,
    exactly, at the composition's shapes of CpuStark at N=94000 and
    N=376000 and of PoseidonStark at K=512 (FRI_SHAPES: n = 2^20 or 2^22,
    an LDE of 8 n, the three batches as the prove plans them) and on
    EDGE_VALUES with a zero norm at n = 2^10; the whole composition
    (fri_composition: K9, K1, K10, K1 inverse, the coset scaling) against
    fri_composition_ops, the op-by-op chain it replaced, at those shapes.
    Timed by CUDA events at CpuStark's N=94000 shape, K9 at each shape."""
    import torch

    from olavm_tpu_torch.ntt import ntt as dntt
    from olavm_tpu_torch.stark import fri_kernels as fk
    from olavm_tpu_torch.stark import prover_device as tpd

    results, errs, timed = {}, {"fri_combine": 0, "fri_quotient": 0}, {}
    k9_times = {}
    cases = [(name, (*shape[:2], 1 << shape[2]), False)
             for name, shape in FRI_SHAPES.items()]
    cases.append(("edge values, a zero norm", ((5, 17, 3), 1, 1 << 10), True))
    for name, (widths, num_perm, n), edge in cases:
        coeffs, bank, plan = fri_case(widths, num_perm, n, rng, device, edge)
        combined = fk.fri_combine(coeffs, bank, plan, FRI_RATE_BITS)
        errs["fri_combine"] = max(errs["fri_combine"], max_abs_err(
            combined, fk.fri_combine_plain(coeffs, bank, plan, FRI_RATE_BITS)))
        lde = dntt.ntt(combined)
        del combined
        errs["fri_quotient"] = max(errs["fri_quotient"], max_abs_err(
            fk.fri_quotient(lde, bank, plan),
            fk.fri_quotient_plain(lde, bank, plan)))
        if not edge:
            got = tpd.fri_composition(*coeffs, bank, plan=plan,
                                      rate_bits=FRI_RATE_BITS)
            want = tpd.fri_composition_ops(*coeffs, bank, plan=plan,
                                           rate_bits=FRI_RATE_BITS)
            err = max(max_abs_err(a, b) for a, b in zip(got, want))
            log(f"  fri_composition {name}: against fri_composition_ops "
                f"max_abs_err={err}")
            if err:
                raise AssertionError(f"fri_composition at {name} disagrees "
                                     f"with fri_composition_ops")
            del got, want
        if not edge:
            # K9 alone at each shape, by CUDA events
            k9_times[name] = {
                "ms": cuda_ms(lambda: fk.fri_combine(
                    coeffs, bank, plan, FRI_RATE_BITS), 10),
                "bound_ms": fri_combine_bound(plan, n,
                                              FRI_RATE_BITS)["bound_ms"]}
            log(f"  fri_combine at {name}: {k9_times[name]['ms']:.4f} ms, "
                f"bound {k9_times[name]['bound_ms']:.4f} ms")
        if not timed:
            timed = {"coeffs": coeffs, "bank": bank, "plan": plan, "lde": lde,
                     "n": n, "name": name}
        else:
            del coeffs, lde
        torch.cuda.empty_cache()

    coeffs, bank, plan, lde = (timed[k] for k in ("coeffs", "bank", "plan",
                                                  "lde"))
    n, size = timed["n"], timed["lde"].shape[-1]
    checked = (f"{', '.join(c[0] for c in cases)}; the composition against "
               f"fri_composition_ops at {', '.join(FRI_SHAPES)}; times at "
               f"{timed['name']} (n = 2^{n.bit_length() - 1}, "
               f"{len(plan)} batches)")
    # CUDA events: a call takes far longer than the host needs to issue it
    # (the profiler's sums, late in this process, once came out at 0.6 of
    # the events' times for these two kernels)
    comp_ms = cuda_ms(lambda: tpd.fri_composition(
        *coeffs, bank, plan=plan, rate_bits=FRI_RATE_BITS), 5)
    ops_ms = cuda_ms(lambda: tpd.fri_composition_ops(
        *coeffs, bank, plan=plan, rate_bits=FRI_RATE_BITS), 2)
    for name, call, plain, least in (
            ("fri_combine",
             lambda: fk.fri_combine(coeffs, bank, plan, FRI_RATE_BITS),
             lambda: fk.fri_combine_plain(coeffs, bank, plan, FRI_RATE_BITS),
             fri_combine_bound(plan, n, FRI_RATE_BITS)),
            ("fri_quotient", lambda: fk.fri_quotient(lde, bank, plan),
             lambda: fk.fri_quotient_plain(lde, bank, plan),
             fri_quotient_bound(len(plan), size))):
        ms = cuda_ms(call, 10)
        plain_ms = cuda_ms(plain, 1)
        results[name] = {"max_abs_err": errs[name], "ms": ms,
                         "plain_ms": plain_ms, **least, "library_ms": None,
                         "checked": checked, "composition_ms": comp_ms,
                         "composition_ops_ms": ops_ms}
        log(f"  {name}: max_abs_err={errs[name]} kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {least['bound_ms']:.4f} ms by "
            f"{least['bound_by']} ({least['bound_ms'] / ms:.0%}; {checked})")
        if errs[name] != 0:
            raise AssertionError(f"{name} disagrees with its plain version")
    results["fri_combine"]["times"] = k9_times
    log(f"  the composition at {timed['name']}: {comp_ms:.4f} ms (the "
        f"op-by-op chain {ops_ms:.4f})")
    del timed, coeffs, lde
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return results


# K11 (csrc/ctl.cu), a CTL Z's row combination, at the main path's shapes:
# (OlaStark table, log2 of its rows) whose widest view is timed and
# checked, of N=94000 (CpuStark, 2^20 rows, and ProgramStark, 2^21) and of
# K=512 (PoseidonStark, 2^20 rows, whose views are the widest: 24 columns
# over 25 trace columns)
CTL_SHAPES = {"N=94000 CpuStark": (0, 20), "N=94000 ProgramStark": (10, 21),
              "K=512 PoseidonStark": (5, 20)}


def ctl_views() -> list:
    """Every view of every cross-table lookup, in the prover's order."""
    from olavm_tpu_torch.tables.ola_stark import all_cross_table_lookups

    return [t for ctl in all_cross_table_lookups()
            for t in list(ctl.looking_tables) + [ctl.looked_table]]


def widest_view(table: int):
    """The view of `table` that reads the most distinct trace columns."""
    from olavm_tpu_torch.stark import ctl_kernels as ck

    return max((t for t in ctl_views() if t.table == table),
               key=lambda t: ck.view_params(t.columns, t.filter_column).slots)


def ctl_case(view, n: int, rng, device, edge: bool = False):
    """A trace of the view's table width and n rows, random canonical values
    made on the card (or EDGE_VALUES from numpy with `edge`), the columns
    its filter reads drawn from 0, 1, 2 and p - 1 (mostly 0), and a
    [beta, gamma] bank. Returns (trace, bank, rows whose filter is 1)."""
    import numpy as np
    import torch

    from olavm_tpu_torch.field import gf
    from olavm_tpu_torch.tables.ola_stark import OlaStark

    width = OlaStark().starks[view.table].COLUMNS
    if edge:
        trace = gf.from_u64(edge_values(rng, (width, n)), device)
        bank = gf.from_u64(edge_values(rng, 2), device)
    else:
        gen = torch.Generator(device=device).manual_seed(
            int(rng.integers(1 << 31)))
        trace = torch.randint(0, 1 << 62, (width, n), generator=gen,
                              device=device)
        bank = gf.from_u64(rng.integers(0, gf.P, 2, dtype=np.uint64), device)
    # a filter 1 - x then gives 1, 0, p - 1 and 2
    values = gf.from_u64(np.array([0, 0, 0, 1, 1, 2, _P - 1],
                                  dtype=np.uint64), device)
    filt = view.filter_column
    if filt is None:
        return trace, bank, n
    for c, _ in filt.linear_combination:
        trace[c] = values[torch.from_numpy(
            rng.integers(0, len(values), n)).to(device)]
    f = gf.full((n,), filt.constant % _P, device)
    for c, k in filt.linear_combination:
        f = gf.add_plain(f, gf.mul_plain(trace[c], gf.scalar(k, device)))
    return trace, bank, int((f == 1).sum())


def ctl_combine_bound(view, n: int, on: int) -> dict:
    """K11's least time: each distinct trace column the view reads read
    once and the output written, 8 bytes a row each; a product and its sum
    a value slot on the `on` rows whose filter is 1 and a filter slot on
    every row, each sum reduced once, and beta's powers and the
    coefficients (a product a term) once."""
    from olavm_tpu_torch.stark import ctl_kernels as ck

    v = ck.view_params(view.columns, view.filter_column)
    value = sum(1 for s in range(v.slots) if v.use[s] & ck.USE_VALUE)
    filt = sum(1 for s in range(v.slots) if v.use[s] & ck.USE_FILTER)
    terms = value * on + filt * n
    sums = on + (n if v.filtered else 0)
    setup = v.columns + v.terms
    return bound(8 * (v.slots + 1) * n,
                 terms * (OPS_PRODUCT + OPS_ACCUMULATE)
                 + sums * OPS_REDUCE_WIDE + setup * OPS_MUL,
                 (terms + setup) * MUL_PRODUCT)


# K12 (csrc/fri.cu), the FRI fold, at the main path's shapes: (log2 of the
# coefficients, arity); N=94000's largest fold is 2^24 -> 2^20 (ProgramStark's
# 2^21 rows at rate 3)
FOLD_SHAPES = {"2^24 -> 2^20": (24, 16), "2^20 -> 2^16": (20, 16)}


def fold_case(log_m: int, arity: int, rng, device, edge: bool = False):
    """Coefficients (re, im) of 2^log_m values made on the card (or
    EDGE_VALUES from numpy) and the (2, arity) powers of a beta from
    `rng`, as fri_fold makes them. Returns (re, im, bpows)."""
    import numpy as np
    import torch

    from olavm_tpu_torch.field import gf

    m = 1 << log_m
    if edge:
        re, im = (gf.from_u64(edge_values(rng, m), device) for _ in range(2))
        beta = [int(v) for v in edge_values(rng, 2)]
    else:
        gen = torch.Generator(device=device).manual_seed(
            int(rng.integers(1 << 31)))
        re, im = (torch.randint(0, 1 << 62, (m,), generator=gen,
                                device=device) for _ in range(2))
        beta = [int(v) for v in rng.integers(0, gf.P, 2, dtype=np.uint64)]
    pws = [(1, 0)]
    for _ in range(1, arity):
        a, b = pws[-1]
        pws.append(((a * beta[0] + 7 * b * beta[1]) % _P,
                    (a * beta[1] + b * beta[0]) % _P))
    return re, im, gf.from_u64(np.asarray(pws, dtype=np.uint64).T.copy(),
                               device)


def fri_fold_bound(m: int, arity: int) -> dict:
    """K12's least time: the (m,) re and im coefficients read and the (2,
    m / arity) output written; 4 (arity - 1) products an output into three
    160-bit sums, the im x im sum reduced and times 7 once, two
    reductions."""
    out = m // arity
    terms = (4 * (arity - 1) + 1) * out
    return bound(16 * m + 16 * out,
                 terms * (OPS_PRODUCT + OPS_ACCUMULATE)
                 + 3 * out * OPS_REDUCE_WIDE, terms * MUL_PRODUCT)


def check_ctl_fold_kernels(device, rng) -> dict:
    """K11 (ctl_combine) against its plain version, exactly, on the widest
    view of each CTL_SHAPES table at its rows, on every view at 2^10 rows of
    EDGE_VALUES (filters of 0, 1, 2 and p - 1) and on a view without
    columns; K12 (fri_fold) against its plain version at FOLD_SHAPES and at
    every arity on EDGE_VALUES, and on a slice that starts past the
    vector's start (a mesh rank's rows). Each timed by CUDA events at its
    largest shape, beside the op-by-op chain it replaced."""
    import torch

    from olavm_tpu_torch.stark import ctl_kernels as ck
    from olavm_tpu_torch.stark import fri_kernels as fk

    results = {}

    def record(name, err, ms, plain_ms, ops_ms, least, detail):
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "chain_ms": ops_ms, **least, "library_ms": None,
                         "checked": detail}
        log(f"  {name}: max_abs_err={err} kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, the op-by-op chain {ops_ms:.4f} ms, bound "
            f"{least['bound_ms']:.4f} ms by {least['bound_by']} "
            f"({least['bound_ms'] / ms:.0%}; {detail})")
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version")

    # K11
    err, timed = 0, None
    for name, (table, log_n) in CTL_SHAPES.items():
        view = widest_view(table)
        trace, bank, on = ctl_case(view, 1 << log_n, rng, device)
        args = (trace, view.columns, view.filter_column, bank)
        err = max(err, max_abs_err(ck.ctl_combine(*args),
                                   ck.ctl_combine_plain(*args)))
        least = ctl_combine_bound(view, 1 << log_n, on)
        if timed is None or least["bytes"] > timed[2]["bytes"]:
            timed = (name, args, least)
    views = ctl_views()
    for view in views:
        trace, bank, _ = ctl_case(view, 1 << 10, rng, device, edge=True)
        args = (trace, view.columns, view.filter_column, bank)
        err = max(err, max_abs_err(ck.ctl_combine(*args),
                                   ck.ctl_combine_plain(*args)))
    err = max(err, max_abs_err(ck.ctl_combine(trace, [], None, bank),
                               ck.ctl_combine_plain(trace, [], None, bank)))
    name, args, least = timed
    ms = cuda_ms(lambda: ck.ctl_combine(*args), 20)
    plain_ms = cuda_ms(lambda: ck.ctl_combine_plain(*args), 2)
    ops_ms = cuda_ms(lambda: ck.ctl_combine_ops(*args), 2)
    record("ctl_combine", err, ms, plain_ms, ops_ms, least,
           f"the widest view of {', '.join(CTL_SHAPES)} at their rows, all "
           f"{len(views)} views at 2^10 rows of edge values, a view "
           f"without columns; times at {name}")
    del timed, args, trace
    torch.cuda.empty_cache()

    # K12
    err, timed = 0, None
    for name, (log_m, arity) in FOLD_SHAPES.items():
        re, im, bpows = fold_case(log_m, arity, rng, device)
        err = max(err, max_abs_err(fk.fri_fold(re, im, bpows),
                                   fk.fri_fold_plain(re, im, bpows)))
        if timed is None:
            timed = (name, (re, im, bpows), fri_fold_bound(1 << log_m, arity))
    for arity in fk.FOLD_ARITIES:
        re, im, bpows = fold_case(12, arity, rng, device, edge=True)
        err = max(err, max_abs_err(fk.fri_fold(re, im, bpows),
                                   fk.fri_fold_plain(re, im, bpows)))
        lo, hi = 3 * arity, (1 << 12) - 5 * arity  # a mesh rank's rows
        err = max(err, max_abs_err(fk.fri_fold(re[lo:hi], im[lo:hi], bpows),
                                   fk.fri_fold_plain(re[lo:hi], im[lo:hi],
                                                     bpows)))
    name, args, least = timed
    ms = cuda_ms(lambda: fk.fri_fold(*args), 20)
    plain_ms = cuda_ms(lambda: fk.fri_fold_plain(*args), 2)
    ops_ms = cuda_ms(lambda: fk.fri_fold_ops(*args), 2)
    record("fri_fold", err, ms, plain_ms, ops_ms, least,
           f"{', '.join(FOLD_SHAPES)}, every arity at 2^12 edge values and "
           f"on a slice; times at {name}")
    del timed, args
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return results


# K13 (csrc/powers.cu), power tables: the degrees of an N=94000 prove's
# tables (the openings' extension tables, and the query points' (28, n)
# base-field rows, one row a query round) and N=376000's largest, ragged
# lengths around a lane's run and a block's points, and the edge bases
POWERS_NS = (2, 4, 256, 1024, 1 << 17, 1 << 18, 1 << 19, 1 << 20, 1 << 21,
             1 << 22)
POWERS_RAGGED = (1, 3, 31, 33, 4095, 4097, 2 * 4096 + 5)
POWERS_EDGE = (0, 1, _P - 1, 1 << 32, _EPSILON, 1234567890123456789 % _P)
EXT_POWERS_EDGE = ((0, 0), (1, 0), (_P - 1, 0), (1 << 32, 0), (0, 1),
                   (0, _P - 1), (123456789, _P - 5), (_P - 1, _P - 1))
QUERY_ROUNDS = 28
POWERS_TIMED = 1 << 21  # ProgramStark's degree, the largest at N=94000


def powers_bound(rows: int, n: int, ext: bool = False) -> dict:
    """K13's least time: the table written (8 bytes a point, 16 in the
    extension) and one product a point (in the extension two sums of two
    unreduced products, with the step's im part times 7 made once)."""
    if ext:
        return bound(16 * n + 16, n * (4 * (OPS_PRODUCT + OPS_ACCUMULATE)
                                       + 2 * OPS_REDUCE_WIDE),
                     n * 4 * MUL_PRODUCT)
    return bound(8 * rows * (n + 1), rows * n * OPS_MUL,
                 rows * n * MUL_PRODUCT)


def ext_powers_chain(zb, n: int):
    """The extpows program before K13 (op by op: gfe.mul's K3, add and sub
    launches, two cats and a squaring a doubling step): the yardstick."""
    import torch

    from olavm_tpu_torch.field import gfe

    out = gfe.ones((1,), zb.device)
    zm, length = gfe.GFE(zb[0], zb[1]), 1
    while length < n:
        step = min(length, n - length)
        nxt = gfe.mul(out[:step], zm)
        out = gfe.GFE(torch.cat([out.re, nxt.re]), torch.cat([out.im, nxt.im]))
        length += step
        if length < n:
            zm = gfe.mul(zm, zm)
    return torch.stack([out.re, out.im])


def base_powers_chain(bases, n: int):
    """(k, n) tables of (k,) bases as gf.powers made them before K13 (op by
    op: a K3 launch, a cat and a squaring a doubling step): the yardstick."""
    import torch

    from olavm_tpu_torch.field import gf

    out = gf.ones((bases.shape[0], 1), bases.device)
    bm, length = bases[:, None], 1
    while length < n:
        step = min(length, n - length)
        out = torch.cat([out, gf.mul(out[:, :step], bm)], dim=1)
        length += step
        if length < n:
            bm = gf.square(bm)
    return out


def check_powers_kernels(device, rng) -> dict:
    """K13 (gf.powers, gfe.powers_stacked) against its plain versions,
    exactly: the extension table of every edge base and a random one at
    every POWERS_NS and POWERS_RAGGED length, the base field's (28, n) rows
    of the query points (random bases, the edge bases among them) and a
    host int (a 0-dim tensor) at the same lengths; each timed by CUDA events at
    POWERS_TIMED beside the log-doubling chain it replaced (the extension's
    on gfe.mul, the base field's on gf.mul)."""
    import numpy as np
    import torch

    from olavm_tpu_torch.field import gf, gfe

    results = {"powers": {"max_abs_err": 0}, "ext_powers": {"max_abs_err": 0}}

    def err(name, a, b):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                           max_abs_err(a, b))

    bases = np.concatenate([np.asarray(POWERS_EDGE, dtype=np.uint64),
                            rng.integers(0, _P, QUERY_ROUNDS
                                         - len(POWERS_EDGE), dtype=np.uint64)])
    rows = gf.from_u64(bases, device)
    ext_bases = [*EXT_POWERS_EDGE,
                 tuple(int(v) for v in rng.integers(0, _P, 2,
                                                    dtype=np.uint64))]
    for n in (*POWERS_RAGGED, *POWERS_NS):
        for b in ext_bases:
            base = gfe.from_u64_pair(np.asarray(b, dtype=np.uint64), device)
            want = gfe.powers_plain(base, n)
            err("ext_powers", gfe.powers_stacked(base, n),
                torch.stack([want.re, want.im]))
        if n <= POWERS_TIMED:
            err("powers", gf.powers(rows, n), gf.powers_plain(rows, n))
        err("powers", gf.powers(int(bases[2]), n, device),
            gf.powers_plain(rows[2], n))
        torch.cuda.empty_cache()
    n = POWERS_TIMED
    zb = gf.from_u64(list(ext_bases[-1]), device)
    cases = {
        "powers": (lambda: gf.powers(rows, n), lambda: gf.powers_plain(rows, n),
                   lambda: base_powers_chain(rows, n),
                   powers_bound(QUERY_ROUNDS, n),
                   f"({QUERY_ROUNDS}, 2^{n.bit_length() - 1})"),
        "ext_powers": (lambda: gfe.powers_stacked(gfe.GFE(zb[0], zb[1]), n),
                       lambda: gfe.powers_plain(gfe.GFE(zb[0], zb[1]), n),
                       lambda: ext_powers_chain(zb, n),
                       powers_bound(1, n, ext=True),
                       f"2^{n.bit_length() - 1}")}
    checked = (f"every edge base and a random one at n in {POWERS_RAGGED} "
               f"and {POWERS_NS}, the base field as ({QUERY_ROUNDS}, n) rows "
               f"and one host int")
    for name, (call, plain, chain, least, shape) in cases.items():
        ms = cuda_ms(call, 50)
        plain_ms = cuda_ms(plain, 2)
        chain_ms = cuda_ms(chain, 2)
        results[name].update({"ms": ms, "plain_ms": plain_ms,
                              "chain_ms": chain_ms, **least,
                              "library_ms": None,
                              "checked": f"{checked}; times at {shape}"})
        e = results[name]["max_abs_err"]
        log(f"  {name}: max_abs_err={e} kernel {ms:.4f} ms at {shape}, "
            f"plain {plain_ms:.4f} ms, the log-doubling chain on the "
            f"kernels {chain_ms:.4f} ms, bound {least['bound_ms']:.4f} ms by "
            f"{least['bound_by']} ({least['bound_ms'] / ms:.0%}; {checked})")
        if e != 0:
            raise AssertionError(f"{name} disagrees with its plain version")
    big = 1 << 22
    results["ext_powers"]["ms_2^22"] = cuda_ms(
        lambda: gfe.powers_stacked(gfe.GFE(zb[0], zb[1]), big), 20)
    results["ext_powers"]["bound_ms_2^22"] = powers_bound(
        1, big, ext=True)["bound_ms"]
    log(f"  ext_powers at 2^22: {results['ext_powers']['ms_2^22']:.4f} ms")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------


def prepare(n: int, workdir: str, trace_dir: str | None = None):
    """Execute the fib-loop fixture at N=n and generate its traces. Returns
    (prove, report, ola): prove(device, timing=None, merkle_hasher="blake3")
    runs prove_with_traces_device on those traces with
    standard_fast_config and that Merkle hasher, ends with a synchronize and
    returns (proof, seconds, config); report holds the sizes and the seconds
    so far. Given `trace_dir`, the traces are also written there
    (save_traces), for the sharded ranks of phase 7."""
    from olavm_tpu_torch.runtime.harness import run_program_fast
    from olavm_tpu_torch.stark.proof import PublicValues
    from olavm_tpu_torch.tables.fast_gen import generate_traces_fast
    from olavm_tpu_torch.tables.ola_stark import OlaStark

    seconds = {}
    t0 = time.perf_counter()
    fast_run, process, program, _ = run_program_fast(
        write_fib_program(n, workdir), calldata=None)
    seconds["execute"] = time.perf_counter() - t0

    ola = OlaStark()
    t0 = time.perf_counter()
    traces = generate_traces_fast(fast_run, program, ola, process)
    seconds["trace_gen"] = time.perf_counter() - t0
    pre, post = program.trace.start_end_roots
    prepared = prepared_tables(
        traces, PublicValues(tuple(pre), tuple(post), 0), ola,
        {"N": n, "steps": int(fast_run.cpu.shape[0]), "seconds": seconds})
    if trace_dir is not None:
        save_traces(trace_dir, traces, prepared[1], ola)
    return prepared


def save_traces(trace_dir: str, traces, report: dict, ola) -> None:
    """The 12 tables as table{i}.npy, and the prepared report (sizes, public
    values) with the tables' compress challenges, which trace generation
    set on `ola`, as report.json in `trace_dir`: a rank of phase 7 reads
    them from there (load_traces), since spawn would pickle them to every
    rank (the CPU table alone is 790 MB at N=94000)."""
    import numpy as np

    os.makedirs(trace_dir, exist_ok=True)
    for i, t in enumerate(traces):
        np.save(os.path.join(trace_dir, f"table{i}.npy"), t)
    with open(os.path.join(trace_dir, "report.json"), "w") as f:
        json.dump({**{k: v for k, v in report.items() if k != "seconds"},
                   "compress_challenges": ola.compress_challenges()}, f)


def load_traces(trace_dir: str):
    """save_traces' (traces, public values, OlaStark with the traces'
    compress challenges, report)."""
    import numpy as np

    from olavm_tpu_torch.stark.proof import PublicValues
    from olavm_tpu_torch.tables.ola_stark import OlaStark

    with open(os.path.join(trace_dir, "report.json")) as f:
        report = json.load(f)
    traces = [np.load(os.path.join(trace_dir, f"table{i}.npy"))
              for i in range(len(report["table_shapes"]))]
    pv = report["public_values"]
    ola = OlaStark()
    ola.set_compress_challenges(report.pop("compress_challenges"))
    return traces, PublicValues(tuple(pv["pre_root"]), tuple(pv["post_root"]),
                                0), ola, report


def prepared_tables(traces, public_values, ola, report: dict):
    """What prepare() gives for tables made elsewhere: (prove, report, ola),
    the report completed with the table shapes and public values."""
    import torch

    from olavm_tpu_torch.stark.config import StarkConfig
    from olavm_tpu_torch.stark.prover_device import prove_with_traces_device

    def prove(device, timing=None, merkle_hasher="blake3"):
        config = StarkConfig.standard_fast_config()
        config.merkle_hasher = merkle_hasher
        t0 = time.perf_counter()
        proof = prove_with_traces_device(ola, config, traces,
                                         public_values=public_values,
                                         timing=timing, device=device)
        torch.cuda.synchronize()
        return proof, time.perf_counter() - t0, config

    report.update({
        "table_shapes": [list(t.shape) for t in traces],
        "public_values": {
            "pre_root": [int(x) for x in public_values.pre_state_root],
            "post_root": [int(x) for x in public_values.post_state_root]}})
    return prove, report, ola


def prepare_node():
    """node_tx's tables, as prepare() gives a program's: (prove, report,
    ola)."""
    t0 = time.perf_counter()
    _, trace, traces, public_values, ola = node_tx()
    seconds = {"execute_and_trace_gen": time.perf_counter() - t0}
    return prepared_tables(traces, public_values, ola, {
        "N": None, "steps": len(trace.exec), "sccall_rows": len(trace.sc_call),
        "seconds": seconds})


def prepare_allops(k: int):
    """The instruction-set fixture's tables at K=k (allops_traces: the
    interpreter path, run_program_full -> generate_traces), as prepare()
    gives a program's: (prove, report, ola)."""
    t0 = time.perf_counter()
    traces, public_values, ola, program_sha256 = allops_traces(k)
    seconds = {"execute_and_trace_gen": time.perf_counter() - t0}
    return prepared_tables(traces, public_values, ola, {
        "K": k, "calldata": ALLOPS_CALLDATA, "program_sha256": program_sha256,
        "seconds": seconds})


def host_peak_resident() -> int:
    """This process's peak resident memory so far, in bytes."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def prove_and_verify(prepared, device, merkle_hasher: str):
    """prove_with_traces_device -> verify_proof on prepare()'s traces with
    one Merkle hasher; returns (proof bytes, report)."""
    import torch

    from olavm_tpu_torch.stark.prover_device import TimingTree
    from olavm_tpu_torch.stark.serialization import serialize_all_proof
    from olavm_tpu_torch.stark.verifier import verify_proof

    prove, prepared_report, ola = prepared
    report = {**prepared_report, "merkle_hasher": merkle_hasher,
              "seconds": dict(prepared_report["seconds"])}
    seconds = report["seconds"]
    torch.cuda.reset_peak_memory_stats()
    timing = TimingTree()
    proof, seconds["prove"], config = prove(device, timing, merkle_hasher)
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()

    t0 = time.perf_counter()
    verify_proof(ola, proof, config)
    seconds["verify"] = time.perf_counter() - t0

    data = serialize_all_proof(proof)
    report.update({
        "peak_memory_bytes": int(peak),
        "peak_reserved_bytes": int(peak_reserved),
        "program_memory_bytes": program_memory(),
        "proof_bytes": len(data),
        "proof_sha256": hashlib.sha256(data).hexdigest(),
        "prove_scopes": [[d, name, s] for d, name, s in timing.records],
    })
    return data, report


@contextlib.contextmanager
def plain_chains_refused():
    """Within it, the plain versions that K7-K13 replaced on the main path
    (the exp_const chain of inversion, gf.inv_plain, gfe.inv_plain, the
    Hillis-Steele gf.prefix_prod_plain, the FRI composition's
    fri_combine_plain and fri_quotient_plain, the CTL Z's
    ctl_combine_plain, the fold's fri_fold_plain and the log-doubling
    power tables gf.powers_plain and gfe.powers_plain) raise when given a
    CUDA tensor: on the card every inversion, scan, composition, CTL row
    combination, fold and power table must take its kernel; and
    gf.power_rows (a log-doubling table with a host copy a step) raises
    unless ntt.twiddles calls it."""
    import torch

    from olavm_tpu_torch.field import gf, gfe
    from olavm_tpu_torch.ntt import ntt as dntt
    from olavm_tpu_torch.stark import ctl_kernels as ck
    from olavm_tpu_torch.stark import fri_kernels as fk

    def refuse(name, fn):
        def guarded(*args, **kwargs):
            parts = [p for a in args
                     for p in (a if isinstance(a, (tuple, list)) else (a,))]
            if any(isinstance(p, torch.Tensor) and p.is_cuda for p in parts):
                raise AssertionError(f"{name} ran on a CUDA tensor on the "
                                     f"main path")
            return fn(*args, **kwargs)
        return guarded

    def twiddles_only(fn):
        def guarded(*args, **kwargs):
            if sys._getframe(1).f_code is not dntt.twiddles.__code__:
                raise AssertionError("gf.power_rows ran outside ntt.twiddles "
                                     "on the main path")
            return fn(*args, **kwargs)
        return guarded

    saved = [(mod, name, getattr(mod, name)) for mod, name in (
        (gf, "exp_const"), (gf, "inv_plain"), (gfe, "inv_plain"),
        (gf, "prefix_prod_plain"), (fk, "fri_combine_plain"),
        (fk, "fri_quotient_plain"), (ck, "ctl_combine_plain"),
        (fk, "fri_fold_plain"), (gf, "powers_plain"), (gfe, "powers_plain"),
        (gf, "power_rows"))]
    for mod, name, fn in saved:
        setattr(mod, name, twiddles_only(fn) if name == "power_rows"
                else refuse(f"{mod.__name__}.{name}", fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def program_memory() -> dict:
    """Device bytes held by the programs (olavm_tpu_torch/utils/jitcache.py)
    now: their input and output buffers and their shared graph pool."""
    from olavm_tpu_torch.utils import jitcache

    return {"buffers": jitcache.buffer_bytes(), "pool": jitcache.pool_bytes()}


def program_counts(before: dict, after: dict) -> dict:
    """Captures, graphs dropped, replays and the kernel launches the replays
    ran between two jitcache.stats(), in all and per program tag (there
    also by kernel)."""
    fields = ("captures", "dropped", "replays", "replayed_launches")
    out = {**dict.fromkeys(fields, 0), "by_tag": {}}
    for key, st in after.items():
        old = before.get(key, dict.fromkeys(fields, 0))
        tag = out["by_tag"].setdefault(st["tag"], {
            **dict.fromkeys(fields, 0), "replayed_kernels": {}})
        for k in fields:
            tag[k] += st[k] - old[k]
            out[k] += st[k] - old[k]
        by_kernel = tag["replayed_kernels"]
        for k, v in st["replayed_kernels"].items():
            v -= old.get("replayed_kernels", {}).get(k, 0)
            if v:
                by_kernel[k] = by_kernel.get(k, 0) + v
    return out


def kernel_nodes(key: str, launched: dict) -> int:
    """The graph nodes that a program's counted launches make: one a
    launch, and K1's passes for each transform (the transform's size the
    key's second entry, as in the fri_refft key)."""
    from olavm_tpu_torch import kernels

    nodes = sum(v for k, v in launched.items() if k != "ntt")
    if launched.get("ntt"):
        log_n = ast.literal_eval(key)[1].bit_length() - 1
        nodes += launched["ntt"] * kernels.lib("ntt").gl_ntt_passes(log_n)
    return nodes


def program_summary() -> dict:
    """jitcache.stats() summed per program tag: keys, captures, replays,
    graph nodes (and the most in one graph), capture seconds, launches of
    one replay of each key."""
    from olavm_tpu_torch.utils import jitcache

    tags = {}
    for st in jitcache.stats().values():
        t = tags.setdefault(st["tag"], {
            "keys": 0, "captures": 0, "replays": 0, "nodes": 0,
            "max_nodes": 0, "capture_seconds": 0.0, "launches": 0})
        t["keys"] += 1
        t["max_nodes"] = max(t["max_nodes"], st["nodes"])
        for k in ("captures", "replays", "nodes", "capture_seconds",
                  "launches"):
            t[k] += st[k]
    return tags


def merkle_hash_counts(ola, table_shapes, config) -> dict:
    """What one prove of tables of these (columns, rows) shapes hashes,
    counted from the commits' shapes: per commit (trace, Z, quotient, each
    FRI tree), the leaves of more than 4 elements and their sponge
    permutations, ceil(C / 8) each, and the tree nodes above the cap, one
    compression each; the launches of the leaf kernels: the trace, Z and
    quotient commits stream their LDE through the absorb kernel, one launch
    per 16 columns, the FRI trees hash their leaves at once. Equal for the
    two hashers, whose leaf rule is the same."""
    rate_bits = config.fri_config.rate_bits
    cap = 1 << config.fri_config.cap_height
    ctl_zs = [0] * len(table_shapes)
    for ctl in ola.cross_table_lookups:
        for t in (*ctl.looking_tables, ctl.looked_table):
            ctl_zs[t.table] += config.num_challenges
    counts = {"leaf_launches": 0, "absorb_launches": 0, "leaves": 0,
              "leaf_permutations": 0, "compressions": 0}

    def commit(C, n, streamed):
        if C > 4:  # shorter leaves are their own digests
            if streamed:
                counts["absorb_launches"] += -(-C // 16)
            else:
                counts["leaf_launches"] += 1
            counts["leaves"] += n
            counts["leaf_permutations"] += -(-C // 8) * n
        counts["compressions"] += max(n - cap, 0)

    for i, (stark, (cols, rows)) in enumerate(zip(ola.starks, table_shapes)):
        size = rows << rate_bits
        commit(cols, size, True)
        commit(stark.num_permutation_batches(config) + ctl_zs[i], size, True)
        commit(stark.num_quotient_polys(config), size, True)
        for arity_bits in config.fri_config.reduction_arity_bits(
                rows.bit_length() - 1):
            size >>= arity_bits  # leaves of `arity` extension values
            commit(2 << arity_bits, size, False)
    return counts


def check_path_launches(launches: dict, hasher: str, ola, table_shapes
                        ) -> dict:
    """A prove's launch counts: its hasher's kernels launched (its leaf and
    absorb kernels as often as its commits' shapes need) and none of the
    other hasher's. Returns merkle_hash_counts."""
    from olavm_tpu_torch.stark.config import StarkConfig

    counts = merkle_hash_counts(ola, table_shapes,
                                StarkConfig.standard_fast_config())
    for kind, key in (("leaves", "leaf_launches"),
                      ("absorb", "absorb_launches")):
        if launches[f"{hasher}_{kind}"] != counts[key]:
            raise AssertionError(
                f"{hasher} {kind} launches {launches[f'{hasher}_{kind}']}, "
                f"the commits' shapes need {counts[key]}")
    missing = [k for k in PATH_KERNELS[hasher] if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {hasher} "
                             f"path: {missing}")
    stray = [k for k, v in launches.items()
             if v and k not in PATH_KERNELS[hasher]]
    if stray:
        raise AssertionError(f"kernels of another path launched on the "
                             f"{hasher} path: {stray}")
    return counts


def check_golden(report: dict, golden_file: str) -> dict:
    """The proof's public values, sha256 and length against a golden of
    olavm_tpu's, and its N or K, steps, sccall rows, table shapes, calldata
    and program's sha256 where the golden has them; returns what was
    compared."""
    with open(os.path.join(FIXTURES, golden_file)) as f:
        golden = json.load(f)
    for key in ("public_values", "proof_sha256", "proof_bytes",
                *(k for k in ("N", "K", "steps", "sccall_rows", "table_shapes",
                              "calldata", "program_sha256")
                  if k in golden)):
        if report[key] != golden[key]:
            raise AssertionError(
                f"{golden_file}: proof {key} {report[key]!r} differs from the "
                f"golden {golden[key]!r}")
    log(f"    proof {golden['proof_bytes']} bytes, sha256 "
        f"{golden['proof_sha256']} equals {golden_file}")
    return {"golden": golden_file, "proof_sha256": golden["proof_sha256"],
            "proof_bytes": golden["proof_bytes"]}


def cli_path(workdir: str) -> dict:
    """asm -> run -> prove (default backend: the card) -> verify through the
    port's CLI, in this process, on the fib-loop fixture at N=10 with
    calldata 0, 0; the proof must equal cli_fib_golden.json. The CLI's own
    output goes to stderr."""
    import contextlib

    from olavm_tpu_torch.cli.main import main as cli

    with open(os.path.join(FIXTURES, "cli_fib_golden.json")) as f:
        golden = json.load(f)
    argvs, out = cli_stages(golden["N"], workdir)
    seconds = {}
    with contextlib.redirect_stdout(sys.stderr):
        for stage in ("asm", "run", "prove", "verify"):
            t0 = time.perf_counter()
            cli(argvs[stage])
            seconds[stage] = time.perf_counter() - t0
    with open(out["prove"], "rb") as f:
        data = f.read()
    got = {"proof_sha256": hashlib.sha256(data).hexdigest(),
           "proof_bytes": len(data)}
    for key, value in got.items():
        if value != golden[key]:
            raise AssertionError(f"CLI proof {key} {value!r} differs from "
                                 f"cli_fib_golden.json's {golden[key]!r}")
    return {**got, "seconds": seconds}


# the kernels of each full-size path: each must launch on its own path, and
# the other Merkle hasher's kernels must not, nor the sub kernel (its last
# launches on the path, the openings' power tables' extension products,
# went to K13)
SHARED_KERNELS = ("ntt", "poseidon", "gf_mul", "gf_add", "eval_points",
                  "constraints", "scale_powers", "quotient_selectors",
                  "gf_inv", "prefix_prod",
                  "fri_combine", "fri_quotient", "ctl_combine", "fri_fold",
                  "powers", "ext_powers")
# kernels that the quotient's programs must not launch: K6 and its fixed
# kernels took their place
NOT_IN_QUOTIENT = ("gf_mul", "gf_add", "gf_sub")
# kernels that the FRI composition's programs must not launch: K9 and K10
# took their place (K7's extension entry left the main path with them)
NOT_IN_FRICOMP = ("gf_mul", "gf_add", "gf_sub", "gf_ext_inv")
# kernels that the CTL Z and FRI fold programs must not launch: K11 and K12
# took their place
NOT_IN_CTLZ = ("gf_mul", "gf_add", "gf_sub")
NOT_IN_FRIFOLD = ("gf_mul", "gf_add", "gf_sub")
# what the openings' power tables and the FRI re-FFTs launch, all of it
# (K13 took the place of a K3, cat and squaring chain; the re-FFT's coset
# scaling is gl_scale_powers with no power table): a graph of these
# programs holds those launches and its outputs' copies and no other node
# (a cat, a fill or a copy would be one); program_kernels adds the grand
# products' programs
PROGRAM_KERNELS = {"extpows": {"ext_powers": 1},
                   "fri_refft": {"scale_powers": 1, "ntt": 1}}


def program_kernels(tag: str, key: str):
    """What the graph of a program (`key` as jitcache.stats() gives it)
    must hold besides its outputs' copies: ({kernel: launches}, the fills
    and copies among its nodes), or None where it is not checked. A table's
    CTL Zs (ctlz): K11 a view into its row, one K8 launch and the fill of
    K8's counter and flags. Its permutation batches (permz): each batch's
    num and den chains (a K3 and an add a column of a pair, beta's next
    power, a product a chain an instance; a fill of 1 a chain and one of w
    an instance; each chain's copy into its row), then one K7, one K3 and
    one K8 launch with its fill."""
    if tag in PROGRAM_KERNELS:
        return PROGRAM_KERNELS[tag], 0
    k = ast.literal_eval(key)
    if tag == "ctlz":
        return {"ctl_combine": len(k[2]), "prefix_prod": 1}, 1
    if tag == "permz":
        meta = k[4]
        pairs = sum(len(column_pairs) for batch in meta
                    for column_pairs, _ in batch)
        instances = sum(len(batch) for batch in meta)
        return ({"gf_mul": 3 * pairs + 2 * instances + 1,
                 "gf_add": 2 * pairs, "gf_inv": 1, "prefix_prod": 1},
                4 * len(meta) + instances + 1)
    return None
PATH_KERNELS = {
    "blake3": SHARED_KERNELS + ("blake3_leaves", "blake3_level",
                                "blake3_absorb"),
    "poseidon": SHARED_KERNELS + ("poseidon_leaves", "poseidon_level",
                                  "poseidon_absorb"),
}
# 2^22 CPU rows: 4,136,005 steps
LARGE_N = 376000
# K5's shapes in an N=94000 prove: per table (n, (trace, Z, quotient
# widths)), each batch at the 28 FRI query points, the trace and Z batches
# at the openings' 4 extension rows, the quotient batch at 2: (C, n, k)
K5_TABLES = (
    (1 << 20, (94, 78, 12)), (1 << 18, (29, 8, 14)), (1 << 18, (59, 10, 4)),
    (1 << 17, (6, 4, 4)), (1 << 19, (12, 12, 4)), (1024, (134, 6, 12)),
    (2, (53, 28, 4)), (256, (48, 12, 6)), (2, (6, 2, 8)), (2, (26, 4, 2)),
    (1 << 21, (18, 6, 4)), (4, (40, 20, 6)))
K5_SHAPES = tuple(sorted({(C, n, k) for n, widths in K5_TABLES
                          for C, ks in zip(widths, ((28, 4), (28, 4), (28, 2)))
                          for k in ks}))
FULL_CPU_ROWS = 1 << 20  # CpuStark's rows at N=94000
# products per point that the selector columns need: two inverses by batch
# inversion (about 3 products each) and the Lagrange numerators
SELECTOR_PRODUCTS = 2 * 3 + 2
# the quotient's tables: (OlaStark table index, degree) at N=94000 (every
# table, K5_TABLES' order) and K=512's PoseidonStark and StorageAccessStark
QUOTIENT_SHAPES = tuple((t, n) for t, (n, _) in enumerate(K5_TABLES)) + (
    (5, 1 << 20), (7, 1 << 19))


# canonical values at the edges of K6's lazy arithmetic: (p - 1) + EPSILON
# is 2^64 - 1, 0 - (p - 1) borrows, (p - 1)^2 is the largest product
EDGE_VALUES = (0, 1, 2, _P - 1, _P - 2, 1 << 32, _EPSILON, (1 << 32) + 1,
               1 << 63, _P - _EPSILON)


def edge_values(rng, shape):
    """A uint64 array of `shape` drawn from EDGE_VALUES."""
    import numpy as np

    return np.array(EDGE_VALUES, dtype=np.uint64)[
        rng.integers(0, len(EDGE_VALUES), shape)]


def quotient_case(table: int, degree: int, rng, device) -> dict:
    """One table's quotient inputs at `degree` rows, random from `rng`: the
    trace and Z coefficients (made on the card), compress challenges, and
    the bank of alphas and permutation and CTL challenges with the static
    metadata that compute_quotient_polys_device gives quotient_class
    (prover_device.quotient_statics): the keyword arguments under
    "static", the bank under "bank"."""
    import numpy as np
    import torch

    from olavm_tpu_torch.field import gf
    from olavm_tpu_torch.stark import prover_device as tpd
    from olavm_tpu_torch.stark.config import StarkConfig
    from olavm_tpu_torch.tables.ola_stark import OlaStark

    def field(k):
        return [int(v) for v in rng.integers(0, gf.P, k, dtype=np.uint64)]

    config = StarkConfig.standard_fast_config()
    ola = OlaStark()
    ola.set_compress_challenges(field(len(ola.starks)))
    stark, nz, static, values = tpd.quotient_statics(
        ola, config, lambda: field(1)[0])[table]
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 31)))
    return {
        "stark": stark, "config": config, "degree": degree,
        "coeffs": torch.randint(0, 1 << 62, (stark.COLUMNS, degree),
                                generator=gen, device=device),
        "zs_coeffs": torch.randint(0, 1 << 62, (nz, degree), generator=gen,
                                   device=device),
        "bank": gf.from_u64(values, device), "static": static}


# the goldens of each path: olavm_tpu's host prover on the same program
# (tests/test_torch_golden.py), at N=10 and at FULL_N
GOLDENS = {
    "blake3": "fib_loop_golden.json",
    "poseidon": "fib_loop_golden_poseidon.json",
}
FULL_GOLDENS = {
    "blake3": "fib_loop_golden_full.json",
    "poseidon": "fib_loop_golden_full_poseidon.json",
}
# the node tx's proof by olavm_tpu's node and host prover, blake3 caps
NODE_GOLDEN = "node_sccall_golden.json"
# the instruction-set fixture's proofs by olavm_tpu's host prover: at
# ALLOPS_K with each hasher, at ALLOPS_K_FULL with blake3 caps
ALLOPS_GOLDENS = {
    "blake3": "allops_golden.json",
    "poseidon": "allops_golden_poseidon.json",
}
ALLOPS_GOLDEN_FULL = "allops_golden_full.json"


# ---------------------------------------------------------------------------
# phase 7: the sharded prover
# ---------------------------------------------------------------------------

# the counters of olavm_tpu_torch.parallel.sharded.PHASES, each of which must
# count on every rank of a group of two
SHARDED_PHASES = ("intt", "commit", "quotient", "fold", "tree")
# (ranks, backend, jobs (label, traces, Merkle hasher, golden)) of each
# group, all ranks on cuda:0: NCCL refuses two ranks on one card, so the
# group of two runs over gloo, and NCCL runs one rank
SHARDED_GROUPS = (
    (2, "gloo", ((f"N={FULL_N} blake3", "full", "blake3",
                  FULL_GOLDENS["blake3"]),
                 ("N=10 poseidon", "small", "poseidon",
                  GOLDENS["poseidon"]))),
    (1, "nccl", (("N=10 blake3", "small", "blake3", GOLDENS["blake3"]),)),
)


def sharded_rank(workdir: str, backend: str, jobs) -> list[dict]:
    """One rank of a phase-7 group: each job's traces (save_traces, under
    `workdir`) proved by prove_with_traces_sharded on this rank's card, with
    every launch count and sharded-phase counter set to 0 just before the
    prove and read just after; rank 0 also verifies."""
    import torch
    import torch.distributed as dist

    from olavm_tpu_torch import kernels
    from olavm_tpu_torch.parallel import sharded as psh
    from olavm_tpu_torch.stark.config import MeshConfig, StarkConfig
    from olavm_tpu_torch.stark.serialization import serialize_all_proof
    from olavm_tpu_torch.stark.verifier import verify_proof
    from olavm_tpu_torch.utils import jitcache
    from olavm_tpu_torch.utils.timing import TimingTree

    mesh = psh.make_mesh(device_type="cuda")
    rank, world = dist.get_rank(), dist.get_world_size()
    reports = []
    for label, trace_name, hasher, _ in jobs:
        traces, public_values, ola, prepared = load_traces(
            os.path.join(workdir, trace_name))
        config = StarkConfig.standard_fast_config()
        config.merkle_hasher = hasher
        config.mesh = MeshConfig(backend=backend, device_type="cuda")
        # every rank starts its clock together (rank 0 verified the last job)
        dist.barrier()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        psh.reset_phases()
        before = jitcache.stats()
        timing = TimingTree()
        t0 = time.perf_counter()
        proof = psh.prove_with_traces_sharded(
            ola, config, traces, public_values=public_values, timing=timing,
            mesh=mesh)
        torch.cuda.synchronize()
        seconds = {"prove": time.perf_counter() - t0}
        launches, phases = dict(kernels.LAUNCHES), dict(psh.PHASES)
        host_launches = dict(kernels.HOST_LAUNCHES)
        programs = program_counts(before, jitcache.stats())
        peak = torch.cuda.max_memory_allocated()
        peak_reserved = torch.cuda.max_memory_reserved()
        if rank == 0:
            t0 = time.perf_counter()
            verify_proof(ola, proof, config)
            seconds["verify"] = time.perf_counter() - t0
        data = serialize_all_proof(proof)
        reports.append({
            **prepared, "label": f"{label} rank {rank} of {world}",
            "rank": rank, "world": world, "backend": dist.get_backend(),
            "card": torch.cuda.current_device(), "merkle_hasher": hasher,
            "seconds": seconds, "peak_memory_bytes": int(peak),
            "peak_reserved_bytes": int(peak_reserved),
            "program_memory_bytes": program_memory(),
            "host_peak_resident_bytes": host_peak_resident(),
            "launches": launches, "host_launches": host_launches,
            "programs": programs, "sharded_phases": phases,
            "proof_bytes": len(data),
            "proof_sha256": hashlib.sha256(data).hexdigest(),
            "prove_scopes": [[d, name, s] for d, name, s in timing.records]})
        del proof, traces
        torch.cuda.empty_cache()
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "olavm_tpu"))
    for r in reports:
        r["reference_modules"] = loaded
    return reports


def sharded_path(workdir: str, started: float) -> list[dict]:
    """Phase 7: each of SHARDED_GROUPS spawned on the card (run_ranks, the
    kernels already built); every rank's proof must equal its golden, launch
    its hasher's kernels and, in a group of two, run every sharded phase,
    with neither jax nor olavm_tpu loaded. Returns every rank's report."""
    from olavm_tpu_torch.parallel import sharded as psh
    from olavm_tpu_torch.tables.ola_stark import OlaStark

    ola = OlaStark()
    reports = []
    for world, backend, jobs in SHARDED_GROUPS:
        log(f"[7] {world} rank(s) on cuda:0, backend {backend}: "
            f"{[job[0] for job in jobs]} "
            f"(at {time.perf_counter() - started:.1f} s)")
        ranks = psh.run_ranks(sharded_rank, world, backend, "cuda", workdir,
                              backend, jobs)
        for j, (_, _, hasher, golden_file) in enumerate(jobs):
            for rep in (r[j] for r in ranks):
                if rep["backend"] != backend or rep["reference_modules"]:
                    raise AssertionError(
                        f"{rep['label']}: backend {rep['backend']}, loaded "
                        f"{rep['reference_modules']}")
                rep["merkle_hashing"] = check_path_launches(
                    rep["launches"], hasher, ola, rep["table_shapes"])
                idle = [k for k in SHARDED_PHASES
                        if rep["sharded_phases"][k] == 0]
                if world > 1 and idle:
                    raise AssertionError(f"{rep['label']}: sharded phases "
                                         f"that never ran: {idle}")
                rep["golden"] = check_golden(rep, golden_file)
                log(f"    {rep['label']}: seconds {rep['seconds']}, peak "
                    f"{rep['peak_memory_bytes'] / 2**30:.2f} GiB on the "
                    f"card, sha256 {rep['proof_sha256']}, sharded phases "
                    f"{rep['sharded_phases']}, launches {rep['launches']}")
                reports.append(rep)
    return reports


KERNELS = (
    # name, route, source, replaces, launch counters
    ("ntt", "cuda", "olavm_tpu_torch/csrc/ntt.cu",
     "olavm_tpu/ntt/pallas_ntt.py:223", ("ntt",)),
    ("poseidon", "cuda", "olavm_tpu_torch/csrc/poseidon.cu",
     "olavm_tpu/field/pallas_kernels.py:127", ("poseidon",)),
    ("gf_mul", "cuda", "olavm_tpu_torch/csrc/gf_mul.cu",
     "olavm_tpu/field/pallas_kernels.py:79", ("gf_mul",)),
    ("gf_add", "cuda", "olavm_tpu_torch/csrc/gf_mul.cu",
     "olavm_tpu/field/gf.py:89", ("gf_add",)),
    ("gf_sub", "cuda", "olavm_tpu_torch/csrc/gf_mul.cu",
     "olavm_tpu/field/gf.py:104", ("gf_sub",)),
    ("blake3_leaves", "cuda", "olavm_tpu_torch/csrc/blake3.cu",
     "olavm_tpu/merkle/device.py:106", ("blake3_leaves",)),
    ("blake3_level", "cuda", "olavm_tpu_torch/csrc/blake3.cu",
     "olavm_tpu/hash/blake3.py:152", ("blake3_level",)),
    ("poseidon_leaves", "cuda", "olavm_tpu_torch/csrc/poseidon.cu",
     "olavm_tpu/merkle/device.py:42", ("poseidon_leaves",)),
    ("poseidon_level", "cuda", "olavm_tpu_torch/csrc/poseidon.cu",
     "olavm_tpu/merkle/device.py:186", ("poseidon_level",)),
    ("blake3_absorb", "cuda", "olavm_tpu_torch/csrc/blake3.cu",
     "olavm_tpu/merkle/device.py:141", ("blake3_absorb",)),
    ("poseidon_absorb", "cuda", "olavm_tpu_torch/csrc/poseidon.cu",
     "olavm_tpu/merkle/device.py:141", ("poseidon_absorb",)),
    ("eval_points", "cuda", "olavm_tpu_torch/csrc/eval.cu",
     "olavm_tpu/stark/oracle_device.py:335", ("eval_points",)),
    ("constraints", "cuda",
     "olavm_tpu_torch/stark/constraint_codegen.py (csrc/constraints.cuh)",
     "olavm_tpu/stark/prover_device.py:276", ("constraints",)),
    ("scale_powers", "cuda", "olavm_tpu_torch/csrc/quotient.cu",
     "olavm_tpu/stark/prover_device.py:318", ("scale_powers",)),
    ("quotient_selectors", "cuda", "olavm_tpu_torch/csrc/quotient.cu",
     "olavm_tpu/stark/prover_device.py:175", ("quotient_selectors",)),
    ("gf_inv", "cuda", "olavm_tpu_torch/csrc/gf_inv.cu",
     "olavm_tpu/field/gf.py:252", ("gf_inv",)),
    ("gf_ext_inv", "cuda", "olavm_tpu_torch/csrc/gf_inv.cu",
     "olavm_tpu/field/gfe.py:115", ("gf_ext_inv",)),
    ("prefix_prod", "cuda", "olavm_tpu_torch/csrc/scan.cu",
     "olavm_tpu/field/gf.py:317", ("prefix_prod",)),
    ("fri_combine", "cuda", "olavm_tpu_torch/csrc/fri.cu",
     "olavm_tpu/stark/prover_device.py:733", ("fri_combine",)),
    ("fri_quotient", "cuda", "olavm_tpu_torch/csrc/fri.cu",
     "olavm_tpu/stark/prover_device.py:794", ("fri_quotient",)),
    ("ctl_combine", "cuda", "olavm_tpu_torch/csrc/ctl.cu",
     "olavm_tpu/stark/ctl_device.py:62", ("ctl_combine",)),
    ("fri_fold", "cuda", "olavm_tpu_torch/csrc/fri.cu",
     "olavm_tpu/stark/prover_device.py:887", ("fri_fold",)),
    ("powers", "cuda", "olavm_tpu_torch/csrc/powers.cu",
     "olavm_tpu/field/gf.py:275", ("powers",)),
    ("ext_powers", "cuda", "olavm_tpu_torch/csrc/powers.cu",
     "olavm_tpu/field/gfe.py:94", ("ext_powers",)),
)


def run() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
        return 2
    jax_before = {m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")}

    from olavm_tpu_torch import kernels
    from olavm_tpu_torch.utils import jitcache

    device = torch.device("cuda", 0)
    report = {}
    started = time.perf_counter()
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")

    # 1. environment and build
    smi = nvidia_smi()
    log(f"[1] card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    built = kernels.build(force=True)
    report["build_seconds"] = time.perf_counter() - t0
    log(f"[1] built {sorted(built)} in {report['build_seconds']:.1f} s")
    # K6: every table's generated source at once (the sources depend on no
    # challenge, so any compress challenges give the prove's)
    from olavm_tpu_torch.stark import prover_device as tpd
    from olavm_tpu_torch.stark.config import StarkConfig
    from olavm_tpu_torch.tables.ola_stark import OlaStark

    ola = OlaStark()
    ola.set_compress_challenges(list(range(1, len(ola.starks) + 1)))
    t0 = time.perf_counter()
    report["k6_build_seconds_each"] = tpd.prebuild_quotient_kernels(
        ola, StarkConfig.standard_fast_config())
    report["k6_build_seconds"] = time.perf_counter() - t0
    k6_built = {n for n in kernels.BUILD_LOG if n.startswith("k6_")}
    log(f"[1] built K6 for the 12 tables "
        f"({len(report['k6_build_seconds_each'])} sources) in "
        f"{report['k6_build_seconds']:.1f} s")
    # registers, shared memory and spills of every kernel, as ptxas reports them
    report["ptxas"] = {
        name: [ln for ln in text.splitlines()
               if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        for name, text in kernels.BUILD_LOG.items()}
    for name, lines in sorted(report["ptxas"].items()):
        for ln in lines:
            log(f"    {name}: {ln.strip()}")

    # 2. kernels against their plain versions
    rng = np.random.default_rng(SEED)
    log(f"[2] kernels against their plain versions "
        f"(at {time.perf_counter() - started:.1f} s)")
    report["kernels"] = check_kernels(device, rng)
    report["kernels"].update(check_stream_kernels(device, rng))
    report["kernels"].update(check_quotient_kernels(device, rng))
    report["kernels"].update(check_inv_scan_kernels(device, rng))
    report["kernels"].update(check_fri_kernels(device, rng))
    report["kernels"].update(check_ctl_fold_kernels(device, rng))
    report["kernels"].update(check_powers_kernels(device, rng))
    report["lazy_sums"] = check_lazy_sums(device, rng)
    torch.cuda.empty_cache()

    def path(label, prepared, hasher, golden_file, replays=False):
        """One path of the main path: every launch count set to 0 just
        before its prove and read just after it (the verifier runs on the
        host), its own kernels launched and the other hasher's not, its leaf
        kernels launched as often as its commits' shapes need, and the proof
        equal to its golden where there is one. With `replays`, the prove
        must capture no program and replay some: every program it runs was
        captured by an earlier prove, whose challenges were other."""
        kernels.reset_launches()
        before = jitcache.stats()
        with plain_chains_refused():
            _, rep = prove_and_verify(prepared, device, hasher)
        rep["label"] = label
        launches = rep["launches"] = dict(kernels.LAUNCHES)
        rep["host_launches"] = dict(kernels.HOST_LAUNCHES)
        rep["programs"] = program_counts(before, jitcache.stats())
        if replays and (rep["programs"]["captures"]
                        or not rep["programs"]["replays"]):
            raise AssertionError(f"{label}: must replay programs captured "
                                 f"by an earlier prove, ran {rep['programs']}")
        for tag, refused in (("qclass", NOT_IN_QUOTIENT),
                             ("fricomp", NOT_IN_FRICOMP),
                             ("ctlz", NOT_IN_CTLZ),
                             ("frifold", NOT_IN_FRIFOLD)):
            stray = {k: st["kernels"] for k, st in jitcache.stats().items()
                     if st["tag"] == tag
                     and any(n in st["kernels"] for n in refused)}
            if stray:
                raise AssertionError(f"{label}: {tag} programs launch "
                                     f"{refused}: {stray}")
        for key, st in jitcache.stats().items():
            want = program_kernels(st["tag"], key)
            if want is not None and st["nodes"] and (
                    st["kernels"] != want[0] or st["nodes"]
                    != kernel_nodes(key, st["kernels"]) + want[1]
                    + st["outputs"]):
                raise AssertionError(
                    f"{label}: program {key} launches {st['kernels']} in "
                    f"{st['nodes']} graph nodes with {st['outputs']} "
                    f"outputs, not {want[0]}, {want[1]} fills and their "
                    f"copies")
        rep["host_peak_resident_bytes"] = host_peak_resident()
        rep["merkle_hashing"] = check_path_launches(
            launches, hasher, prepared[2], rep["table_shapes"])
        if golden_file:
            rep["golden"] = check_golden(rep, golden_file)
        host = sum(rep["host_launches"].values())
        log(f"    {label}: seconds {rep['seconds']}, peak "
            f"{rep['peak_memory_bytes'] / 2**30:.2f} GiB on the card "
            f"({rep['peak_reserved_bytes'] / 2**30:.2f} reserved; programs "
            f"{rep['program_memory_bytes']}), "
            f"{rep['host_peak_resident_bytes'] / 2**30:.2f} GiB host resident, "
            f"proof {rep['proof_bytes']} bytes sha256 {rep['proof_sha256']}, "
            f"launches {launches} ({host} issued by the host, "
            f"{sum(launches.values()) - host} replayed), programs "
            f"{ {k: v for k, v in rep['programs'].items() if k != 'by_tag'} }")
        torch.cuda.empty_cache()
        return rep

    def golden_pair(n, prepared, goldens):
        """Both hashers' goldens at one size, each met by a prove that
        replays programs that a prove with the other hasher, and so with
        other challenges, captured: blake3 captures and Poseidon replays,
        then the programs are dropped and Poseidon captures and blake3
        replays. Returns the four reports by label."""
        reps = {}
        for first, second in (("blake3", "poseidon"), ("poseidon", "blake3")):
            jitcache.clear()
            reps[f"N={n} {first} (captures)"] = path(
                f"N={n} {first} (captures)", prepared, first, goldens[first])
            reps[f"N={n} {second}"] = path(
                f"N={n} {second}", prepared, second, goldens[second],
                replays=True)
        return reps

    with tempfile.TemporaryDirectory() as workdir:
        # 3. parity with the JAX package's goldens, both Merkle hashers on
        # the same traces, each on a prove that replays programs captured
        # under the other's challenges
        small = prepare(10, workdir, os.path.join(workdir, "small"))
        log(f"[3] golden parity at N=10, both Merkle caps "
            f"(at {time.perf_counter() - started:.1f} s)")
        report["golden"] = golden_pair(10, small, GOLDENS)
        del small

        # 4. the main path at full size, both Merkle hashers on the same
        # traces
        log(f"[4] main path at N={FULL_N} "
            f"(at {time.perf_counter() - started:.1f} s)")
        full_prep = prepare(FULL_N, workdir, os.path.join(workdir, "full"))
        report["full"] = golden_pair(FULL_N, full_prep, FULL_GOLDENS)
        report["programs_full"] = program_summary()
        del full_prep

        # 4b. the instruction set through the interpreter path, with the
        # programs of N=94000 still held: K=ALLOPS_K captured with blake3
        # caps and replayed with Poseidon caps, K=ALLOPS_K_FULL captured and
        # replayed with blake3 caps, then 2^22 CPU rows (blake3 caps, no
        # golden: olavm_tpu's host prover would need ~4 x 48.56 GiB of host
        # memory) on top of all of these programs; then, with the programs
        # dropped, K=ALLOPS_K captured with Poseidon caps and replayed with
        # blake3 caps
        allops = report["allops"] = {}
        log(f"[4b] instruction set at K={ALLOPS_K} "
            f"(at {time.perf_counter() - started:.1f} s)")
        small_allops = prepare_allops(ALLOPS_K)
        log(f"    shapes {small_allops[1]['table_shapes']}, execute and "
            f"trace gen {small_allops[1]['seconds']}")
        for label, hasher, replays in (
                (f"K={ALLOPS_K} blake3 (captures)", "blake3", False),
                (f"K={ALLOPS_K} poseidon", "poseidon", True)):
            allops[label] = path(label, small_allops, hasher,
                                 ALLOPS_GOLDENS[hasher], replays)
        log(f"[4b] instruction set at K={ALLOPS_K_FULL} "
            f"(at {time.perf_counter() - started:.1f} s)")
        full_allops = prepare_allops(ALLOPS_K_FULL)
        log(f"    shapes {full_allops[1]['table_shapes']}, execute and "
            f"trace gen {full_allops[1]['seconds']}")
        for label, replays in ((f"K={ALLOPS_K_FULL} blake3 (captures)", False),
                               (f"K={ALLOPS_K_FULL} blake3", True)):
            allops[label] = path(label, full_allops, "blake3",
                                 ALLOPS_GOLDEN_FULL, replays)
        report["programs_after_allops_full"] = jitcache.stats()
        del full_allops
        log(f"[4b] main path at N={LARGE_N}, every earlier size's programs "
            f"held (at {time.perf_counter() - started:.1f} s)")
        large_prep = prepare(LARGE_N, workdir)
        report["large"] = path(f"N={LARGE_N} blake3", large_prep, "blake3",
                               None)
        log(f"    shapes {report['large']['table_shapes']}")
        del large_prep
        jitcache.clear()
        for label, hasher, replays in (
                (f"K={ALLOPS_K} poseidon (captures)", "poseidon", False),
                (f"K={ALLOPS_K} blake3", "blake3", True)):
            allops[label] = path(label, small_allops, hasher,
                                 ALLOPS_GOLDENS[hasher], replays)
        del small_allops

        # 5. the node: deploy the sccall pair, run the caller's tx, prove its
        # tables on the card
        log(f"[5] node tx (manual_deploy, execute_tx, gen_tx_trace) "
            f"(at {time.perf_counter() - started:.1f} s)")
        report["node"] = path("node tx blake3", prepare_node(), "blake3",
                              NODE_GOLDEN)

        # 6. the CLI on the card, in this process
        log(f"[6] ola-torch asm, run, prove, verify at N=10 "
            f"(at {time.perf_counter() - started:.1f} s)")
        report["cli"] = cli_path(workdir)
        log(f"    proof matches cli_fib_golden.json ({report['cli']})")

        # 7. the sharded prover: a group of two ranks on the card over
        # gloo, one rank over NCCL, on the traces of phases 3 and 4 (each
        # rank captures its own programs)
        report["sharded"] = sharded_path(workdir, started)

    # every prove, under its own challenges, ran the 12 sources of phase 1
    k6_later = {n for n in kernels.BUILD_LOG if n.startswith("k6_")} - k6_built
    if k6_later:
        raise AssertionError(f"K6 sources built after phase 1: {k6_later}")
    jax_after = {m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")}
    if jax_after - jax_before:
        raise AssertionError(f"the port imported {sorted(jax_after - jax_before)}")
    reference = sorted(m for m in sys.modules if m.split(".")[0] == "olavm_tpu")
    if reference:
        raise AssertionError(f"the port imported {reference}")

    # launches: the sum over the runs of the main path (N=10 with both
    # hashers, N=94000 with both, the instruction set at both sizes,
    # N=376000, the node tx, every rank of the sharded proves)
    runs = [*report["golden"].values(), *report["full"].values(),
            *report["allops"].values(), report["large"], report["node"],
            *report["sharded"]]
    kernel_line = {"kernels": [
        {"name": name, "route": route, "source": source, "replaces": replaces,
         "launches": sum(r["launches"][c] for c in counters for r in runs),
         **{key: report["kernels"][name][key]
            for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms")}}
        for name, route, source, replaces, counters in KERNELS]}
    report["card"] = smi
    report["seconds_total"] = time.perf_counter() - started
    log(f"chip_smoke: {report['seconds_total']:.1f} s in all")
    os.makedirs(REPORT_DIR, exist_ok=True)
    with open(os.path.join(REPORT_DIR, "report.json"), "w") as f:
        json.dump(report, f, indent=1)

    print(json.dumps({"proves": {
        r["label"]: {
            "seconds": r["seconds"], "peak_memory_bytes": r["peak_memory_bytes"],
            "host_peak_resident_bytes": r["host_peak_resident_bytes"],
            "launches": r["launches"], "proof_sha256": r["proof_sha256"]}
        for r in runs}}))
    # the programs: per tag at N=94000 (keys, captures, replays, graph
    # nodes, capture seconds), and per prove the launches the host issued
    # and those that graph replays ran, captures and replays
    print(json.dumps({"programs": {
        "card_memory_bytes": torch.cuda.get_device_properties(0).total_memory,
        "by_tag_after_n94000": report["programs_full"],
        "proves": {r["label"]: {
            "host_issued": sum(r["host_launches"].values()),
            "replayed": sum(r["launches"].values())
            - sum(r["host_launches"].values()),
            "captures": r["programs"]["captures"],
            "dropped": r["programs"]["dropped"],
            "replays": r["programs"]["replays"],
            "peak_reserved_bytes": r.get("peak_reserved_bytes"),
            "program_memory_bytes": r.get("program_memory_bytes")}
            for r in runs},
        # K3's launches per prove: by the program tag whose replays ran
        # them, and those the host issued
        "k3_launches_by_tag": {r["label"]: {
            "host": r["host_launches"]["gf_mul"],
            **{tag: t["replayed_kernels"].get("gf_mul", 0)
               for tag, t in r["programs"]["by_tag"].items()}}
            for r in runs}}}))
    print(json.dumps({"ns_per_permutation": {
        name: report["kernels"][name]["ms"] * 1e6 / perms
        for name, perms in report["kernels"]["permutations"].items()}}))
    print(json.dumps({"k6_tables": {
        name: {k: row[k] for k in ("slices", "k6_ms", "class_ms", "ops_ms",
                                   "bound_ms", "bound_by", "share")}
        for name, row in report["kernels"]["k6_tables"].items()}}))
    print(json.dumps(kernel_line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    sys.path.insert(0, ROOT)
    return run()


if __name__ == "__main__":
    sys.exit(main())
