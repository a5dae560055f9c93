#!/usr/bin/env python3
"""Drive the PyTorch port's main path (olavm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card; builds the kernels

Phases, in order; each raises on failure and the script then exits nonzero
without printing a result:

1. environment: the card's name and power limit; build every kernel of
   olavm_tpu_torch/csrc with nvcc (one process per source, in parallel);
2. each kernel against its plain PyTorch version on the card, bit-exact
   (tolerance 0: every value is exact field arithmetic), with CUDA-event
   times of both;
3. parity with the JAX package: the fib-loop fixture at N=10 proved on the
   card must serialize to the sha256 and length of the golden that
   olavm_tpu's host prover produced, and the port's verifier must accept it;
4. full size: the fixture at N=94000 (2^20 CPU rows) through
   run_program_fast -> generate_traces_fast -> prove_with_traces_device ->
   verify_proof, with every kernel's launch count reset just before and read
   just after; each kernel must have been launched.

The last lines are the `kernels` JSON line, the card's nvidia-smi line and
the result line {"ok": true, "device": {...}}. A longer report goes to
chip_smoke_out/report.json.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
REPORT_DIR = os.path.join(ROOT, "chip_smoke_out")
FULL_N = 94000  # 1,034,005 steps -> 2^20 CPU rows
SEED = 0  # random kernel inputs


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

    from olavm_tpu_torch.field import gf
    from olavm_tpu_torch.hash import poseidon as pos
    from olavm_tpu_torch.ntt import ntt as dntt

    def rand(shape):
        return gf.from_u64(rng.integers(0, gf.P, shape, dtype=np.uint64), device)

    results = {}

    def record(name, err, ms, plain_ms, detail):
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "checked": detail}
        log(f"  {name}: max_abs_err={err} kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms ({detail})")
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
    for name, fn, plain in (("gf_mul", gf.mul, gf.mul_plain),
                            ("gf_add", gf.add, gf.add_plain),
                            ("gf_sub", gf.sub, gf.sub_plain)):
        err = max_abs_err(fn(a, b), plain(a, b))
        err = max(err, max_abs_err(fn(grid, grid_t), plain(grid, grid_t)))
        for v in edge:
            s = gf.scalar(int(v), device)
            err = max(err, max_abs_err(fn(a, s), plain(a, s)),
                      max_abs_err(fn(s, b), plain(s, b)))
        ms = cuda_ms(lambda: fn(a, b), 20)
        plain_ms = cuda_ms(lambda: plain(a, b), 5)
        record(name, err, ms, plain_ms,
               "2^24 elements, edge grid, 0-dim operand on each side")
    del a, b

    # K1: forward and inverse at the commit shapes and the smallest sizes;
    # (18, 2^24) is ProgramStark's x8 LDE, the largest n of the main path
    err = 0
    times = {}
    for shape in ((3, 2), (3, 4), (5, 1024), (94, 1 << 20), (16, 1 << 23),
                  (18, 1 << 24)):
        x = rand(shape)
        for inverse in (False, True):
            err = max(err, max_abs_err(dntt._ntt_cuda(x, inverse),
                                       dntt.ntt_plain(x, inverse)))
        if shape == (16, 1 << 23):
            times["ms"] = cuda_ms(lambda: dntt._ntt_cuda(x, False), 5)
            times["plain_ms"] = cuda_ms(lambda: dntt.ntt_plain(x, False), 2)
        del x
    record("ntt", err, times["ms"], times["plain_ms"],
           "forward+inverse at (3,2) (3,4) (5,1024) (94,2^20) (16,2^23) "
           "(18,2^24); times at (16,2^23)")

    # K2: the PoW grind's batch, plus host numpy parity
    st = rand((pos.WIDTH, 1 << 18))
    err = max_abs_err(pos.permute(st), pos.permute_plain(st))
    host = rng.integers(0, gf.P, (64, pos.WIDTH), dtype=np.uint64)
    got = gf.to_u64(pos.permute(gf.from_u64(host.T.copy(), device))).T
    if not np.array_equal(got, pos.permute_np(host)):
        raise AssertionError("poseidon kernel disagrees with permute_np")
    ms = cuda_ms(lambda: pos.permute(st), 20)
    plain_ms = cuda_ms(lambda: pos.permute_plain(st), 3)
    record("poseidon", err, ms, plain_ms,
           "(12,2^18) vs plain; 64 states vs permute_np")
    del st
    torch.cuda.synchronize()
    return results


def time_plain_steps(device, rng) -> dict:
    """Card times of the main-path steps that stay plain torch in this
    version (each becomes a hand-written kernel later)."""
    import numpy as np
    import torch

    from olavm_tpu_torch.field import gf
    from olavm_tpu_torch.field import gfe
    from olavm_tpu_torch.merkle import device as dmerkle
    from olavm_tpu_torch.stark.prover_device import fri_fold

    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 31)))

    def rand(shape):
        # canonical values below 2^62, made on the card
        return torch.randint(0, 1 << 62, shape, generator=gen, device=device)

    out = {}
    lde = rand((94, 1 << 23))
    out["blake3_leaves (94,2^23)"] = cuda_ms(lambda: dmerkle.leaf_digests(lde), 1)
    digs = dmerkle.leaf_digests(lde)
    del lde
    out["blake3_level 2^23->2^22"] = cuda_ms(
        lambda: dmerkle.compress_level(digs), 3)
    del digs
    z = rand((1 << 21,))
    out["prefix_prod 2^21"] = cuda_ms(lambda: gf.prefix_prod(z), 3)
    del z
    coeffs = gfe.GFE(rand((1 << 23,)), rand((1 << 23,)))
    beta = tuple(int(v) for v in rng.integers(0, gf.P, 2, dtype=np.uint64))
    out["fri_fold 2^23 arity 16"] = cuda_ms(lambda: fri_fold(coeffs, beta, 16), 3)
    for k, v in out.items():
        log(f"  plain step {k}: {v:.3f} ms")
    return out


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------


def main_path(n: int, device, workdir: str):
    """run_program_fast -> generate_traces_fast -> prove_with_traces_device
    -> verify_proof on the fib-loop fixture; returns (proof bytes, report)."""
    import torch

    from olavm_tpu_torch.runtime.harness import run_program_fast
    from olavm_tpu_torch.stark.config import StarkConfig
    from olavm_tpu_torch.stark.proof import PublicValues
    from olavm_tpu_torch.stark.prover_device import (
        TimingTree,
        prove_with_traces_device,
    )
    from olavm_tpu_torch.stark.serialization import serialize_all_proof
    from olavm_tpu_torch.stark.verifier import verify_proof
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
    shapes = [list(t.shape) for t in traces]
    pre, post = program.trace.start_end_roots
    public_values = PublicValues(tuple(pre), tuple(post), 0)
    config = StarkConfig.standard_fast_config()

    torch.cuda.reset_peak_memory_stats()
    timing = TimingTree()
    t0 = time.perf_counter()
    proof = prove_with_traces_device(ola, config, traces,
                                     public_values=public_values,
                                     timing=timing, device=device)
    torch.cuda.synchronize()
    seconds["prove"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    verify_proof(ola, proof, config)
    seconds["verify"] = time.perf_counter() - t0

    data = serialize_all_proof(proof)
    report = {
        "N": n,
        "steps": int(fast_run.cpu.shape[0]),
        "table_shapes": shapes,
        "public_values": {"pre_root": [int(x) for x in pre],
                          "post_root": [int(x) for x in post]},
        "seconds": seconds,
        "peak_memory_bytes": int(peak),
        "proof_bytes": len(data),
        "proof_sha256": hashlib.sha256(data).hexdigest(),
        "prove_scopes": [[d, name, s] for d, name, s in timing.records],
    }
    return data, report


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
)


def run() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
        return 2
    jax_before = {m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")}

    from olavm_tpu_torch import kernels

    device = torch.device("cuda", 0)
    report = {}
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")

    # 1. environment and build
    smi = nvidia_smi()
    log(f"[1] card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    built = kernels.build(force=True)
    report["build_seconds"] = time.perf_counter() - t0
    log(f"[1] built {sorted(built)} in {report['build_seconds']:.1f} s")

    # 2. kernels against their plain versions
    rng = np.random.default_rng(SEED)
    log("[2] kernels against their plain versions")
    report["kernels"] = check_kernels(device, rng)
    report["plain_steps_ms"] = time_plain_steps(device, rng)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as workdir:
        # 3. parity with the JAX package's golden
        with open(os.path.join(FIXTURES, "fib_loop_golden.json")) as f:
            golden = json.load(f)
        log(f"[3] golden parity at N={golden['N']}")
        _, small = main_path(golden["N"], device, workdir)
        for key in ("public_values", "proof_sha256", "proof_bytes"):
            if small[key] != golden[key]:
                raise AssertionError(
                    f"N={golden['N']} proof {key} {small[key]!r} differs from "
                    f"the golden {golden[key]!r}")
        log(f"    proof {small['proof_bytes']} bytes, sha256 matches; verified "
            f"({small['seconds']})")
        report["golden"] = small
        torch.cuda.empty_cache()

        # 4. the main path at full size, counting launches
        log(f"[4] main path at N={FULL_N}")
        kernels.reset_launches()
        _, full = main_path(FULL_N, device, workdir)
        launches = dict(kernels.LAUNCHES)
        full["launches"] = launches
        report["full"] = full
        log(f"    shapes {full['table_shapes']}")
        log(f"    seconds {full['seconds']}, peak "
            f"{full['peak_memory_bytes'] / 2**30:.2f} GiB, launches {launches}")
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the main path: "
                                 f"{missing}")

    jax_after = {m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")}
    if jax_after - jax_before:
        raise AssertionError(f"the port imported {sorted(jax_after - jax_before)}")

    kernel_line = {"kernels": [
        {"name": name, "route": route, "source": source, "replaces": replaces,
         "launches": sum(launches[c] for c in counters),
         "max_abs_err": report["kernels"][name]["max_abs_err"],
         "ms": report["kernels"][name]["ms"],
         "plain_ms": report["kernels"][name]["plain_ms"]}
        for name, route, source, replaces, counters in KERNELS]}
    report["card"] = smi
    os.makedirs(REPORT_DIR, exist_ok=True)
    with open(os.path.join(REPORT_DIR, "report.json"), "w") as f:
        json.dump(report, f, indent=1)

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
