#!/usr/bin/env python3
"""Time the NTT (K1), Poseidon, absorb, evaluation (K5), inversion (K7),
scan (K8), FRI composition (K9, K10), CTL row combination (K11), FRI
fold (K12) and power table (K13) kernels of this checkout at the main
path's shapes, and count the SASS instructions of their kernels.

    python3 chip_kernel_times.py                    # all; one CUDA card, nvcc
    python3 chip_kernel_times.py --kernel poseidon  # libposeidon's kernels only
    python3 chip_kernel_times.py --kernel absorb    # the streamed commit's
    python3 chip_kernel_times.py --kernel eval      # K5
    python3 chip_kernel_times.py --kernel quotient  # the quotient's classes
    python3 chip_kernel_times.py --kernel inv       # K7, inversion
    python3 chip_kernel_times.py --kernel scan      # K8, the scan
    python3 chip_kernel_times.py --kernel fri       # K9, K10: FRI composition
    python3 chip_kernel_times.py --kernel ctl       # K11: CTL row combination
    python3 chip_kernel_times.py --kernel fold      # K12: the FRI fold
    python3 chip_kernel_times.py --kernel powers    # K13: power tables

Builds each kernel's source in olavm_tpu_torch/csrc, times it with CUDA events
after a warm-up (chip_smoke.cuda_ms), and prints one JSON object per source
{"root": ..., "kernel": ..., "card": ..., "ptxas": [...], "sass": {...},
"ms": {shape: milliseconds}}. For libposeidon, "ms" holds K2 at (12, n)
states ("12x2^18"), the leaf sponge at (C, n) columns ("leaves 94x2^23") and
one tree level of n digests ("level 2^23"), and "ns_per_permutation" each
time over its permutations (ceil(C / 8) per leaf, one per parent). For
`absorb`, "ms" holds gl_blake3_absorb and gl_poseidon_absorb on one (W, n)
block of LDE columns with the states an earlier block left ("blake3
16x2^23"), and "ns_per_permutation" the Poseidon ones; for `eval`, K5 on (C,
n) coefficients at k points ("94x2^20 at 28"; every shape of an N=94000
prove and a few more), "device_ms" the same calls' kernel time from
torch.profiler (below ~0.05 ms a call, CUDA events time the host that
issues it), and "ms_per_column" at (C, 2^20) x 28 for C = 1, 8 and 94. The whole disassembly of each
built library goes to chip_smoke_out/<source>.sass.
For `quotient`, "elementwise" holds K3, add and sub per launch on 1-D
operands of 1 to 2^21 elements (CUDA-event ms of back-to-back calls,
device ms from torch.profiler, the bound), and "classes" one quotient
class of each table at N=94000's shapes and K=512's PoseidonStark and
StorageAccessStark (chip_smoke.QUOTIENT_SHAPES) replayed as the prover's
program, op by op and through K6: ms per replay, device ms, and the
launches of one replay; and "k6", K6 alone on each of those classes (ptxas
registers and spills per slice, warps an SM, scratch columns, operations
run against constraint_tape.required_ops, ms against its bound), each
checked against quotient_class_ops, with the SWEEP of its slice budget and
live values beside the kept constants.
For `inv` and `scan`, "rows" holds K7 (base field and extension) and K8
(inclusive and exclusive; single rows and (rows, n) arrays, those also in
place) at the main path's sizes: CUDA-event ms of
back-to-back calls, device ms (torch.profiler; K8's with its scratch's
fill), the bound (chip_smoke.bound) and its share, and the device ms of the
K3 chain each replaced on the same inputs (inversion by square and multiply
on gf.mul, 125 launches, 131 with the norm; the Hillis-Steele scan, a fill,
a cat and a K3 launch a step).
For `fri`, "rows" holds K9 (fri_combine) and K10 (fri_quotient) at the FRI
composition's shapes of CpuStark at N=94000 and N=376000 and of
PoseidonStark at K=512 (chip_smoke.fri_case, three batches): CUDA-event ms,
device ms, the bound (chip_smoke.fri_combine_bound, fri_quotient_bound) and
its share, each checked against its plain version; and per shape the whole
composition (fri_composition: K9, K1, K10, K1 inverse, the coset scaling)
in device ms beside the op-by-op chain it replaced (fri_composition_ops),
with the launches and the peak bytes allocated of one call of each.
For `ctl` and `fold`, "rows" holds K11 on the widest view of a table at
its rows (chip_smoke.widest_view, ctl_case) and K12 at (log2 of the
coefficients, arity) (chip_smoke.fold_case): CUDA-event ms, device ms, the
bound (chip_smoke.ctl_combine_bound, fri_fold_bound) and its share,
whether it equals its plain version, and the device ms and launches of the
op-by-op chain each replaced on the same inputs (ctl_kernels.
ctl_combine_ops; fri_kernels.fri_fold_ops).
For `fri`, "k10" also gives each instantiation of K10 (gl_fri_quotient's
quotient_kernel<B>) its ptxas registers and spills, its SASS instructions
and loops, and `sass_per_point`: the instructions a thread runs (each loop
of PAIR_LOOP_MIN instructions or more, a pass over the pairs of points,
counted QUOTIENT_PAIRS times where fri.cu has QUOTIENT_PAIRS; shorter
loops once; the whole unrolled kernel where it has QUOTIENT_CHUNK) over
the points a thread takes.
For `powers`, "rows" holds K13 at every table degree of an N=94000 prove
and N=376000's largest (chip_smoke.POWERS_NS): the extension table (the
openings' extpows programs) and the base field's (28, n) query-point rows:
CUDA-event ms, device ms, the bound (chip_smoke.powers_bound) and its
share, whether it equals its plain version, and the device ms and launches
of the log-doubling chain it replaced (chip_smoke.ext_powers_chain,
base_powers_chain) on the same inputs.
`sass` holds, for every __global__ function of the built library, its
instruction count (cuobjdump -sass, NOPs left out) and each loop's span and
count (a branch back to an earlier address); and, under
`products`, the counts of this checkout's field product less a probe that
only loads and stores: `u64_product` is the 64-bit `a * b` with
`__umul64hi`, `mul_wide` the 64x64->128 product of goldilocks.cuh, `mul`
that product reduced (null in a checkout without `gl::mul_wide`).
To compare two versions of a kernel, unpack each checkout into a directory of
its own, put this script in each, and run each copy in turns (a b b a) within
one call on one card.
"""

from __future__ import annotations

import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = {
    "ntt": ((16, 1 << 23), (18, 1 << 24), (16, 1 << 21), (16, 1 << 20),
            (16, 1 << 17), (3, 1 << 13), (134, 1024), (53, 16)),
    "poseidon": ((12, 1 << 18), (12, 1 << 20), (12, 1 << 14)),
    # absorbed blocks (W, n): the streamed commit's 16 columns at the
    # 2^20- and 2^22-row CpuStark LDEs, and a last block of 8
    "absorb": ((16, 1 << 23), (16, 1 << 25), (8, 1 << 23)),
    # (C, n, k) besides every shape of an N=94000 prove (chip_smoke.K5_SHAPES):
    # the FRI query leaves of the CpuStark trace at 2^22 rows, and C = 1 and
    # 8 columns at 2^20 x 28 for the time per column
    "eval": ((94, 1 << 22, 28), (1, 1 << 20, 28), (8, 1 << 20, 28)),
    # K3, add and sub on 1-D operands of the sizes the quotient's launches
    # have (the one-element challenge products, the small tables' columns,
    # the large tables' columns); the tables' classes: chip_smoke.QUOTIENT_SHAPES
    "quotient": (1, 2, 4, 256, 1024, 1 << 17, 1 << 18, 1 << 19, 1 << 20,
                 1 << 21),
    # K7: the permutation Zs' traces (BitwiseStark 2^18, RangeCheckStark
    # 2^19, ProgramStark 2^21 at N=94000) in the base field, the FRI
    # composition's LDEs (2^20 to 2^24) in the extension
    "inv": ((1 << 18, 1 << 19, 1 << 21, 1 << 24),
            (1 << 20, 1 << 21, 1 << 22, 1 << 23, 1 << 24)),
    # K8, (rows, n) of one launch: the CTL and permutation Zs' lengths at
    # N=94000 and above as single rows, and the tables' Zs in one launch
    # (chip_smoke.SCAN_SHAPES: CpuStark's 78 Zs, a group of 26 of them,
    # BitwiseStark's 8 permutation batches, ProgramStark's 4 Zs)
    "scan": ((1, 1 << 10), (1, 1 << 17), (1, 1 << 18), (1, 1 << 19),
             (1, 1 << 20), (1, 1 << 21), (1, 1 << 22), (1, 1 << 24),
             (78, 1 << 20), (26, 1 << 20), (8, 1 << 18), (4, 1 << 21)),
    # K9, K10: (trace, Z, quotient) widths, permutation Zs, log2 rows
    "fri": {"N=94000 CpuStark": ((94, 78, 12), 0, 20),
            "K=512 PoseidonStark": ((134, 6, 12), 0, 20),
            "N=376000 CpuStark": ((94, 78, 12), 0, 22)},
    # K11: (OlaStark table, log2 rows) of the widest view timed: CpuStark at
    # N=94000 and N=376000, ProgramStark at N=94000, PoseidonStark at N=94000
    # and K=512, MemoryStark at N=94000
    "ctl": {"CpuStark 2^20": (0, 20), "CpuStark 2^22": (0, 22),
            "ProgramStark 2^21": (10, 21), "PoseidonStark 2^10": (5, 10),
            "PoseidonStark 2^20": (5, 20), "MemoryStark 2^18": (1, 18)},
    # K12: (log2 coefficients, arity): the folds of N=94000's FRI proofs
    # (ProgramStark's 2^24 LDE, CpuStark's 2^23, ...) and the arities the
    # kernel takes
    "fold": ((24, 16), (23, 16), (22, 16), (20, 16), (16, 16), (12, 16),
             (24, 2), (24, 4), (24, 8)),
    # K13: the table degrees of N=94000 and N=376000 (chip_smoke.POWERS_NS)
    "powers": None,
}
# the csrc sources that hold each choice's kernels
LIBS = {"ntt": ("ntt",), "poseidon": ("poseidon",),
        "absorb": ("blake3", "poseidon"), "eval": ("eval",),
        "quotient": ("gf_mul", "ntt", "quotient"),
        "inv": ("gf_inv", "gf_mul"), "scan": ("scan", "gf_mul"),
        "fri": ("fri", "ntt", "quotient", "gf_mul", "gf_inv"),
        "ctl": ("ctl", "gf_mul"), "fold": ("fri", "gf_mul"),
        "powers": ("powers", "gf_mul")}
# libposeidon's Merkle kernels: leaves as (C, n) columns (the CpuStark LDE,
# the FRI trees' arity-16 extension leaves, one permutation per leaf) and
# tree levels of n digests
LEAF_SHAPES = ((94, 1 << 23), (32, 1 << 20), (8, 1 << 23))
LEVEL_SHAPES = (1 << 23, 1 << 16)

# product probes: one thread per pair, two words out
PROBES = r"""
#include "goldilocks.cuh"
#define PROBE(name, body)                                              \
  extern "C" __global__ void name(const uint64_t* a, const uint64_t* b, \
                                  uint64_t* o) {                       \
    const int i = blockIdx.x * blockDim.x + threadIdx.x;               \
    const uint64_t x = a[i], y = b[i];                                 \
    body                                                               \
  }
PROBE(probe_base, o[2 * i] = x; o[2 * i + 1] = y;)
PROBE(probe_u64_product, o[2 * i] = x * y; o[2 * i + 1] = __umul64hi(x, y);)
PROBE(probe_mul_wide, const gl::u128 w = gl::mul_wide(x, y);
      o[2 * i] = w.lo; o[2 * i + 1] = w.hi;)
PROBE(probe_mul, o[2 * i] = gl::mul(x, y); o[2 * i + 1] = y;)
"""

# SASS instructions from which a loop of K10 is taken for a loop over its
# pairs of points
PAIR_LOOP_MIN = 200
_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_REGS = re.compile(r"Used (\d+) registers")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_INSTR = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(.*?);")
_FUNC = re.compile(r"^\s+Function : (\S+)")
_BRA = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+)")


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)


def disassemble(path: str) -> str:
    """cuobjdump -sass of a shared library or cubin."""
    return subprocess.run([_tool("cuobjdump"), "-sass", path], check=True,
                          capture_output=True, text=True).stdout


def sass_counts(text: str) -> dict:
    """{function: {"instructions": n, "loops": [[start, end, n], ...]}} of a
    disassembly."""
    funcs, name, instrs = {}, None, []

    def close():
        if name is not None:
            loops = []
            for a, op in instrs:
                m = _BRA.search(op)
                if m and int(m.group(1), 16) < a:
                    target = int(m.group(1), 16)
                    n = sum(1 for x, _ in instrs if target <= x <= a)
                    loops.append([hex(target), hex(a), n])
            funcs[name] = {"instructions": len(instrs), "loops": loops}

    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            close()
            name, instrs = m.group(1), []
            continue
        m = _INSTR.match(line)
        if m and name is not None:
            op = m.group(2).strip()
            if not op.startswith("NOP"):
                instrs.append((int(m.group(1), 16), op))
    close()
    return funcs


def product_counts(csrc: str) -> dict | None:
    """SASS instructions of the product probes, less the load/store probe;
    None where goldilocks.cuh has no `gl::mul_wide` and the probes do not
    compile."""
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "probes.cu")
        with open(src, "w") as f:
            f.write(PROBES)
        cubin = os.path.join(d, "probes.cubin")
        built = subprocess.run(
            [_tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-cubin", "-I", csrc, "-o", cubin, src],
            capture_output=True)
        if built.returncode != 0:
            return None
        counts = {k: v["instructions"]
                  for k, v in sass_counts(disassemble(cubin)).items()}
    base = counts.pop("probe_base")
    return {k.removeprefix("probe_"): v - base for k, v in counts.items()}


def ptxas_entries(log: str) -> dict:
    """{entry: {"registers", "spill_stores", "spill_loads"}} of a ptxas -v
    log."""
    out, name = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = _REGS.search(line)
        if m:
            out[name]["registers"] = int(m.group(1))
        m = _SPILLS.search(line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
    return out


def k10_counts(sass: dict, log: str, fri_source: str) -> dict:
    """K10's instantiations: ptxas registers and spills, SASS instructions
    and loops, and the instructions a thread runs a point (module
    docstring)."""
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (\w+) = (\d+);", fri_source)}
    if "QUOTIENT_PAIRS" in consts:
        trips, points = consts["QUOTIENT_PAIRS"], 2 * consts["QUOTIENT_PAIRS"]
    else:
        trips, points = 1, consts["QUOTIENT_CHUNK"]
    regs = ptxas_entries(log)
    out = {}
    for name, st in sass.items():
        if "quotient_kernel" not in name:
            continue
        # the pair loops hold a point's body (hundreds of instructions);
        # a short loop (a squaring chain) is counted once
        run = st["instructions"] + sum(n * (trips - 1)
                                       for _, _, n in st["loops"]
                                       if n >= PAIR_LOOP_MIN)
        out[name] = {**regs.get(name, {}), "instructions": st["instructions"],
                     "loops": st["loops"], "points_per_thread": points,
                     "sass_per_point": run / points}
    return out


def main() -> int:
    sys.path.insert(0, ROOT)
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(SHAPES),
                    help="time only this source's kernels (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from olavm_tpu_torch import kernels

    names = [args.kernel] if args.kernel else sorted(SHAPES)
    libs = sorted({lib for name in names for lib in LIBS[name]})
    kernels.build(libs, force=True)
    products = product_counts(str(kernels.CSRC))
    counts = {}
    os.makedirs(chip_smoke.REPORT_DIR, exist_ok=True)
    for lib in libs:
        sass = disassemble(str(kernels._lib_path(lib)))
        with open(os.path.join(chip_smoke.REPORT_DIR, f"{lib}.sass"), "w") as f:
            f.write(sass)
        counts[lib] = sass_counts(sass)
    for name in names:
        result = {
            "root": ROOT, "kernel": name, "card": chip_smoke.nvidia_smi(),
            "ptxas": [ln.strip() for lib in LIBS[name]
                      for ln in kernels.BUILD_LOG[lib].splitlines()
                      if "registers" in ln or "spill" in ln],
            "sass": {"kernels": {k: v for lib in LIBS[name]
                                 for k, v in counts[lib].items()},
                     "products": products},
            **time_kernel(name, chip_smoke.cuda_ms)}
        if name == "fri":
            result["k10"] = k10_counts(
                counts["fri"], kernels.BUILD_LOG["fri"],
                (kernels.CSRC / "fri.cu").read_text())
        print(json.dumps(result))
    return 0


def _log2(n: int) -> str:
    return f"2^{n.bit_length() - 1}"


def time_kernel(kernel: str, cuda_ms) -> dict:
    """{"ms": {shape: ms}} and, for libposeidon, {"ns_per_permutation":
    {shape: ns}}."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    if kernel == "absorb":
        return time_absorb(gen, cuda_ms)
    if kernel == "eval":
        return time_eval(gen, cuda_ms)
    if kernel == "quotient":
        return time_quotient(gen, cuda_ms)
    if kernel in ("inv", "scan"):
        return time_inv_scan(kernel, gen, cuda_ms)
    if kernel == "fri":
        return time_fri(cuda_ms)
    if kernel in ("ctl", "fold"):
        return time_ctl_fold(kernel, cuda_ms)
    if kernel == "powers":
        return time_powers(gen, cuda_ms)
    if kernel == "ntt":
        from olavm_tpu_torch.ntt import ntt as dntt

        def call(x):
            return dntt._ntt_cuda(x, False)
    else:
        from olavm_tpu_torch.hash import poseidon as pos

        call = pos.permute
    ms, perms = {}, {}
    for shape in SHAPES[kernel]:
        x = torch.randint(0, 1 << 62, shape, generator=gen, device="cuda")
        reps = 10 if shape[0] * shape[1] >= 1 << 24 else 200
        key = f"{shape[0]}x{_log2(shape[1])}"
        ms[key] = cuda_ms(lambda: call(x), reps)
        perms[key] = shape[1]
        del x
    if kernel == "poseidon":
        for C, n in LEAF_SHAPES:
            x = torch.randint(0, 1 << 62, (C, n), generator=gen, device="cuda")
            key = f"leaves {C}x{_log2(n)}"
            ms[key] = cuda_ms(lambda: pos.leaves(x), 3 if C * n >= 1 << 28 else 10)
            perms[key] = -(-C // pos.RATE) * n
            del x
        for n in LEVEL_SHAPES:
            x = torch.randint(0, 1 << 32, (8, n), generator=gen, device="cuda")
            key = f"level {_log2(n)}"
            ms[key] = cuda_ms(lambda: pos.level(x), 10 if n >= 1 << 20 else 200)
            perms[key] = n // 2
            del x
    if kernel == "ntt":
        return {"ms": ms}
    return {"ms": ms, "ns_per_permutation": {
        k: v * 1e6 / perms[k] for k, v in ms.items()}}


def time_inv_scan(kernel: str, gen, cuda_ms) -> dict:
    """{"rows": {name: {"ms", "device_ms", "bound_ms", "bound_by", "share",
    "k3_chain_device_ms"}}} for K7 or K8 at SHAPES[kernel]."""
    import torch

    import chip_smoke
    from olavm_tpu_torch.field import gf, gfe

    def k3_inv(x):
        return gf.exp_const(x, gf.P - 2)

    def k3_ext_inv(a):
        norm = gf.sub(gf.mul(a.re, a.re), gf.mul_u32(gf.mul(a.im, a.im), 7))
        ninv = k3_inv(norm)
        return gf.mul(a.re, ninv), gf.mul(gf.neg(a.im), ninv)

    def k3_scan(x, exclusive):
        y, d = x, 1
        while d < x.shape[-1]:
            y = gf.mul(y, torch.cat([torch.ones_like(y[..., :d]),
                                     y[..., :-d]], dim=-1))
            d <<= 1
        if exclusive:
            return torch.cat([torch.ones_like(y[..., :1]), y[..., :-1]],
                             dim=-1)
        return y

    def rand(*shape):
        return torch.randint(0, 1 << 62, shape, generator=gen, device="cuda")

    # the scan in place where gf.prefix_prod takes out= (a checkout before
    # it took out= times the scan into a new array only)
    in_place = "out" in inspect.signature(gf.prefix_prod).parameters

    cases = []  # (name, call, the K3 chain, bytes, products, sums)
    if kernel == "inv":
        base, ext = SHAPES["inv"]
        for n in base:
            x = rand(n)
            cases.append((f"base {_log2(n)}", lambda x=x: gf.inv(x),
                          lambda x=x: k3_inv(x), 16 * n,
                          chip_smoke.INV_PRODUCTS * n, 0))
        for n in ext:
            a = gfe.GFE(rand(n), rand(n))
            cases.append((f"ext {_log2(n)}", lambda a=a: gfe.inv(a),
                          lambda a=a: k3_ext_inv(a), 32 * n,
                          chip_smoke.EXT_INV_PRODUCTS * n, 2 * n))
    else:
        for rows, n in SHAPES["scan"]:
            x = rand(rows, n) if rows > 1 else rand(n)
            shape = f"{rows}x{_log2(n)}" if rows > 1 else _log2(n)
            for ex in (False, True):
                form = "exclusive" if ex else "inclusive"
                cases.append((f"{form} {shape}",
                              lambda x=x, ex=ex: gf.prefix_prod(x, exclusive=ex),
                              lambda x=x, ex=ex: k3_scan(x, ex),
                              16 * rows * n,
                              chip_smoke.SCAN_PRODUCTS * rows * n, 0))
                if in_place and rows > 1:
                    cases.append((f"{form} {shape} in place",
                                  lambda x=x, ex=ex: gf.prefix_prod(
                                      x, exclusive=ex, out=x),
                                  None, 16 * rows * n,
                                  chip_smoke.SCAN_PRODUCTS * rows * n, 0))
    rows = {}
    for name, call, chain, nbytes, products, sums in cases:
        least = chip_smoke.bound(
            nbytes, products * chip_smoke.OPS_MUL + sums * chip_smoke.OPS_ADD,
            products * chip_smoke.MUL_PRODUCT)
        dev_ms = chip_smoke.device_ms(call, 20)
        rows[name] = {"ms": cuda_ms(call, 20), "device_ms": dev_ms,
                      "bound_ms": least["bound_ms"],
                      "bound_by": least["bound_by"],
                      "share": least["bound_ms"] / dev_ms,
                      "k3_chain_device_ms": (chip_smoke.device_ms(chain, 3)
                                             if chain else None)}
    return {"rows": rows}


def time_fri(cuda_ms) -> dict:
    """{"rows": {name: {"ms", "device_ms", "bound_ms", "bound_by", "share",
    "plain_equal"}}, "composition": {shape: {"device_ms", "ops_device_ms",
    "launches", "ops_launches", "peak_bytes", "ops_peak_bytes"}}} for K9 and
    K10 at SHAPES["fri"]; the peaks are the bytes allocated above what was
    held before one call."""
    import numpy as np
    import torch

    import chip_smoke
    from olavm_tpu_torch import kernels
    from olavm_tpu_torch.ntt import ntt as dntt
    from olavm_tpu_torch.stark import fri_kernels as fk
    from olavm_tpu_torch.stark import prover_device as tpd

    rng = np.random.default_rng(0)
    rate = chip_smoke.FRI_RATE_BITS
    rows, comp = {}, {}

    def launches(call):
        kernels.reset_launches()
        call()
        torch.cuda.synchronize()
        return {k: v for k, v in kernels.LAUNCHES.items() if v}

    for shape, (widths, num_perm, log_n) in SHAPES["fri"].items():
        coeffs, bank, plan = chip_smoke.fri_case(widths, num_perm, 1 << log_n,
                                                 rng, "cuda")
        combined = fk.fri_combine(coeffs, bank, plan, rate)
        lde = dntt.ntt(combined)
        for name, call, plain, least in (
                ("fri_combine", lambda: fk.fri_combine(coeffs, bank, plan, rate),
                 lambda: fk.fri_combine_plain(coeffs, bank, plan, rate),
                 chip_smoke.fri_combine_bound(plan, 1 << log_n, rate)),
                ("fri_quotient", lambda: fk.fri_quotient(lde, bank, plan),
                 lambda: fk.fri_quotient_plain(lde, bank, plan),
                 chip_smoke.fri_quotient_bound(len(plan), lde.shape[-1]))):
            equal = torch.equal(call(), plain())
            dev_ms = chip_smoke.device_ms(call, 10)
            rows[f"{name} {shape}"] = {
                "ms": cuda_ms(call, 10), "device_ms": dev_ms,
                "bound_ms": least["bound_ms"], "bound_by": least["bound_by"],
                "share": least["bound_ms"] / dev_ms, "plain_equal": equal}
        del combined, lde
        torch.cuda.empty_cache()

        def kernels_call():
            return tpd.fri_composition(*coeffs, bank, plan=plan, rate_bits=rate)

        def ops_call():
            return tpd.fri_composition_ops(*coeffs, bank, plan=plan,
                                           rate_bits=rate)

        comp[shape] = {"device_ms": chip_smoke.device_ms(kernels_call, 5),
                       "ops_device_ms": chip_smoke.device_ms(ops_call, 2),
                       "launches": launches(kernels_call),
                       "ops_launches": launches(ops_call),
                       "peak_bytes": None, "ops_peak_bytes": None}
        for key, call in (("peak_bytes", kernels_call),
                          ("ops_peak_bytes", ops_call)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            call()
            torch.cuda.synchronize()
            comp[shape][key] = torch.cuda.max_memory_allocated() - base
        del coeffs, bank
        torch.cuda.empty_cache()
    return {"rows": rows, "composition": comp}


def time_ctl_fold(kernel: str, cuda_ms) -> dict:
    """{"rows": {shape: {"ms", "device_ms", "bound_ms", "bound_by", "share",
    "plain_equal", "launches", "chain_device_ms", "chain_launches"}}} for
    K11 or K12 at SHAPES[kernel], the chain each replaced beside it."""
    import numpy as np
    import torch

    import chip_smoke
    from olavm_tpu_torch import kernels
    from olavm_tpu_torch.stark import ctl_kernels as ck
    from olavm_tpu_torch.stark import fri_kernels as fk

    rng = np.random.default_rng(0)

    def launches(call):
        kernels.reset_launches()
        call()
        torch.cuda.synchronize()
        return {k: v for k, v in kernels.LAUNCHES.items() if v}

    cases = []  # (shape, kernel call, plain call, chain call, bound)
    if kernel == "ctl":
        for shape, (table, log_n) in SHAPES["ctl"].items():
            view = chip_smoke.widest_view(table)
            trace, bank, on = chip_smoke.ctl_case(view, 1 << log_n, rng,
                                                  "cuda")
            args = (trace, view.columns, view.filter_column, bank)
            cases.append((
                f"{shape}, {len(view.columns)} columns",
                lambda a=args: ck.ctl_combine(*a),
                lambda a=args: ck.ctl_combine_plain(*a),
                lambda a=args: ck.ctl_combine_ops(*a),
                chip_smoke.ctl_combine_bound(view, 1 << log_n, on)))
    else:
        for log_m, arity in SHAPES["fold"]:
            args = chip_smoke.fold_case(log_m, arity, rng, "cuda")
            cases.append((
                f"2^{log_m} arity {arity}",
                lambda a=args: fk.fri_fold(*a),
                lambda a=args: fk.fri_fold_plain(*a),
                lambda a=args: fk.fri_fold_ops(*a),
                chip_smoke.fri_fold_bound(1 << log_m, arity)))
    rows = {}
    for shape, call, plain, chain, least in cases:
        dev_ms = chip_smoke.device_ms(call, 20)
        rows[shape] = {
            "ms": cuda_ms(call, 20), "device_ms": dev_ms,
            "bound_ms": least["bound_ms"], "bound_by": least["bound_by"],
            "share": least["bound_ms"] / dev_ms,
            "plain_equal": torch.equal(call(), plain()),
            "launches": launches(call),
            "chain_device_ms": chip_smoke.device_ms(chain, 3),
            "chain_launches": launches(chain)}
        print(json.dumps({kernel: shape, **rows[shape]}), flush=True)
    del cases
    torch.cuda.empty_cache()
    return {"rows": rows}


def time_powers(gen, cuda_ms) -> dict:
    """{"rows": {shape: {"ms", "device_ms", "bound_ms", "bound_by", "share",
    "plain_equal", "launches", "chain_device_ms", "chain_launches"}}} for
    K13 at chip_smoke.POWERS_NS, both fields."""
    import torch

    import chip_smoke
    from olavm_tpu_torch import kernels
    from olavm_tpu_torch.field import gf, gfe

    def launches(call):
        kernels.reset_launches()
        call()
        torch.cuda.synchronize()
        return sum(kernels.LAUNCHES.values())

    rows = {}
    k = chip_smoke.QUERY_ROUNDS
    for n in chip_smoke.POWERS_NS:
        zb = torch.randint(0, 1 << 62, (2,), generator=gen, device="cuda")
        bases = torch.randint(0, 1 << 62, (k,), generator=gen, device="cuda")
        z = gfe.GFE(zb[0], zb[1])
        for shape, call, plain, chain, least in (
                (f"ext {_log2(n)}", lambda: gfe.powers_stacked(z, n),
                 lambda: torch.stack(list(gfe.powers_plain(z, n))),
                 lambda: chip_smoke.ext_powers_chain(zb, n),
                 chip_smoke.powers_bound(1, n, ext=True)),
                (f"base {k}x{_log2(n)}", lambda: gf.powers(bases, n),
                 lambda: gf.powers_plain(bases, n),
                 lambda: chip_smoke.base_powers_chain(bases, n),
                 chip_smoke.powers_bound(k, n))):
            reps = 50 if n >= 1 << 17 else 200
            dev_ms = chip_smoke.device_ms(call, reps)
            rows[shape] = {
                "ms": cuda_ms(call, reps), "device_ms": dev_ms,
                "bound_ms": least["bound_ms"], "bound_by": least["bound_by"],
                "share": least["bound_ms"] / dev_ms,
                "plain_equal": torch.equal(call(), plain()),
                "launches": launches(call),
                "chain_device_ms": chip_smoke.device_ms(chain, 3),
                "chain_launches": launches(chain)}
        torch.cuda.empty_cache()
    return {"rows": rows}


def time_absorb(gen, cuda_ms) -> dict:
    """The absorb kernels on blocks of SHAPES["absorb"], each on the states
    an earlier block left (written in place, so the calls chain)."""
    import torch

    from olavm_tpu_torch.hash import poseidon as pos
    from olavm_tpu_torch.merkle import device as dmerkle

    ms, perms = {}, {}
    for W, n in SHAPES["absorb"]:
        block = torch.randint(0, 1 << 62, (W, n), generator=gen, device="cuda")
        # blake3: message blocks 2 and 3 (W = 16) or 2 of a 32-column leaf
        meta = [m[2:2 + W // 8] for m in dmerkle.absorb_block_meta(32)]
        state = torch.randint(0, 1 << 32, (8, n), generator=gen, device="cuda")
        key = f"{W}x{_log2(n)}"
        ms[f"blake3 {key}"] = cuda_ms(
            lambda: dmerkle.blake3_absorb(block, state, None, *meta), 10)
        del state
        state = torch.randint(0, 1 << 62, (pos.WIDTH, n), generator=gen,
                              device="cuda")
        ms[f"poseidon {key}"] = cuda_ms(lambda: pos.absorb(block, state, False),
                                        5)
        perms[f"poseidon {key}"] = -(-W // pos.RATE) * n
        del block, state
    return {"ms": ms, "ns_per_permutation": {
        k: ms[k] * 1e6 / v for k, v in perms.items()}}


def time_eval(gen, cuda_ms) -> dict:
    """K5 on (C, n) coefficients at k points: every shape of an N=94000
    prove and those of SHAPES["eval"]; its time per column at (C, 2^20) x
    28."""
    import torch

    import chip_smoke
    from olavm_tpu_torch.field import gf

    ms, device_ms = {}, {}
    for C, n, k in sorted({*chip_smoke.K5_SHAPES, *SHAPES["eval"]}):
        coeffs = torch.randint(0, 1 << 62, (C, n), generator=gen, device="cuda")
        pows = torch.randint(0, 1 << 62, (k, n), generator=gen, device="cuda")
        key = f"{C}x{_log2(n)} at {k}"
        ms[key] = cuda_ms(lambda: gf.eval_points(coeffs, pows),
                          10 if C * n >= 1 << 22 else 200)
        device_ms[key] = chip_smoke.device_ms(lambda: gf.eval_points(coeffs, pows), 10)
        del coeffs, pows
    return {"ms": ms, "device_ms": device_ms, "ms_per_column": {
        C: ms[f"{C}x2^20 at 28"] / C for C in (1, 8, 94)}}


def time_quotient(gen, cuda_ms) -> dict:
    """K3, add and sub per launch at SHAPES["quotient"] sizes, each with its
    bound (chip_smoke.bound); then one quotient class of each table of
    chip_smoke.QUOTIENT_SHAPES as the prover runs it, a program replay
    (the class's coset FFTs and constraints, its inputs copied into the
    graph's buffers and its output out), op by op (quotient_class_ops,
    "ops") and through K6 ("k6"): CUDA-event ms per replay, the device ms
    of its kernels and copies (torch.profiler), and the launches of one
    replay by kernel."""
    import functools

    import numpy as np
    import torch

    import chip_smoke
    from olavm_tpu_torch import kernels
    from olavm_tpu_torch.field import gf
    from olavm_tpu_torch.stark import prover_device as tpd
    from olavm_tpu_torch.utils import jitcache

    binops = {"gf_mul": (gf.mul, chip_smoke.OPS_MUL, chip_smoke.MUL_PRODUCT),
              "gf_add": (gf.add, chip_smoke.OPS_ADD, 0),
              "gf_sub": (gf.sub, chip_smoke.OPS_ADD, 0)}
    elementwise = {}
    for n in SHAPES["quotient"]:
        a = torch.randint(0, 1 << 62, (n,), generator=gen, device="cuda")
        b = torch.randint(0, 1 << 62, (n,), generator=gen, device="cuda")
        for name, (fn, ops, mul) in binops.items():
            reps = 2000 if n <= 1 << 12 else 200
            least = chip_smoke.bound(24 * n, ops * n, mul * n)
            elementwise[f"{name} {n}"] = {
                "ms": cuda_ms(lambda: fn(a, b), reps),
                "device_ms": chip_smoke.device_ms(lambda: fn(a, b), 50),
                "bound_ms": least["bound_ms"], "bound_by": least["bound_by"]}
    from olavm_tpu_torch.stark.config import StarkConfig
    from olavm_tpu_torch.tables.ola_stark import OlaStark

    ola = OlaStark()
    ola.set_compress_challenges(list(range(1, len(ola.starks) + 1)))
    tpd.prebuild_quotient_kernels(ola, StarkConfig.standard_fast_config())
    rng = np.random.default_rng(0)
    classes = {}
    for table, degree in chip_smoke.QUOTIENT_SHAPES:
        case = chip_smoke.quotient_case(table, degree, rng,
                                        torch.device("cuda", 0))
        stark, static = case["stark"], case["static"]
        name = type(stark).__name__
        qdb = tpd.quotient_degree_bits(stark, case["config"])
        cls = tpd.class_constants(degree.bit_length() - 1, qdb, 1, "cuda")
        k6 = tpd.quotient_kernels(stark, case["coeffs"].shape[0],
                                  case["zs_coeffs"].shape[0], **static)
        pool = gf.from_u64(k6.tape.pool, "cuda")
        row = {"zs": case["zs_coeffs"].shape[0], "classes": 1 << qdb,
               "slices": len(k6.plan.slices)}
        # the op-by-op class (the parent's program) and K6's, each as the
        # prover replays it
        for mode, fn, args in (
                ("ops", tpd.quotient_class_ops,
                 (case["coeffs"], case["zs_coeffs"], cls, case["bank"])),
                ("k6", tpd._class_program,
                 (case["coeffs"], case["zs_coeffs"], cls, pool, case["bank"]))):
            program = jitcache.cached_jit(
                ("qclass-timed", mode, name, degree),
                functools.partial(fn, stark, **static))
            program(*args)  # the warm-up and the capture
            kernels.reset_launches()
            program(*args)
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
            reps = 3 if degree >= 1 << 19 else 20
            row[mode] = {
                "ms": cuda_ms(lambda: program(*args), reps),
                "device_ms": chip_smoke.device_ms(lambda: program(*args), 2),
                "launches": launches}
            jitcache.clear()
        classes[f"{name} ({case['coeffs'].shape[0]}, {_log2(degree)})"] = row
        del case, args
    return {"elementwise": elementwise, "classes": classes,
            "k6": time_k6(gen, cuda_ms)}


# K6's sweep on one class of every table of chip_smoke.QUOTIENT_SHAPES:
# (slice budget, live values) around the kept constants
# (constraint_tape.SLICE_OPS, SLICE_LIVE)
SWEEP = ((100, 24), (150, 24), (250, 24), (300, 24), (500, 24), (1000, 24),
         (200, 20), (200, 28))


def _k6_row(k6, inp, cuda_ms) -> dict:
    """One K6's slices at one class: ptxas registers and spills, warps an
    SM, the scratch columns, its operations against required_ops, its ms
    (CUDA events, the constant table and every slice) and its bound."""
    import chip_smoke
    from olavm_tpu_torch import kernels
    from olavm_tpu_torch.stark import constraint_codegen as cg
    from olavm_tpu_torch.stark import constraint_tape as ct

    k6.library()
    least = chip_smoke.k6_bound(k6, inp)
    blocks = k6.occupancy()
    ms = cuda_ms(lambda: cg.evaluate(k6, inp),
                 3 if inp.rows >= 1 << 19 else 20)
    return {"slices": len(k6.plan.slices), "scratch": k6.plan.scratch,
            "ptxas": chip_smoke.ptxas_slices(kernels.BUILD_LOG.get(k6.name,
                                                                   "")),
            "warps_per_sm": [b * 128 // 32 for b in blocks],
            "ops_run": ct.plan_ops(k6.plan),
            "ops_required": ct.required_ops(k6.graph),
            "ops_not_needed": least["kernel_ops_not_needed"],
            "ms": ms, "bound_ms": least["bound_ms"],
            "bound_by": least["bound_by"], "share": least["bound_ms"] / ms}


def time_k6(gen, cuda_ms) -> dict:
    """K6 alone on one class of each table of chip_smoke.QUOTIENT_SHAPES
    (_k6_row), and the SWEEP there, every source built at once first."""
    import numpy as np
    import torch

    import chip_smoke
    from olavm_tpu_torch.field import gf
    from olavm_tpu_torch.stark import constraint_codegen as cg
    from olavm_tpu_torch.stark import prover_device as tpd

    rng = np.random.default_rng(1)
    cases, built = [], []
    for table, degree in chip_smoke.QUOTIENT_SHAPES:
        case = chip_smoke.quotient_case(table, degree, rng,
                                        torch.device("cuda", 0))
        k6 = tpd.quotient_kernels(case["stark"], case["coeffs"].shape[0],
                                  case["zs_coeffs"].shape[0], **case["static"])
        sweep = {key: cg.Kernels(k6.table, k6.tape, *key) for key in SWEEP}
        cases.append((table, degree, case, k6, sweep))
        built += [k6, *sweep.values()]
    seconds = cg.prebuild(built)
    out = {}
    for table, degree, case, k6, sweep in cases:
        qdb = tpd.quotient_degree_bits(case["stark"], case["config"])
        cls = tpd.class_constants(degree.bit_length() - 1, qdb, 1, "cuda")
        pool = gf.from_u64(k6.tape.pool, "cuda")
        inp = tpd.quotient_inputs(case["coeffs"], case["zs_coeffs"], cls,
                                  case["bank"], pool)
        row = _k6_row(k6, inp, cuda_ms)
        want = tpd.quotient_class_ops(case["stark"], case["coeffs"],
                                      case["zs_coeffs"], cls, case["bank"],
                                      **case["static"])
        if not torch.equal(cg.evaluate(k6, inp), want):
            raise AssertionError(f"K6 {k6.table} disagrees with "
                                 f"quotient_class_ops")
        if sweep:
            row["sweep"] = {}
            for (b, live), other in sweep.items():
                key = f"{b} ops, {live} live"
                if not torch.equal(cg.evaluate(other, inp), want):
                    raise AssertionError(f"K6 {k6.table} at {key} disagrees")
                row["sweep"][key] = _k6_row(other, inp, cuda_ms)
                print(json.dumps({"k6": k6.table, "sweep": key,
                                  **row["sweep"][key]}), flush=True)
        name = f"{k6.table} ({case['coeffs'].shape[0]}, {_log2(degree)})"
        out[name] = row
        print(json.dumps({"k6": name, **{k: v for k, v in row.items()
                                         if k != "sweep"}}), flush=True)
        del case, inp, want
        torch.cuda.empty_cache()
    return {"build_seconds": seconds, "tables": out}


if __name__ == "__main__":
    sys.exit(main())
