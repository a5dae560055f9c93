#!/usr/bin/env python3
"""Where a full-size prove of the PyTorch port spends the card's time, with
the device prover's programs (CUDA graphs) and without them.

    python3 chip_profile.py [--hasher blake3|poseidon] [--n 94000|376000]
                                                          # needs one CUDA card

Builds the kernels, then proves the fib-loop fixture at N=94000 (2^20 CPU
rows, chip_smoke.py's full-size run; --n 376000 for 2^22) with the given
Merkle hasher (blake3 by default) in one process: first without the programs (programs=False,
the cold prove, before any program exists), then with them (the prove
that captures them), then four warm proves in turns (without, with, with,
without), each untraced and timed on the host clock around
torch.cuda.synchronize(), then one traced prove of each kind under
torch.profiler with CUDA activities only, and a traced prove with the
programs under CPU and CUDA activities that splits the card's kernels by
program tag (`program_split`). From each trace it sums the
device time of every kernel by name and counts the kernels (and K6's, the
generated constraint slices and their constant tables, under "k6"). That sum,
`device_kernel_seconds`, is the steady number: the host clock of the
card's machine moves by tens of percent between runs. The busy share is the
sum over each untraced warm prove's seconds, as a [low, high] range. Per
prove it also gives the launches of the port's kernels that the host issued
and those that graph replays ran, those that the quotient's programs ran
(and one replay of each by kernel), and the peak device memory, allocated and
reserved (the graphs' shared pool is reserved memory that allocations
outside the graphs cannot use, so the reserved peak is given beside the
allocated one), with the programs' buffers and pool, the allocator's
cudaMalloc calls (`device_allocs`) and the host seconds of the prove's
top-level scopes (`scopes_seconds`, the tables' summed). In each warm
prove it counts the calls that synchronise the host with the card (a
pageable copy, `.item()`, `bool()` of a device tensor, ...: PyTorch's sync
debug mode set to "warn", its warnings caught), in all and by call site
(the innermost two frames of the port's code, `sync_sites`); the hook
costs a stack walk a synchronising call. Prints one JSON object
as the last line and writes the same, with the kernel tables, to
chip_smoke_out/profile.json (profile_poseidon.json for --hasher poseidon,
profile_n376000.json and profile_poseidon_n376000.json for --n 376000).

The split: each program call runs inside a profiler range named after its
tag (`ctlz`, `permz`, `qclass`, `extpows`, `fricomp`, `frifold`,
`fri_refft`); every kernel that ran is charged, through the correlation id
of the runtime call that launched it (a kernel launch, or the graph launch
of a replay), to the range around that call, or to "host" (issued by the
host outside any program). Per tag it gives, by kernel class (K3, add,
sub, cat, fill, K7, K8, K9, K10, K11, K12, K13 in both fields, the coset
scaling, K1, the rest), the launches and device milliseconds, their sum
("all"), and the same for the copies and memsets on the card by kind
(memcpy DtoD, HtoD, DtoH, ..., memset) with their bytes, and their sum
("copies"): a program's copies of its inputs into its buffers are DtoD
copies of its tag, its outputs' copies are nodes of its graph.
`split_summary` repeats the openings' power tables (`extpows`), the FRI
re-FFTs (`fri_refft`), the K3 launches the host issued outside any
program, and each tag's kernels and copies with the sums over tags.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import statistics
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
TOP_KERNELS = 25
# the classes of program_split, by kernel name: the first that matches
KERNEL_CLASSES = (
    ("gf_mul", re.compile(r"binop_kernel<.*Op\)0>")),
    ("gf_add", re.compile(r"binop_kernel<.*Op\)1>")),
    ("gf_sub", re.compile(r"binop_kernel<.*Op\)2>")),
    ("cat", re.compile(r"CatArrayBatchedCopy")),
    ("fill", re.compile(r"FillFunctor")),
    ("gf_inv", re.compile(r"inv_kernel")),
    ("prefix_prod", re.compile(r"scan_kernel")),
    ("fri_combine", re.compile(r"fri::combine_kernel")),
    ("fri_quotient", re.compile(r"fri::quotient_kernel")),
    ("ctl_combine", re.compile(r"ctl::combine_kernel")),
    ("fri_fold", re.compile(r"fri::fold_kernel")),
    ("powers", re.compile(r"powers::base_kernel")),
    ("ext_powers", re.compile(r"powers::ext_kernel")),
    ("scale_powers", re.compile(r"scale_powers_kernel")),
    ("ntt", re.compile(r"ntt::")),
)
PROGRAM_RANGE = "program:"
# a copy's kind from its trace event's name ("Memcpy DtoD (Device ->
# Device)", "Memcpy HtoD (Pageable -> Device)", ...)
MEMCPY_KIND = re.compile(r"Memcpy (\w+)")
PORT = os.sep + "olavm_tpu_torch" + os.sep


def sync_site(frame) -> str:
    """The innermost two frames of the port's code above `frame`, as
    "file:line function" joined by " < "."""
    sites = []
    while frame is not None and len(sites) < 2:
        path = frame.f_code.co_filename
        if PORT in path:
            sites.append(f"{path.split(PORT, 1)[1]}:{frame.f_lineno} "
                         f"{frame.f_code.co_name}")
        frame = frame.f_back
    return " < ".join(sites) or "outside the port"


def kernel_class(name: str) -> str:
    for cls, pattern in KERNEL_CLASSES:
        if pattern.search(name):
            return cls
    return "other"


def copy_class(event: dict) -> str | None:
    """The split's class of a copy or memset event ("memcpy DtoD",
    "memcpy HtoD", "memcpy DtoH", ..., "memset"), None for any other."""
    if event.get("cat") == "gpu_memset":
        return "memset"
    if event.get("cat") == "gpu_memcpy":
        m = MEMCPY_KIND.search(event.get("name", ""))
        return f"memcpy {m.group(1) if m else 'other'}"
    return None


def program_split(trace: dict) -> dict:
    """{tag: {class: {"launches", "device_ms", "bytes"}}} of a chrome trace
    taken with CPU and CUDA activities while every program call ran inside
    a record_function range "program:<tag>" (see the module's docstring):
    the kernel classes, "all" their sum, the copies and memsets by kind
    (copy_class) and "copies" their sum; a kernel's bytes are 0."""
    import bisect

    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["tid"],
                     e["name"][len(PROGRAM_RANGE):])
                    for e in events if e.get("ph") == "X"
                    and e.get("name", "").startswith(PROGRAM_RANGE))
    starts = [r[0] for r in ranges]
    launched_in = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("cuda_runtime",
                                                       "cuda_driver"):
            continue
        corr = e.get("args", {}).get("correlation")
        if corr is None:
            continue
        tag = "host"
        i = bisect.bisect_right(starts, e["ts"]) - 1
        # the innermost range that holds the call, on its thread
        while i >= 0:
            lo, hi, tid, name = ranges[i]
            if tid == e["tid"] and lo <= e["ts"] <= hi:
                tag = name
                break
            if e["ts"] - lo > 60e6:  # no range is a minute long
                break
            i -= 1
        launched_in[corr] = tag
    out, copies = {}, set()
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") == "kernel":
            cls = kernel_class(e["name"])
        else:
            cls = copy_class(e)
            if cls is None:
                continue
            copies.add(cls)
        args = e.get("args", {})
        tag = launched_in.get(args.get("correlation"), "unattributed")
        row = out.setdefault(tag, {}).setdefault(
            cls, {"launches": 0, "device_ms": 0.0, "bytes": 0})
        row["launches"] += 1
        row["device_ms"] += e["dur"] / 1e3
        row["bytes"] += int(args.get("bytes", 0)) if cls in copies else 0
    for tag, rows in out.items():
        for name, keep in (("all", lambda c: c not in copies),
                           ("copies", lambda c: c in copies)):
            picked = [r for c, r in rows.items() if keep(c)]
            rows[name] = {k: sum(r[k] for r in picked)
                          for k in ("launches", "device_ms", "bytes")}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hasher", choices=["blake3", "poseidon"],
                    default="blake3", help="Merkle hasher of the prove")
    ap.add_argument("--n", type=int, choices=[94000, 376000], default=94000,
                    help="the fixture's N: 94000 (2^20 CPU rows) or 376000 "
                         "(2^22)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2

    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from olavm_tpu_torch import kernels
    from olavm_tpu_torch.stark.config import StarkConfig
    from olavm_tpu_torch.stark import prover_device
    from olavm_tpu_torch.stark.prover_device import prove_with_traces_device
    from olavm_tpu_torch.stark.serialization import serialize_all_proof
    from olavm_tpu_torch.utils import jitcache
    from olavm_tpu_torch.utils.timing import TimingTree

    def quotient_kernels() -> dict:
        out = {}
        for st in jitcache.stats().values():
            if st["tag"] == "qclass":
                for k, v in st.get("kernels", {}).items():
                    out[k] = out.get(k, 0) + v
        return out

    smi = chip_smoke.nvidia_smi()
    kernels.build(force=True)
    with tempfile.TemporaryDirectory() as workdir:
        trace_dir = os.path.join(workdir, "full")
        chip_smoke.prepare(args.n, workdir, trace_dir)
        traces, public_values, ola, _ = chip_smoke.load_traces(trace_dir)
    config = StarkConfig.standard_fast_config()
    config.merkle_hasher = args.hasher
    t0 = time.perf_counter()
    prover_device.prebuild_quotient_kernels(ola, config)
    k6_build_seconds = time.perf_counter() - t0
    device = torch.device("cuda", 0)

    def prove(programs: bool, count_syncs: bool = False) -> dict:
        before = jitcache.stats()
        kernels.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        allocs = torch.cuda.memory_stats(device).get("num_device_alloc", 0)
        timing = TimingTree()
        syncs: dict = {}

        def seen(message, category, filename, lineno, file=None, line=None):
            if "synchronizing" in str(message):
                site = sync_site(sys._getframe(1))
                syncs[site] = syncs.get(site, 0) + 1

        with warnings.catch_warnings():
            if count_syncs:
                warnings.simplefilter("always")
                warnings.showwarning = seen
                torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            try:
                proof = prove_with_traces_device(ola, config, traces,
                                                 public_values=public_values,
                                                 timing=timing, device=device,
                                                 programs=programs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        scopes: dict = {}
        for depth, name, secs in timing.records:
            if depth == 1:
                key = re.sub(r"\d+", "#", name)
                scopes[key] = scopes.get(key, 0.0) + secs
        host = sum(kernels.HOST_LAUNCHES.values())
        by_tag = chip_smoke.program_counts(before, jitcache.stats())["by_tag"]
        replays = {tag: t["replays"] for tag, t in by_tag.items()}
        run = {
            "programs": programs, "seconds": seconds,
            "host_issued_launches": host,
            "host_issued_k3": kernels.HOST_LAUNCHES["gf_mul"],
            "sync_calls": sum(syncs.values()) if count_syncs else None,
            "sync_sites": dict(sorted(syncs.items(), key=lambda kv: -kv[1])),
            "replayed_launches": sum(kernels.LAUNCHES.values()) - host,
            "launches": dict(kernels.LAUNCHES),
            "replays_by_tag": replays,
            # the quotient's programs: launches their replays ran, and of
            # one replay of each by kernel
            "quotient_replayed_launches": by_tag.get(
                "qclass", {}).get("replayed_launches", 0),
            "quotient_kernels": quotient_kernels(),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
            # the allocator's cudaMalloc calls during the prove, and the
            # host seconds of each of the prove's top-level scopes (tables'
            # scopes summed)
            "device_allocs": torch.cuda.memory_stats(device).get(
                "num_device_alloc", 0) - allocs,
            "scopes_seconds": scopes,
            "program_memory_bytes": chip_smoke.program_memory(),
            "proof_sha256": hashlib.sha256(
                serialize_all_proof(proof)).hexdigest()}
        print(f"prove programs={programs}: {seconds:.3f} s, "
              f"{host} host-issued launches, peak "
              f"{run['peak_memory_bytes'] / 2**30:.2f} GiB", file=sys.stderr,
              flush=True)
        return run

    runs = [prove(False), prove(True)]  # cold; the capture
    for programs in (False, True, True, False):
        runs.append(prove(programs, count_syncs=True))

    traced = {}
    for programs in (False, True):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced_run = prove(programs)
        rows = [(e.key, e.count, getattr(e, "device_time_total", None)
                 or getattr(e, "cuda_time_total", 0.0))
                for e in prof.key_averages()]
        rows = [r for r in rows if r[2] > 0]
        rows.sort(key=lambda r: -r[2])
        # K6: the generated slices and their constant tables
        k6 = [r for r in rows
              if r[0].startswith("slice") or "qk::prepare_kernel" in r[0]]
        traced["programs" if programs else "eager"] = {
            "prove_seconds_traced": traced_run["seconds"],
            "device_kernel_seconds": sum(r[2] for r in rows) / 1e6,
            "device_kernels": sum(r[1] for r in rows),
            "k6": {"device_ms": sum(r[2] for r in k6) / 1e3,
                   "launches": sum(r[1] for r in k6)},
            "top_kernels": [{"kernel": k[:120], "count": c,
                             "device_ms": t / 1e3}
                            for k, c, t in rows[:TOP_KERNELS]]}

    # the split by program tag: one more programs prove, traced with CPU
    # and CUDA activities, every program call inside a range of its tag
    call = jitcache.Program.__call__

    def annotated(self, *inputs):
        tag = self.key[0] if isinstance(self.key, tuple) else self.key
        with torch.profiler.record_function(f"{PROGRAM_RANGE}{tag}"):
            return call(self, *inputs)

    jitcache.Program.__call__ = annotated
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            split_run = prove(True)
    finally:
        jitcache.Program.__call__ = call
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            split = program_split(json.load(f))
    del prof

    digests = {r["proof_sha256"] for r in (*runs, split_run)}
    if len(digests) != 1:
        raise AssertionError(f"the proves differ: {sorted(digests)}")
    result = {"card": smi, "torch": torch.__version__, "N": args.n,
              "merkle_hasher": args.hasher, "proof_sha256": digests.pop(),
              "k6_build_seconds": k6_build_seconds}
    for mode, programs in (("eager", False), ("programs", True)):
        warm = [r for r in runs[2:] if r["programs"] == programs]
        seconds = [r["seconds"] for r in warm]
        device_seconds = traced[mode]["device_kernel_seconds"]
        result[mode] = {
            "first_prove_seconds": runs[1 if programs else 0]["seconds"],
            "warm_prove_seconds": seconds,
            "warm_prove_seconds_median": statistics.median(seconds),
            "device_kernel_seconds": device_seconds,
            "device_kernels": traced[mode]["device_kernels"],
            "k6": traced[mode]["k6"],
            "prove_seconds_traced": traced[mode]["prove_seconds_traced"],
            "busy_share_warm": [device_seconds / max(seconds),
                                device_seconds / min(seconds)],
            "host_issued_launches": [r["host_issued_launches"] for r in warm],
            "host_issued_k3": [r["host_issued_k3"] for r in warm],
            "sync_calls": [r["sync_calls"] for r in warm],
            "sync_sites": warm[-1]["sync_sites"],
            "launches": [sum(r["launches"].values()) for r in warm],
            "launches_by_kernel": warm[-1]["launches"],
            "replays_by_tag": warm[-1]["replays_by_tag"],
            "quotient_replayed_launches": [r["quotient_replayed_launches"]
                                           for r in warm],
            "quotient_kernels_one_replay_each": warm[-1]["quotient_kernels"],
            "replayed_launches": [r["replayed_launches"] for r in warm],
            "peak_memory_bytes": [r["peak_memory_bytes"] for r in warm],
            "peak_reserved_bytes": [r["peak_reserved_bytes"] for r in warm],
            "device_allocs": [r["device_allocs"] for r in warm],
            "scopes_seconds": [r["scopes_seconds"] for r in warm],
        }
    result["program_split"] = split
    result["split_summary"] = {
        **{tag: split.get(tag, {}).get("all") for tag in ("extpows",
                                                          "fri_refft")},
        "host_k3": split.get("host", {}).get("gf_mul"),
        # per tag: the kernels, and the copies and memsets (each program's
        # input copies, its outputs' copies, the host's uploads)
        "kernels": {tag: rows["all"] for tag, rows in split.items()},
        "copies": {tag: rows["copies"] for tag, rows in split.items()},
        "kernels_ms": sum(r["all"]["device_ms"] for r in split.values()),
        "copies_ms": sum(r["copies"]["device_ms"] for r in split.values()),
        "copies_bytes": sum(r["copies"]["bytes"] for r in split.values())}
    result["cold_eager_peak_memory_bytes"] = runs[0]["peak_memory_bytes"]
    result["cold_eager_peak_reserved_bytes"] = runs[0]["peak_reserved_bytes"]
    result["program_memory_bytes"] = runs[-1]["program_memory_bytes"]
    result["host_issued_share"] = (
        max(result["programs"]["host_issued_launches"])
        / min(result["eager"]["host_issued_launches"]))
    for tag, rows in sorted(split.items(), key=lambda kv: -kv[1]["all"]["device_ms"]):
        print(f"split {tag:12s} " + "  ".join(
            f"{c} {r['launches']} / {r['device_ms']:.2f} ms"
            + (f" / {r['bytes'] / 1e9:.3f} GB" if r["bytes"] else "")
            for c, r in sorted(rows.items())), file=sys.stderr)
    for mode in ("eager", "programs"):
        for row in traced[mode]["top_kernels"]:
            print(f"{mode:8s} {row['device_ms']:10.2f} ms {row['count']:8d}  "
                  f"{row['kernel']}", file=sys.stderr)
    out_dir = os.path.join(ROOT, "chip_smoke_out")
    os.makedirs(out_dir, exist_ok=True)
    name = ("profile" + ("" if args.hasher == "blake3" else "_poseidon")
            + ("" if args.n == chip_smoke.FULL_N else f"_n{args.n}") + ".json")
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump({**result, "runs": runs,
                   "top_kernels": {m: traced[m]["top_kernels"]
                                   for m in traced}}, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
