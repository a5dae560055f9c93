#!/usr/bin/env python3
"""Where a full-size prove of the PyTorch port spends the card's time.

    python3 chip_profile.py [--hasher blake3|poseidon]   # needs one CUDA card

Builds the kernels, then proves the fib-loop fixture at N=94000 (2^20 CPU
rows, chip_smoke.py's full-size run) with the given Merkle hasher (blake3
by default) four times in one process: the first prove and two warm
proves untraced, timed on the host clock around torch.cuda.synchronize(),
then one under torch.profiler with CUDA activities only. From the trace it
sums the device time of every kernel by name and counts the kernels. That
sum, `device_kernel_seconds`, is the steady number: the host clock of the
card's machine moves by tens of percent between runs. The busy share is given
twice: `busy_share_traced` is the sum over the traced prove's own seconds (one
run, but the denominator holds the profiler's cost), `busy_share_warm` is the
sum over each untraced warm prove's seconds, as a [low, high] range. Prints one
JSON object as the last line and writes the same, with the kernel table, to
chip_smoke_out/profile.json (profile_poseidon.json for --hasher poseidon).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
TOP_KERNELS = 25


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hasher", choices=["blake3", "poseidon"],
                    default="blake3", help="Merkle hasher of the prove")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2

    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from olavm_tpu_torch import kernels
    from olavm_tpu_torch.stark.serialization import serialize_all_proof

    smi = chip_smoke.nvidia_smi()
    kernels.build(force=True)
    with tempfile.TemporaryDirectory() as workdir:
        prove, _, _ = chip_smoke.prepare(chip_smoke.FULL_N, workdir)
    device = torch.device("cuda", 0)

    torch.cuda.reset_peak_memory_stats()
    seconds = []
    for _ in range(3):
        kernels.reset_launches()
        proof, s, _ = prove(device, merkle_hasher=args.hasher)
        seconds.append(s)
        print(f"untraced prove {s:.3f} s", file=sys.stderr, flush=True)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    digest = hashlib.sha256(serialize_all_proof(proof)).hexdigest()
    del proof

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, traced_seconds, _ = prove(device, merkle_hasher=args.hasher)
    rows = [(e.key, e.count, getattr(e, "device_time_total", None)
             or getattr(e, "cuda_time_total", 0.0))
            for e in prof.key_averages()]
    rows = [r for r in rows if r[2] > 0]
    rows.sort(key=lambda r: -r[2])
    device_seconds = sum(r[2] for r in rows) / 1e6
    kernel_count = sum(r[1] for r in rows)
    warm = seconds[1:]
    result = {
        "card": smi,
        "torch": torch.__version__,
        "N": chip_smoke.FULL_N,
        "merkle_hasher": args.hasher,
        "prove_seconds_untraced": seconds,
        "prove_seconds_traced": traced_seconds,
        "warm_prove_seconds": statistics.median(warm),
        "device_kernel_seconds": device_seconds,
        "device_kernels": kernel_count,
        "busy_share_traced": device_seconds / traced_seconds,
        "busy_share_warm": [device_seconds / max(warm),
                            device_seconds / min(warm)],
        "peak_memory_bytes": int(peak),
        "launches": launches,
        "proof_sha256": digest,
    }
    table = [{"kernel": k[:120], "count": c, "device_ms": t / 1e3}
             for k, c, t in rows[:TOP_KERNELS]]
    for row in table:
        print(f"{row['device_ms']:10.2f} ms {row['count']:8d}  {row['kernel']}",
              file=sys.stderr)
    out_dir = os.path.join(ROOT, "chip_smoke_out")
    os.makedirs(out_dir, exist_ok=True)
    name = "profile.json" if args.hasher == "blake3" else "profile_poseidon.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump({**result, "top_kernels": table}, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
