#!/usr/bin/env python3
"""Time the NTT kernel (K1) of this checkout at the main path's shapes.

    python3 chip_ntt_times.py      # needs one CUDA card and nvcc

Builds olavm_tpu_torch/csrc/ntt.cu, times a forward transform with CUDA
events after a warm-up (chip_smoke.cuda_ms), and prints one JSON object
{"root": ..., "ms": {shape: milliseconds}}. To compare two versions of the
kernel, unpack each checkout into a directory of its own and run each one's
own copy of this script in turns (a b b a) within one call on one card.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = ((16, 1 << 23), (18, 1 << 24), (16, 1 << 21), (16, 1 << 20),
          (16, 1 << 17), (3, 1 << 13), (134, 1024), (53, 16))


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_ntt_times: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from olavm_tpu_torch import kernels
    from olavm_tpu_torch.ntt import ntt as dntt

    kernels.build(["ntt"], force=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ms = {}
    for shape in SHAPES:
        x = torch.randint(0, 1 << 62, shape, generator=gen, device="cuda")
        reps = 10 if shape[1] >= 1 << 20 else 200
        ms[f"{shape[0]}x2^{shape[1].bit_length() - 1}"] = chip_smoke.cuda_ms(
            lambda: dntt._ntt_cuda(x, False), reps)
        del x
    print(json.dumps({"root": ROOT, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
