"""The chip scripts' bookkeeping on the CPU: chip_profile.program_split on a
made-up trace (kernels, copies and memsets charged to the program range
whose runtime call launched them, by class, kind and bytes)."""

import chip_profile
import torch_threads  # noqa: F401  (torch's share of the cores)


def _trace():
    """Two program ranges on thread 1 and the device events their runtime
    calls launched, and a host-issued copy and kernel outside them."""
    def runtime(ts, corr, tid=1):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunch",
                "ts": ts, "dur": 1, "tid": tid,
                "args": {"correlation": corr}}

    def device(cat, name, corr, dur, nbytes=None):
        args = {"correlation": corr}
        if nbytes is not None:
            args["bytes"] = nbytes
        return {"ph": "X", "cat": cat, "name": name, "ts": 1000, "dur": dur,
                "tid": 7, "args": args}

    return {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "program:ctlz",
         "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "program:permz",
         "ts": 200, "dur": 100, "tid": 1},
        runtime(10, 1), runtime(20, 2), runtime(30, 3), runtime(40, 4),
        runtime(210, 5), runtime(220, 6), runtime(400, 7), runtime(410, 8),
        device("kernel", "void ctl::combine_kernel(...)", 1, 4.0),
        device("kernel", "void scan::scan_kernel<true>(...)", 2, 6.0),
        device("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 3, 2.0,
               789_000_000),
        device("gpu_memset", "Memset (Device)", 4, 1.0, 4096),
        device("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 5, 3.0, 1000),
        device("kernel", "void gl_inv::inv_kernel(...)", 6, 5.0),
        device("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 7, 8.0, 64),
        device("kernel", "void ntt::radix_kernel(...)", 8, 9.0),
        # a CPU event and an unknown category are left out
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 12,
         "dur": 3, "tid": 1, "args": {}},
    ]}


def test_program_split_counts_copies_beside_kernels():
    split = chip_profile.program_split(_trace())
    ctlz, permz, host = split["ctlz"], split["permz"], split["host"]
    assert ctlz["ctl_combine"] == {"launches": 1, "device_ms": 0.004,
                                   "bytes": 0}
    assert ctlz["memcpy DtoD"] == {"launches": 1, "device_ms": 0.002,
                                   "bytes": 789_000_000}
    assert ctlz["memset"]["bytes"] == 4096
    assert ctlz["all"] == {"launches": 2, "device_ms": 0.010, "bytes": 0}
    assert ctlz["copies"]["launches"] == 2
    assert ctlz["copies"]["bytes"] == 789_004_096
    assert permz["gf_inv"]["launches"] == 1
    assert permz["copies"]["bytes"] == 1000
    assert host["memcpy HtoD"]["bytes"] == 64
    assert host["ntt"]["launches"] == 1 and host["all"]["launches"] == 1


def test_copy_class_by_kind():
    assert chip_profile.copy_class({"cat": "gpu_memcpy",
                                    "name": "Memcpy DtoH (Device -> Pinned)"}
                                   ) == "memcpy DtoH"
    assert chip_profile.copy_class({"cat": "gpu_memset",
                                    "name": "Memset (Device)"}) == "memset"
    assert chip_profile.copy_class({"cat": "kernel", "name": "x"}) is None
