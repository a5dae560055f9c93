"""Build, load and count the hand-written Hopper kernels in csrc/.

Each source in csrc/ is compiled by nvcc for sm_90a into its own shared
library with a plain C interface, and loaded with ctypes (no PyTorch headers,
so a build takes seconds). The build runs at first use, into _build/ beside
this file (listed in .gitignore); `build()` compiles all sources at once, one
nvcc process per source. K6's sources are generated per table
(stark/constraint_codegen.py): `build_generated` writes each into _build/
under a name made from the sha256 of its text and compiles them the same
way, and `generated` loads one.

Every C entry point launches on the stream it is given and returns the CUDA
error code of its launches; `check` raises on a nonzero code. Each kernel
wrapper calls `count` once per call that launched its kernel, so a run can
show which kernels its main path went through: `LAUNCHES` counts every
launch that ran, `HOST_LAUNCHES` those the host issued itself. While a
program (utils/jitcache.py) is being captured into a CUDA graph nothing
runs: its wrappers' launches are recorded for the program (`recording`),
which adds them to `LAUNCHES` on every replay (`add_replayed`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("blake3", "ctl", "eval", "fri", "gf_inv", "gf_mul", "ntt",
           "poseidon", "powers", "quotient", "scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"gf_mul": 0, "gf_add": 0, "gf_sub": 0, "ntt": 0, "poseidon": 0,
            "blake3_leaves": 0, "blake3_level": 0, "blake3_absorb": 0,
            "poseidon_leaves": 0, "poseidon_level": 0, "poseidon_absorb": 0,
            "eval_points": 0, "constraints": 0, "scale_powers": 0,
            "quotient_selectors": 0, "gf_inv": 0, "gf_ext_inv": 0,
            "prefix_prod": 0, "fri_combine": 0, "fri_quotient": 0,
            "ctl_combine": 0, "fri_fold": 0, "powers": 0, "ext_powers": 0}
# kernel name -> launches the host issued itself since the last reset (a
# replayed program's launches are counted in LAUNCHES only)
HOST_LAUNCHES = dict.fromkeys(LAUNCHES, 0)
# the launch counts of the captures in progress (innermost last)
_recording: list = []

# source name -> what nvcc printed when it was last built here (ptxas -v:
# registers, shared memory and spills of every kernel), the generated
# sources' too
BUILD_LOG: dict = {}

_libs: dict = {}
_lock = threading.Lock()

_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_U64 = ctypes.c_uint64
_U32P = ctypes.POINTER(ctypes.c_uint32)
# C signatures of every entry point, by library
_SIGNATURES = {
    "blake3": {
        "gl_blake3_leaves": [_VP, _VP, _I64, _INT, _VP],
        "gl_blake3_level": [_VP, _VP, _I64, _VP],
        "gl_blake3_absorb": [_VP, _VP, _VP, _I64, _INT, _INT, _U32P, _VP],
    },
    "ctl": {"gl_ctl_combine": [_VP, _VP, _VP, _VP, _I64, _VP]},
    "eval": {"gl_eval_points": [_VP, _VP, _VP, _VP, _I64, _INT, _INT, _INT,
                                _INT, _INT, _I64, _VP],
             "gl_eval_occupancy": [_INT, _I64, ctypes.POINTER(_INT)]},
    "fri": {
        "gl_fri_combine": [_VP, _INT, _VP, _INT, _VP, _I64, _I64, _U64,
                           _VP],
        "gl_fri_quotient": [_VP, _INT, _VP, _VP, _VP, _VP, _I64, _U64, _U64,
                            _VP],
        "gl_fri_fold": [_VP, _VP, _VP, _VP, _I64, _INT, _VP],
    },
    "gf_inv": {
        "gl_inv": [_VP, _VP, _I64, _VP],
        "gl_ext_inv": [_VP, _VP, _VP, _VP, _I64, _VP],
    },
    "gf_mul": {
        "gl_mul": [_VP, _VP, _VP, _I64, _I64, _I64, _VP],
        "gl_add": [_VP, _VP, _VP, _I64, _I64, _I64, _VP],
        "gl_sub": [_VP, _VP, _VP, _I64, _I64, _I64, _VP],
    },
    "ntt": {"gl_ntt": [_VP, _VP, _VP, _I64, _INT, _VP],
            "gl_ntt_passes": [_INT]},
    "poseidon": {
        "gl_poseidon_init": [_VP] * 8,
        "gl_poseidon_permute": [_VP, _VP, _I64, _VP],
        "gl_poseidon_leaves": [_VP, _VP, _I64, _INT, _VP],
        "gl_poseidon_level": [_VP, _VP, _I64, _VP],
        "gl_poseidon_absorb": [_VP, _VP, _VP, _VP, _I64, _INT, _VP],
    },
    "powers": {
        "gl_powers": [_VP, _VP, _I64, _I64, _VP],
        "gl_ext_powers": [_VP, _VP, _VP, _I64, _VP],
    },
    "quotient": {
        "gl_scale_powers": [_VP, _VP, _VP, _U64, _U64, _I64, _I64, _VP],
        "gl_quotient_selectors": [_VP, _VP, _I64, _U64, _U64, _VP],
    },
    "scan": {
        "gl_prefix_prod": [_VP, _VP, _VP, _I64, _I64, _I64, _INT, _VP],
        "gl_prefix_prod_state_words": [_I64, _I64],
        "gl_prefix_prod_zeroed_words": [_I64, _I64],
    },
}
# entry points that return something other than an error code
_RESTYPES = {"gl_prefix_prod_state_words": _I64,
             "gl_prefix_prod_zeroed_words": _I64}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = HOST_LAUNCHES[k] = 0


def count(name: str) -> None:
    """One launch of kernel `name` by its wrapper: a launch that ran, issued
    by the host, or, while a program is being captured, one launch of each
    of the program's replays."""
    if _recording:
        _recording[-1][name] += 1
    else:
        LAUNCHES[name] += 1
        HOST_LAUNCHES[name] += 1


@contextmanager
def recording():
    """Within it, the wrappers' launches go to the yielded counts and not to
    LAUNCHES: a capture records what each replay of its graph launches."""
    counts = dict.fromkeys(LAUNCHES, 0)
    _recording.append(counts)
    try:
        yield counts
    finally:
        _recording.pop()


def add_replayed(counts: dict) -> None:
    """A replay ran the launches its capture recorded."""
    for k, v in counts.items():
        LAUNCHES[k] += v


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str, source: Path | None = None) -> bool:
    """The library is missing, or older than its source or than any header in
    csrc/ (a source may include any of them)."""
    lib = _lib_path(name)
    if not lib.exists():
        return True
    source = source or CSRC / f"{name}.cu"
    newest = max(p.stat().st_mtime for p in [source, *CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def _compile(jobs: dict) -> dict:
    """nvcc each {name: source path} into lib<name>.so, all at once; returns
    seconds per source and raises with nvcc's output of every failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, source in jobs.items():
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(source)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    times, errors = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        BUILD_LOG[name] = out.decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"nvcc {Path(jobs[name]).name} failed:\n"
                          f"{BUILD_LOG[name]}")
            continue
        os.replace(tmp, _lib_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def build(names=SOURCES, force: bool = False) -> dict:
    """Compile the named sources (all at once, one nvcc each) where the
    library is missing or older than its source. Returns seconds per built
    source; raises with nvcc's output if any build fails."""
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    return _compile({n: CSRC / f"{n}.cu" for n in todo})


def generated_name(prefix: str, text: str) -> str:
    """The library name of a generated source: its prefix and the sha256 of
    its text."""
    return f"{prefix}_{hashlib.sha256(text.encode()).hexdigest()[:20]}"


def build_generated(sources: dict) -> dict:
    """Compile generated sources {name: CUDA text} (names from
    generated_name) where the library is neither loaded nor built after
    every csrc/ header, all at once, one nvcc each, writing each text into
    _build/ first. Returns seconds per built source; raises with nvcc's output if
    any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in sources.items():
        if name in _libs:  # built and loaded in this process
            continue
        path = BUILD_DIR / f"{name}.cu"
        if not path.exists() or path.read_text() != text:
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            tmp.write_text(text)
            os.replace(tmp, path)
        if _stale(name, path):
            jobs[name] = path
    if not jobs:
        return {}
    return _compile(jobs)


def generated(name: str, text: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of a generated source, built first if needed;
    `signatures` {function: argtypes}, each returning an int."""
    with _lock:
        if name not in _libs:
            build_generated({name: text})
            handle = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in signatures.items():
                getattr(handle, fn).argtypes = argtypes
                getattr(handle, fn).restype = _INT
            _libs[name] = handle
        return _libs[name]


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for one csrc source, built first if needed."""
    with _lock:
        if name not in _libs:
            build([name])
            handle = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(handle, fn).argtypes = argtypes
                getattr(handle, fn).restype = _RESTYPES.get(fn, _INT)
            _libs[name] = handle
        return _libs[name]


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def require_cuda_int64(*tensors: torch.Tensor) -> None:
    """Kernel inputs: int64 Goldilocks bit patterns, contiguous, on one card."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"kernel operands must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if t.dtype != torch.int64:
            raise TypeError(f"kernel operands must be int64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
