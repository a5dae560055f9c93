"""K6: a table's quotient constraints as fused Hopper kernels, one per
slice of its constraint sequence, generated from the table's tape
(stark/constraint_tape.py), and the quotient's fixed kernels beside them
(csrc/quotient.cu: the coset scaling and the selector columns).

Replaces the op-by-op quotient, one K3, add or sub launch per field
operation over a class's columns (olavm_tpu/field/pallas_kernels.py:79
mul_pallas and olavm_tpu/field/gf.py's jnp add and sub, which olavm_tpu's
`qpart` programs fuse through XLA, olavm_tpu/stark/prover_device.py:155-167).

`source(tape, cuts)` writes one CUDA source per table: for each slice [a,
b) of the constraint sequence a row function (the slice's cone of
operations in tape order, each value a register, each input loaded at its
first use, the Horner steps of the accumulators interleaved as each
constraint is ready) and a kernel running it one thread per row over a
grid-stride loop, on csrc/constraints.cuh. The text depends only on the
tape's structure, never on a value: the constants are a pool passed at
launch. `library` builds it at first use (kernels.build_generated: nvcc
for sm_90a into olavm_tpu_torch/_build/, named by the sha256 of the text)
and `prebuild` builds every table's at once, one nvcc each. `evaluate`
runs the slices on a CUDA tensor, and on a CPU tensor the plain version
(constraint_tape.evaluate_plain). A failed build or launch raises with the
table and the slice; nothing falls back to K3.

Bound per class: every input column read once and the accumulators
written (bytes), or the slices' field operations at about 20 32-bit
integer operations a product and 6 a sum (operations, the larger by far:
CpuStark's 6,756 operations a row against its 172 columns' 1,376 bytes).
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict

import torch

from .. import kernels
from ..field import gf
from ..field import goldilocks as g
from . import constraint_tape as ct

_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
# the C entry points of a generated library
SIGNATURES = {
    "qk_slices": [],
    "qk_launch": [ctypes.c_int, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                  _I64, _I64, _I64, _VP],
}


def _value(kind: str, a: int, b) -> str:
    """The C expression of one tape operation (operands as v<index>)."""
    if kind == "lv":
        return f"qk::load(a.lv + {a} * a.m + i)"
    if kind == "nv":
        return f"qk::load(a.nv + {a} * a.m + j)"
    if kind == "zl":
        return f"qk::load(a.zl + {a} * a.m + i)"
    if kind == "zn":
        return f"qk::load(a.zn + {a} * a.m + j)"
    if kind == "sel":
        return f"qk::load(a.sel + {a} * a.m + i)"
    if kind == "bank":
        return f"qk::load(a.bank + {a})"
    if kind == "const":
        return f"qk::load(a.pool + {a})"
    if kind in ct.BINARY:
        return f"gl::{kind}(v{a}, v{b})"
    if kind == "neg":
        return f"qk::neg(v{a})"
    if kind == "ieq":
        return f"qk::ieq(v{a}, qk::load(a.pool + {b}))"
    raise ValueError(f"unknown tape operation {kind!r}")


def _row_function(tape: ct.Tape, k: int, a: int, b: int, last: bool) -> list:
    """Slice k = [a, b)'s row function."""
    alphas = range(tape.num_alphas)
    outs = tape.outputs[a:b]
    need = sorted(ct.cone(tape, outs))
    lines = [f"__device__ __forceinline__ void row{k}(const qk::Args& a, "
             f"const int64_t i) {{"]
    if any(tape.ops[i][0] in ("nv", "zn") for i in need):
        lines.append("  const int64_t j = qk::next_row(a, i);")
    lines += [f"  const uint64_t al{r} = qk::load(a.bank + {r});"
              for r in alphas]
    lines += [f"  uint64_t acc{r} = "
              + ("0;" if a == 0 else f"a.acc[{r} * a.m + i];") for r in alphas]
    done = set()

    def ensure(i):
        # inputs and constants load at their first use
        if i not in done:
            done.add(i)
            lines.append(f"  const uint64_t v{i} = {_value(*tape.ops[i])};")

    p = 0

    def accumulate(upto):
        nonlocal p
        while p < len(outs) and outs[p] <= upto:
            ensure(outs[p])
            lines.extend(f"  acc{r} = qk::horner(acc{r}, al{r}, v{outs[p]});"
                         for r in alphas)
            p += 1

    for i in need:
        op = tape.ops[i]
        if op[0] in ct.COMPUTE:
            for x in ct.operands(op):
                ensure(x)
            ensure(i)
        accumulate(i)
    accumulate(len(tape.ops))
    if last:
        lines.append("  const uint64_t zh = "
                     "qk::load(a.zh_inv + i * a.zh_stride);")
        lines += [f"  acc{r} = gl::mul(acc{r}, zh);" for r in alphas]
    lines += [f"  a.acc[{r} * a.m + i] = acc{r};" for r in alphas]
    lines.append("}")
    return lines


def source(tape: ct.Tape, cuts) -> str:
    """The CUDA source of a tape's slices `cuts` ([(a, b), ...] in order,
    covering the constraint sequence)."""
    lines = ["// Generated by olavm_tpu_torch/stark/constraint_codegen.py "
             "from a",
             f"// constraint tape: {len(tape.ops)} operations, "
             f"{len(tape.outputs)} constraints, {len(tape.pool)} constants, "
             f"{len(cuts)} slices.",
             '#include "constraints.cuh"', ""]
    for k, (a, b) in enumerate(cuts):
        lines += _row_function(tape, k, a, b, k == len(cuts) - 1)
        lines += [f"QK_SLICE_KERNEL({k})", ""]
    lines += [f'extern "C" int qk_slices() {{ return {len(cuts)}; }}', "",
              'extern "C" int qk_launch(int slice, const void* lv, '
              "const void* nv, const void* zl,",
              "                         const void* zn, const void* sel, "
              "const void* bank,",
              "                         const void* pool, void* acc, "
              "const void* zh_inv, int64_t m,",
              "                         int64_t nshift, int64_t zh_stride, "
              "void* stream) {",
              "  const qk::Args a{",
              "      static_cast<const uint64_t*>(lv), "
              "static_cast<const uint64_t*>(nv),",
              "      static_cast<const uint64_t*>(zl), "
              "static_cast<const uint64_t*>(zn),",
              "      static_cast<const uint64_t*>(sel), "
              "static_cast<const uint64_t*>(bank),",
              "      static_cast<const uint64_t*>(pool), "
              "static_cast<uint64_t*>(acc),",
              "      static_cast<const uint64_t*>(zh_inv), m, nshift, "
              "zh_stride};",
              "  (void)stream;",
              "  switch (slice) {"]
    lines += [f"    case {k}: QK_LAUNCH({k}); break;"
              for k in range(len(cuts))]
    lines += ["    default: return -1;", "  }", "  return QK_STATUS();", "}",
              ""]
    return "\n".join(lines)


class Kernels:
    """One table's K6: its tape, slices, source and library name."""

    def __init__(self, table: str, tape: ct.Tape, budget: int = ct.SLICE_OPS):
        self.table = table
        self.tape = tape
        self.cuts = ct.slices(tape, budget)
        self.text = source(tape, self.cuts)
        self.name = kernels.generated_name("k6", self.text)
        # the rows of each input the tape reads
        self.need = {"lv": 0, "nv": 0, "zl": 0, "zn": 0, "sel": 3, "bank": 0}
        for kind, x, _ in tape.ops:
            if kind in self.need:
                self.need[kind] = max(self.need[kind], x + 1)

    def library(self) -> ctypes.CDLL:
        try:
            return kernels.generated(self.name, self.text, SIGNATURES)
        except RuntimeError as e:
            raise RuntimeError(f"K6 build for {self.table} "
                               f"({len(self.cuts)} slices) failed: {e}") from e

    def launch_all(self, lib, inp: ct.Inputs, acc: torch.Tensor,
                   stream) -> None:
        """Every slice in order into `acc` (each launch raises with its
        slice on a nonzero status). `stream` None: `lib` is the source
        built for the host (the tests' g++ build), which launches no
        kernel and counts none."""
        ptrs = [t.data_ptr() for t in (inp.lv, inp.nv, inp.zl, inp.zn,
                                       inp.sel, inp.bank, inp.pool)]
        zh_stride = 0 if inp.zh_inv.numel() == 1 else 1
        for k in range(len(self.cuts)):
            rc = lib.qk_launch(k, *ptrs, acc.data_ptr(), inp.zh_inv.data_ptr(),
                               inp.rows, inp.nshift, zh_stride, stream)
            if rc != 0:
                raise RuntimeError(f"K6 {self.table} slice {k} of "
                                   f"{len(self.cuts)}: CUDA error {rc}")
            if stream is not None:
                kernels.count("constraints")


def _contiguous(inp: ct.Inputs) -> ct.Inputs:
    return ct.Inputs(*(t.contiguous() if isinstance(t, torch.Tensor) else t
                       for t in (inp.lv, inp.nv, inp.zl, inp.zn, inp.nshift,
                                 inp.sel, inp.bank, inp.pool, inp.zh_inv)))


def _check(k6: Kernels, inp: ct.Inputs) -> None:
    m = inp.rows
    tensors = [inp.lv, inp.nv, inp.zl, inp.zn, inp.sel, inp.bank, inp.pool,
               inp.zh_inv]
    kernels.require_cuda_int64(*tensors)
    for name, t in (("lv", inp.lv), ("nv", inp.nv), ("zl", inp.zl),
                    ("zn", inp.zn)):
        if t.dim() != 2 or t.shape[1] != m:
            raise ValueError(f"K6 {k6.table}: {name} {tuple(t.shape)}, "
                             f"rows {m}")
    have = {"lv": inp.lv.shape[0], "nv": inp.nv.shape[0],
            "zl": inp.zl.shape[0], "zn": inp.zn.shape[0],
            "sel": inp.sel.shape[0], "bank": inp.bank.numel()}
    short = {k: (have[k], v) for k, v in k6.need.items() if have[k] < v}
    if short or inp.pool.numel() != len(k6.tape.pool):
        raise ValueError(f"K6 {k6.table}: operands short of the tape "
                         f"{short}, pool {inp.pool.numel()} of "
                         f"{len(k6.tape.pool)}")
    if inp.zh_inv.numel() not in (1, m) or not 0 <= inp.nshift < max(m, 1):
        raise ValueError(f"K6 {k6.table}: zh_inv {tuple(inp.zh_inv.shape)}, "
                         f"nshift {inp.nshift}, rows {m}")


def evaluate(k6: Kernels, inp: ct.Inputs) -> torch.Tensor:
    """(num_alphas, m): the class's quotient values before the coset
    interpolation, K6 on CUDA tensors, the plain version on CPU tensors."""
    if inp.sel.device.type != "cuda":
        return ct.evaluate_plain(k6.tape, k6.cuts, inp)
    inp = _contiguous(inp)
    _check(k6, inp)
    acc = torch.empty((k6.tape.num_alphas, inp.rows), dtype=torch.int64,
                      device=inp.sel.device)
    if inp.rows:
        k6.launch_all(k6.library(), inp, acc, kernels.stream_ptr(acc))
    return acc


# the tables' K6 by the key of their constraint code (cached_kernels)
_CACHE: OrderedDict = OrderedDict()
_CACHE_SIZE = 64


def cached_kernels(key, table: str, record) -> Kernels:
    """The K6 of `key`, a hashable value that fixes the constraint code
    and every host value it reads (prover_device's program keys do);
    `record()` gives its tape at the key's first use. The newest
    _CACHE_SIZE are kept."""
    if key in _CACHE:
        _CACHE.move_to_end(key)
    else:
        _CACHE[key] = Kernels(table, record())
        while len(_CACHE) > _CACHE_SIZE:
            _CACHE.popitem(last=False)
    return _CACHE[key]


def prebuild(tables) -> dict:
    """Build every table's K6 library at once (one nvcc each) where it is
    missing; returns seconds per built source."""
    sources = {k6.name: k6.text for k6 in tables}
    try:
        return kernels.build_generated(sources)
    except RuntimeError as e:
        names = ", ".join(k6.table for k6 in tables)
        raise RuntimeError(f"K6 build for {names} failed: {e}") from e


# ---------------------------------------------------------------------------
# the fixed kernels (csrc/quotient.cu)
# ---------------------------------------------------------------------------


def scale_powers(x: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """x[..., i] * base^i along the last axis of a (C, n) array, `base` a
    one-element device tensor: gl_scale_powers on CUDA tensors, the plain
    version (log-doubled powers and the plain product) on CPU tensors."""
    if x.device.type != "cuda":
        return scale_powers_plain(x, base)
    x, base = x.contiguous(), base.reshape(1).contiguous()
    kernels.require_cuda_int64(x, base)
    if x.dim() != 2:
        raise ValueError(f"scale_powers: {tuple(x.shape)}, not (C, n)")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    kernels.check(kernels.lib("quotient").gl_scale_powers(
        x.data_ptr(), out.data_ptr(), base.data_ptr(), x.shape[0], x.shape[1],
        kernels.stream_ptr(x)), "scale_powers")
    kernels.count("scale_powers")
    return out


def scale_powers_plain(x: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    return gf.mul_plain(x, _powers_plain(base.reshape(()), x.shape[-1]))


def _powers_plain(base: torch.Tensor, n: int) -> torch.Tensor:
    """[1, b, ..., b^{n-1}] of a 0-dim tensor b by log-doubling (gf.powers
    with the plain product)."""
    out = torch.ones((1,), dtype=torch.int64, device=base.device)
    bm, length = base, 1
    while length < n:
        step = min(length, n - length)
        out = torch.cat([out, gf.mul_plain(out[:step], bm)])
        length += step
        if length < n:
            bm = gf.mul_plain(bm, bm)
    return out[:n]


def _inv_plain(x: torch.Tensor) -> torch.Tensor:
    """x^(p-2), square and multiply with the plain product."""
    result, base, e = torch.ones_like(x), x, g.P - 2
    while e:
        if e & 1:
            result = gf.mul_plain(result, base)
        base = gf.mul_plain(base, base)
        e >>= 1
    return result


def selectors(cls: torch.Tensor, degree_bits: int) -> torch.Tensor:
    """(3, n) z_last, lagrange_first and lagrange_last on the class's coset
    shift*H, |H| = n = 2^degree_bits, from the class constants `cls`
    ([shift, c/n, c g^{-1}/n, ...], prover_device.class_constants):
    gl_quotient_selectors on a CUDA tensor, the plain version on a CPU
    one."""
    if cls.device.type != "cuda":
        return selectors_plain(cls, degree_bits)
    cls = cls.contiguous()
    kernels.require_cuda_int64(cls)
    n = 1 << degree_bits
    out = torch.empty((3, n), dtype=torch.int64, device=cls.device)
    gen = g.primitive_root_of_unity(degree_bits)
    kernels.check(kernels.lib("quotient").gl_quotient_selectors(
        cls.data_ptr(), out.data_ptr(), n, gen, g.inv(gen),
        kernels.stream_ptr(cls)), "quotient_selectors")
    kernels.count("quotient_selectors")
    return out


def selectors_plain(cls: torch.Tensor, degree_bits: int) -> torch.Tensor:
    # on shift*H, where x^n - 1 == shift^n - 1 is constant:
    # L_0(x) = (x^n-1)/(n (x-1)); L_{n-1}(x) = (x^n-1) g^{-1}/(n (x-g^{-1}))
    device = cls.device
    gen = g.primitive_root_of_unity(degree_bits)
    xs = gf.mul_plain(_powers_plain(gf.scalar(gen, device), 1 << degree_bits),
                      cls[0])
    lagrange_first = gf.mul_plain(
        cls[1], _inv_plain(gf.sub_plain(xs, gf.scalar(1, device))))
    z_last = gf.sub_plain(xs, gf.scalar(g.inv(gen), device))
    lagrange_last = gf.mul_plain(cls[2], _inv_plain(z_last))
    return torch.stack([z_last, lagrange_first, lagrange_last])
