"""K6: a table's quotient constraints as fused Hopper kernels, one per
slice of its lowered tape's plan (stark/constraint_tape.py), and the
quotient's fixed kernels beside them (csrc/quotient.cu: the coset scaling
and the selector columns).

Replaces the op-by-op quotient, one K3, add or sub launch per field
operation over a class's columns (olavm_tpu/field/pallas_kernels.py:79
mul_pallas and olavm_tpu/field/gf.py's jnp add and sub, which olavm_tpu's
`qpart` programs fuse through XLA, olavm_tpu/stark/prover_device.py:155-167).

`source(k6)` writes one CUDA source per table, on csrc/constraints.cuh: a
constant table `qk_c` in constant memory (the pool, the bank, each
alpha's powers and the uniform values, filled once per class by
`qk_prepare` from the device tensors, so it holds every prove's
challenges), and for each slice a row function and a kernel running it
one thread per row. A row function is the slice's nodes in depth-first
order, each value a register and a residue below 2^64 (goldilocks.cuh's
lazy helpers; canonical only at an ieq operand and the accumulators
written), each input loaded at its first use and read again after
REUSE nodes rather than held, each load tied to a value computed LEAD
nodes before it (qk::load_at: ptxas then neither hoists loads nor merges
re-reads), each constraint times its alpha powers and each sum of two
products or more added unreduced into 160-bit sums. The text depends
only on the tape's structure and on which pool slots hold 0 or 1, never
on another value. `library` builds it at first use (kernels.build_generated:
nvcc for sm_90a into olavm_tpu_torch/_build/, named by the sha256 of the
text) and `prebuild` builds every table's at once, one nvcc each.
`evaluate` runs the constant table and the slices on a CUDA tensor, and
on a CPU tensor the plain version (constraint_tape.evaluate_plain). A
failed build or launch raises with the table and the slice; nothing falls
back to K3.

Bound per class: every input column read once and the accumulators
written (bytes), or the field operations that the quotient needs
(constraint_tape.required_ops) at about 20 32-bit integer operations a
product and 6 a sum (operations, the larger by far: CpuStark's 5,254
operations a row against its 172 columns' 1,376 bytes).
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
    "qk_prepare": [_VP, _VP, _VP, _VP],
    "qk_launch": [ctypes.c_int, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                  _I64, _I64, _I64, _VP],
    "qk_occupancy": [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
}
# the most 64-bit words of constant memory a library's qk_c may hold (64 KB)
CONST_WORDS = 8192

class _Row:
    """The C text of one slice's row function, written node by node: each
    value a `const uint64_t` (a register to ptxas), each input and scratch
    value loaded at its first use, and whether a value is canonical (an
    input column, the pool, the bank, a baked value) or only a residue
    below 2^64 (the lazy arithmetic's results, the scratch columns)."""

    def __init__(self, k6: "Kernels"):
        self.graph, self.plan, self.k6 = k6.graph, k6.plan, k6
        self.lines, self.expr, self.canon = [], {}, {}
        # the node being written (its index in the slice), each loaded
        # value's last use, and the values computed, in order
        self.t, self.used, self.made = 0, {}, []

    def value(self, i: int) -> str:
        if i in self.used:
            if self.t - self.used[i] > ct.REUSE:
                # read again (constraint_tape.pressure counts it so)
                self._load(i, len(self.lines))
            self.used[i] = self.t
        if i in self.expr:
            return self.expr[i]
        kind, x, _ = self.graph.ops[i]
        if i in self.k6.upos:  # a uniform value, in the constant table
            self.expr[i] = f"qk_c[{self.k6.ubase + self.k6.upos[i]}]"
            self.canon[i] = True
        elif kind in ct.COMPUTE or kind in ct.ROW_INPUTS:
            # computed by an earlier slice, or an input
            self._load(i, 0)
            self.used[i] = self.t
        else:
            self.expr[i] = {"const": f"qk_c[{x}]",
                            "bank": f"qk_c[{self.k6.npool + x}]",
                            "lit": f"{x:#x}ull"}[kind]
            self.canon[i] = True
        return self.expr[i]

    def _load(self, i: int, k: int) -> None:
        """Load node i's column at this row (k > 0: again, as v<i>_<k>),
        once the value computed LEAD nodes back is known (qk::load_at):
        early enough to hide the load, late enough not to hold it long."""
        kind, x, _ = self.graph.ops[i]
        base, col, row = (("a.scr", self.plan.columns[i], "i")
                          if kind in ct.COMPUTE else
                          (f"a.{kind}", x, "j" if kind in ("nv", "zn") else "i"))
        name = f"v{i}" if not k else f"v{i}_{k}"
        after = self.made[-ct.LEAD] if len(self.made) >= ct.LEAD else "0"
        self.lines.append(f"  const uint64_t {name} = qk::load_at({base}, "
                          f"{col}, {row}, a.m, a.zero, {after});")
        self.expr[i] = name
        self.canon[i] = kind not in ct.COMPUTE

    def _let(self, i: int, text: str, canonical: bool) -> None:
        self.lines.append(f"  const uint64_t v{i} = {text};")
        self.expr[i] = f"v{i}"
        self.made.append(f"v{i}")
        self.canon[i] = canonical

    def _op(self, i: int) -> tuple:
        """Node i's C expression on its operands' values, and whether it
        is canonical."""
        kind, a, b = self.graph.ops[i]
        x = self.value(a)
        if kind in ct.BINARY:
            y = self.value(b)
            ca, cb = self.canon[a], self.canon[b]
        if kind == "mul":
            return f"gl::mul_lazy({x}, {y})", False
        if kind == "add" and (ca or cb):
            return (f"gl::add_lazy({y}, {x})" if ca
                    else f"gl::add_lazy({x}, {y})"), False
        if kind == "add":
            return f"gl::add_ll({x}, {y})", False
        if kind == "sub":
            return (f"gl::sub({x}, {y})" if cb
                    else f"gl::sub_ll({x}, {y})"), ca and cb
        if kind == "neg":
            return (f"gl::sub(0, {x})" if self.canon[a]
                    else f"gl::sub_ll(0, {x})"), self.canon[a]
        # ieq: the one operand that must be canonical
        x = x if self.canon[a] else f"gl::canonical({x})"
        return f"qk::ieq({x}, qk_c[{b}])", True

    def compute(self, i: int) -> None:
        self._let(i, *self._op(i))


# the operations a sum of products folds together
_SUMS = ("add", "sub", "neg")


def _forms(graph: ct.Graph, sl: ct.Slice) -> dict:
    """The slice's sums of products: {root: (terms, folded nodes)}, a root
    being a sum, difference or negation whose value the row needs, its
    terms [(sign, node, product?)] what its single-use sums, differences,
    negations and products reach, where that is two products or more (a
    product then costs its 128-bit product and three additions, and the
    sum one or two reductions, against a reduction per product and a lazy
    sum each)."""
    mine = set(sl.nodes)
    uses, consumer = {}, {}
    for v in sl.nodes:
        for x in ct.operands(graph.ops[v]):
            uses[x] = uses.get(x, 0) + 1
            consumer[x] = v
    for x in [o for _, o in sl.terms] + sl.stores:
        uses[x] = uses.get(x, 0) + 1

    def folds(x):
        return (x in mine and x in consumer and uses[x] == 1
                and graph.ops[consumer[x]][0] in _SUMS)

    forms = {}
    for r in sl.nodes:
        if graph.ops[r][0] not in _SUMS or folds(r):
            continue
        terms, folded, stack = [], [], [(r, 1)]
        while stack:
            x, sign = stack.pop()
            kind, a, b = graph.ops[x]
            if x == r or (kind in _SUMS and folds(x)):
                folded.append(x)
                stack += {"add": [(b, sign), (a, sign)],
                          "sub": [(b, -sign), (a, sign)],
                          "neg": [(a, -sign)]}[kind]
            elif kind == "mul" and folds(x):
                folded.append(x)
                terms.append((sign, x, True))
            else:
                terms.append((sign, x, False))
        if sum(product for _, _, product in terms) >= 2:
            forms[r] = (terms, folded)
    return forms


def _form(row: _Row, r: int, terms: list) -> None:
    """Root r's sum of products: the 128-bit products and 64-bit values it
    adds summed unreduced into one 160-bit sum (gl::acc_add), those it
    takes off into another, each reduced once, and the second taken from
    the first (a single value taken off is taken off as it is)."""
    graph = row.graph

    def term(x, product):
        if product:
            _, a, b = graph.ops[x]
            return f"gl::mul_wide({row.value(a)}, {row.value(b)})"
        return f"gl::u128{{{row.value(x)}, 0}}"

    def total(name, part):
        row.lines.append(f"  gl::u160 {name}{{0, 0, 0}};")
        for x, product in part:
            row.lines.append(f"  gl::acc_add({name}, {term(x, product)});")
        return f"gl::reduce160_lazy({name})"

    plus = [(x, product) for sign, x, product in terms if sign > 0]
    minus = [(x, product) for sign, x, product in terms if sign < 0]
    added = total(f"f{r}", plus) if plus else "0"
    if not minus:
        row._let(r, added, False)
    elif len(minus) == 1 and not minus[0][1]:
        row._let(r, f"gl::sub_ll({added}, {row.value(minus[0][0])})", False)
    else:
        row._let(r, f"gl::sub_ll({added}, {total(f'g{r}', minus)})", False)


def _row_function(k6: "Kernels", s: int) -> list:
    """Slice s's row function: its nodes in the plan's order (a sum of
    products as one 160-bit sum, _forms), each stored
    value written to its scratch column as it is made, each constraint
    times its power of each alpha added unreduced into a 160-bit sum per
    alpha as it is made (gl::acc_add); at the end one reduction per alpha,
    the earlier slices' accumulators (the sum's start), the Z_H^{-1}
    product in the last slice, and the accumulators written canonical."""
    graph, p = k6.graph, k6.plan
    sl = p.slices[s]
    first, last = s == 0, s == len(p.slices) - 1
    alphas = range(graph.num_alphas)
    k = len(graph.outputs)
    row = _Row(k6)
    lines = [f"__device__ __forceinline__ void row{s}(const qk::Args& a, "
             f"const int64_t i) {{"]
    leaves = [x for v in sl.nodes for x in ct.operands(graph.ops[v])]
    leaves += sl.loads + [o for _, o in sl.terms]
    if any(graph.ops[x][0] in ("nv", "zn") for x in leaves):
        lines.append("  const int64_t j = qk::next_row(a, i);")
    touches = first or last or bool(sl.terms)
    if touches:
        lines += [f"  gl::u160 u{r}{{" + ("0" if first else
                                          f"a.acc[{r} * a.m + i]")
                  + ", 0, 0};" for r in alphas]
    terms = {}
    for j, o in sl.terms:
        terms.setdefault(o, []).append(j)
    stores = set(sl.stores)

    def add_terms(o):
        for j in terms.pop(o, ()):
            row.lines += [
                f"  gl::acc_add(u{r}, gl::mul_wide({row.value(o)}, "
                f"qk_c[{k6.npool + k6.nbank + r * k + k - 1 - j}]));"
                for r in alphas]

    for o in [o for o in terms if not ct._computing(graph, o)]:
        add_terms(o)
    forms = _forms(graph, sl)
    folded = {x for r, (_, nodes) in forms.items() for x in nodes if x != r}
    for t, v in enumerate(sl.nodes):
        row.t = t
        if v in folded:
            continue
        if v in forms:
            _form(row, v, forms[v][0])
        else:
            row.compute(v)
        if v in stores:
            row.lines.append(f"  a.scr[{p.columns[v]} * a.m + i] = v{v};")
        add_terms(v)
    lines += row.lines
    if touches:
        lines += [f"  uint64_t acc{r} = gl::reduce160_lazy(u{r});"
                  for r in alphas]
    if last:
        lines.append("  const uint64_t zh = "
                     "qk::load(a.zh_inv + i * a.zh_stride);")
        lines += [f"  acc{r} = gl::mul_lazy(acc{r}, zh);" for r in alphas]
    if touches:
        lines += [f"  a.acc[{r} * a.m + i] = gl::canonical(acc{r});"
                  for r in alphas]
    lines.append("}")
    return lines


def _uniform_function(k6: "Kernels") -> list:
    """The uniform nodes as one thread makes them once per class (in
    qk::prepare), canonical, and the published ones written to the
    constant table's end."""
    graph = k6.graph
    lines = ["struct Uniform {",
             "  __device__ void operator()(const uint64_t* pool, "
             "const uint64_t* bank,",
             "                             uint64_t* out) const {",
             "    (void)pool; (void)bank; (void)out;"]

    def value(i):
        kind, x, _ = graph.ops[i]
        return {"bank": f"bank[{x}]", "const": f"pool[{x}]",
                "lit": f"{x:#x}ull"}.get(kind, f"u{i}")

    for i in graph.uniform:
        kind, a, b = graph.ops[i]
        x = value(a)
        text = {"add": lambda: f"gl::add({x}, {value(b)})",
                "sub": lambda: f"gl::sub({x}, {value(b)})",
                "mul": lambda: f"gl::mul({x}, {value(b)})",
                "neg": lambda: f"gl::sub(0, {x})",
                "ieq": lambda: f"qk::ieq({x}, pool[{b}])"}[kind]()
        lines.append(f"    const uint64_t u{i} = {text};")
    lines += [f"    out[{n}] = u{i};" for n, i in enumerate(graph.published)]
    return lines + ["  }", "};", ""]


def source(k6: "Kernels") -> str:
    """The CUDA source of a table's plan: per slice its row function and
    kernel, the constant table qk_c ([pool | bank | alpha_r^t]) and the C
    entry points."""
    graph, p = k6.graph, k6.plan
    lines = ["// Generated by olavm_tpu_torch/stark/constraint_codegen.py "
             "from a",
             f"// constraint tape: {len(graph.ops)} operations after folding, "
             f"{len(graph.outputs)} constraints, {k6.npool} constants "
             f"({len(graph.folded)} baked in),",
             f"// {len(p.slices)} slices, {p.scratch} scratch columns.",
             '#include "constraints.cuh"', "",
             f"constexpr int QK_POOL = {k6.npool}, QK_BANK = {k6.nbank}, "
             f"QK_ALPHAS = {graph.num_alphas}, QK_K = {len(graph.outputs)},",
             f"              QK_UNIFORM = {len(graph.published)};",
             "// the pool, the bank, alpha_r^t at r * QK_K + t, then the "
             "uniform values",
             "// (qk::prepare)",
             "__constant__ uint64_t qk_c[QK_POOL + QK_BANK + QK_ALPHAS * QK_K "
             "+ QK_UNIFORM];",
             "", *_uniform_function(k6)]
    for s in range(len(p.slices)):
        lines += _row_function(k6, s)
        lines += [f"QK_SLICE_KERNEL({s})", ""]
    lines += [f'extern "C" int qk_slices() {{ return {len(p.slices)}; }}', "",
              'extern "C" int qk_prepare(const void* pool, const void* bank, '
              "void* cst,",
              "                          void* stream) {",
              "  return qk::prepare<Uniform>(",
              "      qk_c, static_cast<const uint64_t*>(pool), QK_POOL,",
              "      static_cast<const uint64_t*>(bank), QK_BANK, QK_ALPHAS, "
              "QK_K, QK_UNIFORM,",
              "      static_cast<uint64_t*>(cst), stream);",
              "}", "",
              'extern "C" int qk_launch(int slice, const void* lv, '
              "const void* nv, const void* zl,",
              "                         const void* zn, const void* sel, "
              "void* acc, void* scr,",
              "                         const void* zh_inv, int64_t m, "
              "int64_t nshift, int64_t zh_stride,",
              "                         void* stream) {",
              "  const qk::Args a{",
              "      static_cast<const uint64_t*>(lv), "
              "static_cast<const uint64_t*>(nv),",
              "      static_cast<const uint64_t*>(zl), "
              "static_cast<const uint64_t*>(zn),",
              "      static_cast<const uint64_t*>(sel), "
              "static_cast<uint64_t*>(acc),",
              "      static_cast<uint64_t*>(scr), "
              "static_cast<const uint64_t*>(zh_inv), m, nshift,",
              "      zh_stride, 0};",
              "  (void)stream;",
              "  switch (slice) {"]
    lines += [f"    case {s}: QK_LAUNCH({s}); break;"
              for s in range(len(p.slices))]
    lines += ["    default: return -1;", "  }", "  return QK_STATUS();", "}",
              "",
              'extern "C" int qk_occupancy(int slice, int* blocks) {',
              "  switch (slice) {"]
    lines += [f"    case {s}: return QK_OCCUPANCY({s});"
              for s in range(len(p.slices))]
    lines += ["    default: return -1;", "  }", "}", ""]
    return "\n".join(lines)


class Kernels:
    """One table's K6: its tape, the tape lowered (folded, each operation
    once), its plan of slices, source and library name."""

    def __init__(self, table: str, tape: ct.Tape, budget: int = ct.SLICE_OPS,
                 live: int = ct.SLICE_LIVE, recompute: int = ct.RECOMPUTE_OPS):
        self.table = table
        self.tape = tape
        self.graph = ct.lower(tape)
        # the text bakes these slots' values in: the pool it is launched
        # with (always this tape's, prover_device) must hold them
        moved = {s: v for s, v in self.graph.folded.items()
                 if tape.pool[s] != v}
        if moved:
            raise ValueError(f"K6 {table}: pool slots {moved} differ from "
                             f"the values folded into the text")
        self.plan = ct.plan(self.graph, budget, live, recompute)
        # the rows of each input the tape reads
        self.need = {"lv": 0, "nv": 0, "zl": 0, "zn": 0, "sel": 3, "bank": 0}
        for kind, x, _ in tape.ops:
            if kind in self.need:
                self.need[kind] = max(self.need[kind], x + 1)
        self.npool, self.nbank = len(tape.pool), self.need["bank"]
        # the constant table: pool, bank, alpha powers, uniform values
        self.ubase = (self.npool + self.nbank
                      + tape.num_alphas * len(tape.outputs))
        self.upos = {i: n for n, i in enumerate(self.graph.published)}
        self.nconst = self.ubase + len(self.upos)
        if self.nconst > CONST_WORDS:
            raise ValueError(f"K6 {table}: {self.nconst} constants, more "
                             f"than constant memory's {CONST_WORDS}")
        self.text = source(self)
        self.name = kernels.generated_name("k6", self.text)

    def library(self) -> ctypes.CDLL:
        try:
            return kernels.generated(self.name, self.text, SIGNATURES)
        except RuntimeError as e:
            raise RuntimeError(f"K6 build for {self.table} "
                               f"({len(self.plan.slices)} slices) failed: "
                               f"{e}") from e

    def occupancy(self) -> list:
        """Blocks of qk::THREADS that an SM holds at once, per slice (a
        query of the card's runtime)."""
        lib, out, blocks = self.library(), [], ctypes.c_int(0)
        for k in range(len(self.plan.slices)):
            kernels.check(lib.qk_occupancy(k, ctypes.byref(blocks)),
                          f"K6 {self.table} occupancy of slice {k}")
            out.append(blocks.value)
        return out

    def launch_all(self, lib, inp: ct.Inputs, acc: torch.Tensor,
                   stream) -> None:
        """The constant table (qk_prepare: the pool, the bank and the
        alphas' powers into qk_c), then every slice in order into `acc`
        (each launch raises with its slice on a nonzero status). `stream`
        None: `lib` is the source built for the host (the tests' g++
        build), which launches no kernel and counts none."""
        device = acc.device
        cst = torch.empty(self.nconst, dtype=torch.int64, device=device)
        scr = torch.empty((max(self.plan.scratch, 1), inp.rows),
                          dtype=torch.int64, device=device)
        n = len(self.plan.slices)
        rc = lib.qk_prepare(inp.pool.data_ptr(), inp.bank.data_ptr(),
                            cst.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"K6 {self.table} constants ({n} slices): "
                               f"CUDA error {rc}")
        if stream is not None:
            kernels.count("constraints")
        ptrs = [t.data_ptr() for t in (inp.lv, inp.nv, inp.zl, inp.zn,
                                       inp.sel, acc, scr, inp.zh_inv)]
        zh_stride = 0 if inp.zh_inv.numel() == 1 else 1
        for k in range(n):
            rc = lib.qk_launch(k, *ptrs, inp.rows, inp.nshift, zh_stride,
                               stream)
            if rc != 0:
                raise RuntimeError(f"K6 {self.table} slice {k} of {n}: "
                                   f"CUDA error {rc}")
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
        return ct.evaluate_plain(k6.plan, inp)
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


# the coset scaling (gl_scale_powers) lives in the field layer, which
# ntt/ntt.py's coset transforms share; its names stay here for the quotient
from ..field.gf import scale_powers, scale_powers_plain  # noqa: E402,F401


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
    xs = gf.mul_plain(gf.powers_plain(gf.scalar(gen, device),
                                      1 << degree_bits),
                      cls[0])
    lagrange_first = gf.mul_plain(
        cls[1], _inv_plain(gf.sub_plain(xs, gf.scalar(1, device))))
    z_last = gf.sub_plain(xs, gf.scalar(g.inv(gen), device))
    lagrange_last = gf.mul_plain(cls[2], _inv_plain(z_last))
    return torch.stack([z_last, lagrange_first, lagrange_last])
