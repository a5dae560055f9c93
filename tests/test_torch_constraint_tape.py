"""K6, the quotient's fused constraint kernels, on the CPU.

Each table's constraint code (eval_packed, the permutation and CTL checks)
is recorded as a tape (olavm_tpu_torch/stark/constraint_tape.py), lowered
(products by a pooled 0 or 1 folded, each operation made once) and planned
as slices that store what later slices read; a CUDA source is generated
from the plan (olavm_tpu_torch/stark/constraint_codegen.py). Here, on the
inputs that tests/test_torch_quotient_tables.py draws with numpy at degree
2^4, and on coefficients whose values on a class's coset are edge values
(chip_smoke.EDGE_VALUES: 0, 1, p - 1, 2^32, EPSILON, ...):

- the slices' plain version equals quotient_class_ops (the op-by-op
  quotient) on every class of all 12 tables, and on one class at other
  slice budgets and recompute limits (tolerance 0: field arithmetic);
  test_torch_quotient_tables.py holds the same path against olavm_tpu;
- the generated source of every table, compiled by g++ with the CUDA
  qualifiers stubbed (its row functions run on the host through the lazy
  helpers' C++ twins), equals quotient_class_ops on every class, and the
  edge values drive its lazy intermediates to 2^64 - 1; the lazy helpers
  themselves equal Python's residues on every pair of edge words, and
  csrc/quotient.cu's coset scaling and selector kernels, so built, equal
  their plain versions;
- the slices run what the quotient needs within a few percent, no product
  by a folded 0 or 1, and no canonical reduction but at ieq operands and
  the written accumulators;
- the source is the same text under other compress challenges and banks,
  and the prebuild's sources are those of a prove's;
- a failed build or launch raises with the table and the slice, and a
  tape value refuses every operation outside the Ops interface.
"""

import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from olavm_tpu_torch import convert, kernels
from olavm_tpu_torch.field import gf
from olavm_tpu_torch.field import goldilocks as g
from olavm_tpu_torch.ntt import ntt as dntt
from olavm_tpu_torch.stark import constraint_codegen as cg
from olavm_tpu_torch.stark import constraint_tape as ct
from olavm_tpu_torch.stark import prover_device as tpd
from olavm_tpu_torch.stark.config import StarkConfig
from olavm_tpu_torch.stark.cross_table_lookup import CtlData, CtlZData
from olavm_tpu_torch.stark.stark_base import GrandProductChallenge
from olavm_tpu_torch.tables.ola_stark import OlaStark
from test_torch_quotient_tables import TABLES, _ctl_data, _draw
import torch_threads  # noqa: F401  (torch's share of the cores)

DEGREE_BITS = 4


@functools.lru_cache(maxsize=None)
def _case(table: int, degree_bits: int = DEGREE_BITS):
    """The port's quotient inputs from _draw: (stark, coefficients, Z
    coefficients, bank, static metadata, quotient degree bits)."""
    d = _draw(table, degree_bits)
    config = StarkConfig.standard_fast_config()
    ola = OlaStark()
    ola.set_compress_challenges(d["compress"])
    stark = ola.starks[table]
    perm = None
    if d["perm_sets"] is not None:
        perm = [[GrandProductChallenge(*c) for c in s] for s in d["perm_sets"]]
    ctl_data = _ctl_data(ola, d["views"], d["ctl_challenges"], CtlData,
                         CtlZData, GrandProductChallenge)
    values, perm_meta, ctl_offsets = tpd.quotient_bank(
        stark, config, d["alphas"], perm, ctl_data)
    static = {"num_alphas": len(d["alphas"]), "perm_meta": perm_meta,
              "ctl_views": [(zc.columns, zc.filter_column)
                            for zc in ctl_data.zs_columns],
              "ctl_offsets": ctl_offsets,
              "num_permutation_zs": d["num_perm_zs"]}
    return (stark, convert.from_u64(d["trace"], "cpu"),
            convert.from_u64(d["zs"], "cpu"), gf.from_u64(values, "cpu"),
            static, tpd.quotient_degree_bits(stark, config))


def _k6(case) -> cg.Kernels:
    stark, coeffs, zs, _, static, _ = case
    return tpd.quotient_kernels(stark, coeffs.shape[0], zs.shape[0], **static)


@functools.lru_cache(maxsize=None)
def _class(table: int, r: int, edge: bool):
    """Class r's coefficients, constants and quotient_class_ops' values:
    the drawn coefficients, or (edge) coefficients whose values on the
    class's coset are edge values."""
    stark, coeffs, zs, bank, static, qdb = _case(table)
    cls = tpd.class_constants(DEGREE_BITS, qdb, r, "cpu")
    if edge:
        rng = np.random.default_rng(100 * table + r)
        shift = int(cls[0]) % (1 << 64)
        coeffs, zs = (dntt.coset_ifft(convert.from_u64(
            chip_smoke.edge_values(rng, tuple(x.shape)), "cpu"), shift)
            for x in (coeffs, zs))
    want = tpd.quotient_class_ops(stark, coeffs, zs, cls, bank, **static)
    return coeffs, zs, cls, want


def _classes(qdb: int):
    """Every class at the drawn values, the first and last at edge values."""
    last = (1 << qdb) - 1
    return [(r, False) for r in range(last + 1)] + sorted(
        {(0, True), (last, True)})


@pytest.mark.parametrize("table", range(len(TABLES)), ids=TABLES)
def test_slices_equal_quotient_class_ops_on_every_class(table):
    case = stark, _, _, bank, static, qdb = _case(table)
    assert type(stark).__name__ == TABLES[table]
    k6 = _k6(case)
    # every constraint not folded to 0 enters one slice once; every node
    # of the graph is computed in a slice, or once a class (uniform)
    graph, slices = k6.graph, k6.plan.slices
    assert sorted(j for sl in slices for j, _ in sl.terms) == [
        j for j, o in enumerate(graph.outputs)
        if graph.ops[o] != ("lit", 0, None)]
    computed = {v for sl in slices for v in sl.nodes}
    needed = {v for v in ct.cone(graph, graph.outputs)
              if graph.ops[v][0] in ct.COMPUTE}
    assert needed - set(graph.uniform) == computed == needed & graph.per_row
    for r, edge in _classes(qdb):
        coeffs, zs, cls, want = _class(table, r, edge)
        got = tpd.quotient_class(stark, coeffs, zs, cls, bank, **static)
        assert got.shape == want.shape == (2, 1 << DEGREE_BITS)
        assert want.any()
        assert torch.equal(got, want), f"class {r}, edge values {edge}"


@pytest.mark.parametrize("table", ["CpuStark", "PoseidonStark", "MemoryStark",
                                   "StorageAccessStark"])
def test_slices_of_any_length_give_the_same_quotient(table):
    case = stark, coeffs, zs, bank, static, qdb = _case(TABLES.index(table))
    tape = _k6(case).tape
    graph = _k6(case).graph
    computing = len(ct.cone(graph, graph.outputs) & graph.per_row)
    cls = tpd.class_constants(DEGREE_BITS, qdb, 1, "cpu")
    want = tpd.quotient_class_ops(stark, coeffs, zs, cls, bank, **static)
    inp = tpd.quotient_inputs(coeffs, zs, cls, bank,
                              gf.from_u64(tape.pool, "cpu"))
    # (budget, live values, recompute limit, slices): one node a slice,
    # recomputing small cones; one slice; storing every value a later
    # slice reads; recomputing every one; cut by pressure alone
    live = ct.SLICE_LIVE
    for budget, most, recompute, count in (
            (1, live, ct.RECOMPUTE_OPS, computing), (10**9, 10**9, 0, 1),
            (300, live, 0, None), (300, 10**9, 10**9, None),
            (10**9, 8, ct.RECOMPUTE_OPS, None)):
        k6 = cg.Kernels(table, tape, budget, most, recompute)
        assert len(k6.plan.slices) == (count or len(k6.plan.slices))
        if recompute == 10**9 or count == 1:
            assert k6.plan.scratch == 0
        assert torch.equal(cg.evaluate(k6, inp), want), (budget, recompute)


@pytest.mark.parametrize("table", range(len(TABLES)), ids=TABLES)
def test_source_does_not_depend_on_the_challenges(table):
    one, two = _case(table, 4), _case(table, 5)
    # other compress challenges, banks and shapes: the same text
    assert one[4]["perm_meta"] == two[4]["perm_meta"]
    a, b = _k6(one), _k6(two)
    assert a.text == b.text and a.name == b.name
    assert len(a.tape.pool) == len(b.tape.pool)
    # the text bakes in the same pooled 0s and 1s under both draws
    assert a.graph.folded and a.graph.folded == b.graph.folded
    if TABLES[table] in ("ProgramStark", "BitwiseStark"):
        assert a.tape.pool != b.tape.pool


def test_prebuild_sources_are_a_proves():
    # quotient_statics' stand-in challenges give each table the metadata,
    # and so the source, that a prove's challenges give
    ola = OlaStark()
    ola.set_compress_challenges(_draw(0, DEGREE_BITS)["compress"])
    statics = tpd.quotient_statics(ola, StarkConfig.standard_fast_config())
    for table, (stark, n_zs, static, _) in enumerate(statics):
        case = _case(table)
        assert n_zs == case[2].shape[0]
        assert tpd.quotient_kernels(stark, stark.COLUMNS, n_zs,
                                    **static).text == _k6(case).text


def _gxx(d, name: str, text: str, stub: str, extra=()) -> subprocess.Popen:
    """g++ of `text` into d/lib<name>.so, the CUDA qualifiers stubbed."""
    (d / f"{name}.cpp").write_text(text)
    (d / f"{name}_stub.h").write_text(stub)
    return subprocess.Popen(
        ["g++", "-O1", "-std=c++17", "-shared", "-fPIC",
         "-Wno-unknown-pragmas", *extra, "-I", str(kernels.CSRC), "-include",
         str(d / f"{name}_stub.h"), str(d / f"{name}.cpp"), "-o",
         str(d / f"lib{name}.so")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _load(d, name: str, proc: subprocess.Popen) -> ctypes.CDLL:
    out, _ = proc.communicate()
    assert proc.returncode == 0, out.decode()[-4000:]
    return ctypes.CDLL(str(d / f"lib{name}.so"))


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """Every table's generated source built by g++ (all at once), each
    with a watch on its lazy results (STUB)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("k6_host")
    procs = {}
    for table, name in enumerate(TABLES):
        k6 = _k6(_case(table))
        procs[name] = (k6, _gxx(d, name, k6.text, STUB))
    libs = {}
    for name, (k6, proc) in procs.items():
        lib = _load(d, name, proc)
        for fn, argtypes in cg.SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.qk_seen_max.restype = lib.qk_seen_lazy.restype = ctypes.c_uint64
        libs[name] = (k6, lib)
    return libs


# the CUDA qualifiers stubbed, and every lazy result of the host twins
# watched: the largest, and how many were not canonical
STUB = """
#include <cstdint>
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
static uint64_t seen_max, seen_lazy;
static inline uint64_t seen(uint64_t x) {
  if (x > seen_max) seen_max = x;
  if (x >= 0xFFFFFFFF00000001ull) ++seen_lazy;
  return x;
}
#define GL_LAZY_SEEN(x) seen(x)
extern "C" uint64_t qk_seen_max() { return seen_max; }
extern "C" uint64_t qk_seen_lazy() { return seen_lazy; }
extern "C" void qk_seen_reset() { seen_max = seen_lazy = 0; }
"""


@pytest.mark.parametrize("table", TABLES)
def test_generated_rows_built_by_gxx_equal_quotient_class_ops(host_libs, table):
    k6, lib = host_libs[table]
    _, _, _, bank, _, qdb = _case(TABLES.index(table))
    assert lib.qk_slices() == len(k6.plan.slices)
    seen = 0
    for r, edge in _classes(qdb):
        coeffs, zs, cls, want = _class(TABLES.index(table), r, edge)
        inp = cg._contiguous(tpd.quotient_inputs(
            coeffs, zs, cls, bank, gf.from_u64(k6.tape.pool, "cpu")))
        acc = torch.full(want.shape, -1, dtype=torch.int64)
        lib.qk_seen_reset()
        k6.launch_all(lib, inp, acc, None)
        assert torch.equal(acc, want), f"class {r}, edge values {edge}"
        if edge:
            seen = max(seen, lib.qk_seen_max())
    # the edge values drive the lazy results to 2^64 - 1, but in three
    # tables whose constraints add no two values they set to p - 1 and
    # EPSILON (test_lazy_helpers_built_by_gxx_equal_python holds every
    # helper at 2^64 - 1)
    if table not in ("CmpStark", "SCCallStark", "ProgramStark"):
        assert seen == (1 << 64) - 1
    assert lib.qk_launch(len(k6.plan.slices), *([None] * 8), 0, 0, 0,
                         None) == -1


# words around the lazy arithmetic's edges, canonical or not
WORDS = sorted({0, 1, 2, g.P - 2, g.P - 1, g.P, g.P + 1, 1 << 32,
                g.EPSILON, (1 << 32) + 1, 1 << 63, (1 << 64) - g.EPSILON,
                (1 << 64) - 2, (1 << 64) - 1, 0x123456789ABCDEF0})

LAZY_DRIVER = """
#include "goldilocks.cuh"
extern "C" void lazy_ops(const uint64_t* a, const uint64_t* b, int64_t n,
                         uint64_t* out) {
  for (int64_t t = 0; t < n; ++t) {
    uint64_t* o = out + 9 * t;
    o[0] = gl::add_ll(a[t], b[t]);
    o[1] = gl::sub_ll(a[t], b[t]);
    o[2] = gl::mul_lazy(a[t], b[t]);
    o[3] = gl::add_lazy(a[t], gl::canonical(b[t]));
    o[4] = gl::sub(a[t], gl::canonical(b[t]));
    o[5] = gl::canonical(a[t]);
    gl::u160 u{a[t], 0, 0};
    for (int k = 0; k < 3; ++k) gl::acc_add(u, gl::mul_wide(a[t], b[t]));
    o[6] = gl::reduce160_lazy(u);
    o[7] = gl::canonical(gl::add_ll(gl::sub_ll(0, a[t]), a[t]));
    // b - a * b - a, as a sum of products takes off two terms
    gl::u160 v{0, 0, 0}, w{0, 0, 0};
    gl::acc_add(v, gl::u128{b[t], 0});
    gl::acc_add(w, gl::mul_wide(a[t], b[t]));
    gl::acc_add(w, gl::u128{a[t], 0});
    o[8] = gl::sub_ll(gl::reduce160_lazy(v), gl::reduce160_lazy(w));
  }
}
"""


def test_lazy_helpers_built_by_gxx_equal_python(tmp_path):
    """goldilocks.cuh's lazy helpers (their C++ twins) on every pair of
    WORDS: each result is the residue Python gives, below 2^64."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    lib = _load(tmp_path, "lazy", _gxx(tmp_path, "lazy", LAZY_DRIVER,
                                        STUB.split("static uint64_t")[0]))
    pairs = [(x, y) for x in WORDS for y in WORDS]
    a = np.array([x for x, _ in pairs], dtype=np.uint64)
    b = np.array([y for _, y in pairs], dtype=np.uint64)
    out = np.zeros(9 * len(pairs), dtype=np.uint64)
    vp = ctypes.c_void_p
    lib.lazy_ops.argtypes = [vp, vp, ctypes.c_int64, vp]
    lib.lazy_ops(a.ctypes.data, b.ctypes.data, len(pairs), out.ctypes.data)
    p = g.P
    for t, (x, y) in enumerate(pairs):
        want = [(x + y) % p, (x - y) % p, x * y % p, (x + y) % p,
                (x - y) % p, x % p, (x + 3 * x * y) % p, 0,
                (y - x * y - x) % p]
        got = [int(v) for v in out[9 * t:9 * t + 9]]
        assert [v % p for v in got] == want, (x, y)
        assert got[5] < p and got[7] < p
        if x < p and y < p:
            # the canonical forms of sub and canonical stay canonical
            assert got[4] < p


QUOTIENT_STUB = """
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
struct HostDim { unsigned x; };
static HostDim blockIdx, blockDim, threadIdx, gridDim;
template <class T> static inline T __ldg(const T* p) { return *p; }
"""

# every (block, thread) of each launch of csrc/quotient.cu, in turn
QUOTIENT_DRIVER = """
static void grid(unsigned blocks, unsigned threads, void (*run)()) {
  gridDim.x = blocks;
  blockDim.x = threads;
  for (blockIdx.x = 0; blockIdx.x < blocks; ++blockIdx.x)
    for (threadIdx.x = 0; threadIdx.x < threads; ++threadIdx.x) run();
}
static const uint64_t *g_in, *g_base;
static uint64_t *g_out, g_gen, g_gen_inv;
static int64_t g_cols, g_n;
extern "C" void host_scale_powers(const uint64_t* x, uint64_t* out,
                                  const uint64_t* base, int64_t cols,
                                  int64_t n) {
  g_in = x; g_out = out; g_base = base; g_cols = cols; g_n = n;
  grid(gl::grid_for(n, THREADS), THREADS, [] {
    scale_powers_kernel(g_in, g_out, g_base, g_cols, g_n);
  });
}
extern "C" void host_selectors(const uint64_t* cls, uint64_t* out, int64_t n,
                               uint64_t gen, uint64_t gen_inv) {
  g_in = cls; g_out = out; g_n = n; g_gen = gen; g_gen_inv = gen_inv;
  const int64_t threads = (n + SEL_CHUNK - 1) / SEL_CHUNK;
  grid(static_cast<unsigned>((threads + SEL_THREADS - 1) / SEL_THREADS),
       SEL_THREADS, [] {
    selectors_kernel(g_in, g_out, g_n, g_gen, g_gen_inv);
  });
}
"""


@pytest.fixture(scope="module")
def quotient_host(tmp_path_factory):
    """csrc/quotient.cu's two kernels built by g++: their text (the CUDA
    qualifiers and index registers stubbed) with a driver that runs every
    thread of a launch on the host."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    text = (kernels.CSRC / "quotient.cu").read_text()
    start = text.index('#include "goldilocks.cuh"')
    end = text.index("}  // namespace") + len("}  // namespace")
    d = tmp_path_factory.mktemp("quotient_host")
    (d / "stub.h").write_text(QUOTIENT_STUB)
    (d / "quotient_host.cpp").write_text(text[start:end] + QUOTIENT_DRIVER)
    so = d / "libquotienthost.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-I", str(kernels.CSRC),
                    "-include", str(d / "stub.h"),
                    str(d / "quotient_host.cpp"), "-o", str(so)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    vp, i64, u64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64
    lib.host_scale_powers.argtypes = [vp, vp, vp, i64, i64]
    lib.host_selectors.argtypes = [vp, vp, i64, u64, u64]
    lib.host_scale_powers.restype = lib.host_selectors.restype = None
    return lib


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 10])
def test_quotient_cu_built_by_gxx_equals_plain(quotient_host, bits):
    from olavm_tpu_torch.field import goldilocks as g

    n = 1 << bits
    rng = np.random.default_rng(bits)
    x = gf.from_u64(rng.integers(0, gf.P, (3, n), dtype=np.uint64), "cpu")
    gen = g.primitive_root_of_unity(bits)
    for qdb in (1, 3):
        for r in (0, (1 << qdb) - 1):
            cls = tpd.class_constants(bits, qdb, r, "cpu")
            got = torch.full((3, n), -1, dtype=torch.int64)
            quotient_host.host_selectors(cls.data_ptr(), got.data_ptr(), n,
                                         gen, g.inv(gen))
            assert torch.equal(got, cg.selectors_plain(cls, bits)), (qdb, r)
            got = torch.full((3, n), -1, dtype=torch.int64)
            quotient_host.host_scale_powers(x.data_ptr(), got.data_ptr(),
                                            cls.data_ptr(), 3, n)
            assert torch.equal(got, cg.scale_powers_plain(x, cls[0]))


def test_failed_build_raises_with_the_table(tmp_path, monkeypatch):
    stub = tmp_path / "nvcc"
    stub.write_text("#!/bin/sh\necho 'error: refused by the stub'\nexit 1\n")
    stub.chmod(0o755)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(stub))
    k6 = _k6(_case(TABLES.index("CmpStark")))
    with pytest.raises(RuntimeError, match="(?s)K6 build for CmpStark.*refused"):
        k6.library()
    with pytest.raises(RuntimeError, match="(?s)K6 build for CmpStark.*refused"):
        cg.prebuild([k6])
    assert k6.name not in kernels._libs


class _FailingLibrary:
    def __init__(self, prepare: int = 0):
        self.prepare = prepare

    def qk_prepare(self, *args):
        return self.prepare

    def qk_launch(self, slice_index, *args):
        return 700 if slice_index == 1 else 0


def test_failed_launch_raises_with_the_slice():
    case = stark, coeffs, zs, bank, static, qdb = _case(TABLES.index("CpuStark"))
    k6 = _k6(case)
    assert len(k6.plan.slices) > 1
    inp = tpd.quotient_inputs(coeffs, zs,
                              tpd.class_constants(DEGREE_BITS, qdb, 0, "cpu"),
                              bank, gf.from_u64(k6.tape.pool, "cpu"))
    acc = torch.empty((2, 1 << DEGREE_BITS), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="K6 CpuStark slice 1 of .*error 700"):
        k6.launch_all(_FailingLibrary(), inp, acc, 1)
    with pytest.raises(RuntimeError, match="K6 CpuStark constants .*error 1"):
        k6.launch_all(_FailingLibrary(1), inp, acc, 1)


def test_tape_values_refuse_everything_but_the_ops():
    tape = ct.Tape(2)
    F = ct.TapeOps(tape)
    x, y = tape.input("lv", 0), F.constant(3)
    for use in (lambda: x + y, lambda: x * 2, lambda: -x, lambda: x == y,
                lambda: bool(x), lambda: int(x), lambda: np.asarray(x),
                lambda: torch.as_tensor(x), lambda: F.add(x, 1),
                lambda: F.mul(x, torch.ones(())),
                lambda: F.add(x, ct.Tape(2).input("lv", 0)),
                lambda: F.scalar_mul(x, y)):
        with pytest.raises(TypeError):
            use()
    # the ops themselves record, every host integer pooled
    z = F.indicator_eq_const(F.neg(F.scalar_mul(F.sub(x, y), 0)), 7)
    assert tape.ops[z.index][0] == "ieq" and tape.pool == [3, 0, 7]


def test_required_ops_count_each_node_once_and_no_trivial_product():
    tape = ct.Tape(2)
    F = ct.TapeOps(tape)
    x, three = tape.input("lv", 0), F.constant(3)
    y = F.mul(F.add(x, x), three)
    tape.outputs += [F.scalar_mul(y, 1).index, F.scalar_mul(y, 0).index,
                     F.mul(y, y).index, F.mul(F.add(x, x), three).index]
    graph = ct.lower(tape)
    # the product by 1 is y, by 0 a constraint 0; the last repeats y
    assert graph.outputs[0] == graph.outputs[3] != graph.outputs[2]
    assert graph.ops[graph.outputs[1]] == ("lit", 0, None)
    assert graph.folded == {1: 1, 2: 0}
    # the union cone: add, the product by 3 and y * y; three constraints
    # not 0 x 2 alphas, and Z_H^{-1} once per alpha
    assert ct.required_ops(graph) == {"add": 1 + 6, "sub": 0,
                                      "mul": 2 + 6 + 2, "neg": 0, "ieq": 0}
    # one node a slice: recomputing the shared cone in each, or storing
    # what later slices read (x + x for slice 1, y for slice 2)
    run = ct.plan_ops(ct.plan(graph, 1, recompute=4))
    assert (run["add"], run["mul"]) == (3 + 6, 3 + 6 + 2)
    p = ct.plan(graph, 1, recompute=0)
    assert ct.plan_ops(p) == ct.required_ops(graph)
    add = next(i for i, op in enumerate(graph.ops) if op[0] == "add")
    assert [sl.stores for sl in p.slices] == [[add], [graph.outputs[0]], []]
    assert p.scratch == 2


@pytest.mark.parametrize("table", range(len(TABLES)), ids=TABLES)
def test_slices_run_what_the_quotient_needs(table):
    """The slices at SLICE_OPS and SLICE_LIVE hold at most SLICE_LIVE
    values live at once and run the quotient's operations within a few
    percent (the cones they recompute), the graph has no product by a folded 0 or 1, and the row
    functions reduce to canonical only the operands of ieq and the
    accumulators they write."""
    k6 = _k6(_case(table))
    graph = k6.graph
    need, run = ct.required_ops(graph), ct.plan_ops(k6.plan)
    assert all(ct.pressure(graph, sl) <= ct.SLICE_LIVE
               for sl in k6.plan.slices)
    assert all(run[kind] >= need[kind] for kind in ct.COMPUTE)
    assert 1 - sum(need.values()) / sum(run.values()) < 0.04, (need, run)
    trivial = {i for i, op in enumerate(graph.ops)
               if op in (("lit", 0, None), ("lit", 1, None))}
    assert not [op for op in graph.ops
                if op[0] == "mul" and {op[1], op[2]} & trivial]
    assert graph.folded and all(tape_v in (0, 1)
                                for tape_v in graph.folded.values())
    # the row functions (the uniform values, made once a class, come first)
    rows = k6.text[k6.text.index("void row0("):]
    assert "gl::mul(" not in rows and "gl::add(" not in rows
    writes = sum(j == 0 or j == len(k6.plan.slices) - 1 or bool(sl.terms)
                 for j, sl in enumerate(k6.plan.slices))
    ieq = rows.count("qk::ieq(gl::canonical(")
    assert rows.count("gl::canonical(") == ieq + writes * graph.num_alphas
