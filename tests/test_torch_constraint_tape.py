"""K6, the quotient's fused constraint kernels, on the CPU.

Each table's constraint code (eval_packed, the permutation and CTL checks)
is recorded as a tape (olavm_tpu_torch/stark/constraint_tape.py) and cut
into slices; a CUDA source is generated from it
(olavm_tpu_torch/stark/constraint_codegen.py). Here, on the inputs that
tests/test_torch_quotient_tables.py draws with numpy at degree 2^4:

- the slices' plain version equals quotient_class_ops (the op-by-op
  quotient) on every class of all 12 tables, and on one class at slices of
  one constraint each and at one slice of the whole sequence (tolerance 0:
  field arithmetic); test_torch_quotient_tables.py holds the same path
  against olavm_tpu;
- the generated source, compiled by g++ with the CUDA qualifiers stubbed
  (its row functions run on the host), equals quotient_class_ops for four
  tables, and csrc/quotient.cu's coset scaling and selector kernels, so
  built, equal their plain versions;
- the source is the same text under other compress challenges and banks,
  and the prebuild's sources are those of a prove's;
- a failed build or launch raises with the table and the slice, and a
  tape value refuses every operation outside the Ops interface.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from olavm_tpu_torch import convert, kernels
from olavm_tpu_torch.field import gf
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
HOST_TABLES = ["CpuStark", "PoseidonStark", "StorageAccessStark",
               "SCCallStark"]


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


@pytest.mark.parametrize("table", range(len(TABLES)), ids=TABLES)
def test_slices_equal_quotient_class_ops_on_every_class(table):
    case = stark, coeffs, zs, bank, static, qdb = _case(table)
    assert type(stark).__name__ == TABLES[table]
    k6 = _k6(case)
    assert k6.cuts[0][0] == 0 and k6.cuts[-1][1] == len(k6.tape.outputs)
    assert all(a < b == c for (a, b), (c, _) in zip(k6.cuts, k6.cuts[1:]))
    for r in range(1 << qdb):
        cls = tpd.class_constants(DEGREE_BITS, qdb, r, "cpu")
        want = tpd.quotient_class_ops(stark, coeffs, zs, cls, bank, **static)
        got = tpd.quotient_class(stark, coeffs, zs, cls, bank, **static)
        assert got.shape == want.shape == (2, 1 << DEGREE_BITS)
        assert want.any()
        assert torch.equal(got, want), f"class {r}"


@pytest.mark.parametrize("table", ["CpuStark", "PoseidonStark", "MemoryStark",
                                   "StorageAccessStark"])
def test_slices_of_any_length_give_the_same_quotient(table):
    case = stark, coeffs, zs, bank, static, qdb = _case(TABLES.index(table))
    tape = _k6(case).tape
    cls = tpd.class_constants(DEGREE_BITS, qdb, 1, "cpu")
    want = tpd.quotient_class_ops(stark, coeffs, zs, cls, bank, **static)
    inp = tpd.quotient_inputs(coeffs, zs, cls, bank,
                              gf.from_u64(tape.pool, "cpu"))
    for budget, count in ((1, len(tape.outputs)), (10**9, 1), (300, None)):
        k6 = cg.Kernels(table, tape, budget)
        assert len(k6.cuts) == (count or len(k6.cuts))
        assert torch.equal(cg.evaluate(k6, inp), want), f"budget {budget}"


@pytest.mark.parametrize("table", range(len(TABLES)), ids=TABLES)
def test_source_does_not_depend_on_the_challenges(table):
    one, two = _case(table, 4), _case(table, 5)
    # other compress challenges, banks and shapes: the same text
    assert one[4]["perm_meta"] == two[4]["perm_meta"]
    a, b = _k6(one), _k6(two)
    assert a.text == b.text and a.name == b.name
    assert len(a.tape.pool) == len(b.tape.pool)
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


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """The four tables' generated sources built by g++ (all at once)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("k6_host")
    (d / "stub.h").write_text(STUB)
    procs = {}
    for name in HOST_TABLES:
        k6 = _k6(_case(TABLES.index(name)))
        (d / f"{name}.cpp").write_text(k6.text)
        procs[name] = (k6, subprocess.Popen(
            ["g++", "-O1", "-std=c++17", "-shared", "-fPIC",
             "-Wno-unknown-pragmas", "-I", str(kernels.CSRC), "-include",
             str(d / "stub.h"), str(d / f"{name}.cpp"), "-o",
             str(d / f"lib{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (k6, proc) in procs.items():
        out, _ = proc.communicate()
        assert proc.returncode == 0, out.decode()[-4000:]
        lib = ctypes.CDLL(str(d / f"lib{name}.so"))
        for fn, argtypes in cg.SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (k6, lib)
    return libs


STUB = """
#define __device__
#define __host__
#define __forceinline__ inline
"""


@pytest.mark.parametrize("table", HOST_TABLES)
def test_generated_rows_built_by_gxx_equal_quotient_class_ops(host_libs, table):
    k6, lib = host_libs[table]
    stark, coeffs, zs, bank, static, qdb = _case(TABLES.index(table))
    assert lib.qk_slices() == len(k6.cuts)
    for r in (0, (1 << qdb) - 1):
        cls = tpd.class_constants(DEGREE_BITS, qdb, r, "cpu")
        want = tpd.quotient_class_ops(stark, coeffs, zs, cls, bank, **static)
        inp = cg._contiguous(tpd.quotient_inputs(
            coeffs, zs, cls, bank, gf.from_u64(k6.tape.pool, "cpu")))
        acc = torch.full(want.shape, -1, dtype=torch.int64)
        k6.launch_all(lib, inp, acc, None)
        assert torch.equal(acc, want), f"class {r}"
    assert lib.qk_launch(len(k6.cuts), *([None] * 9), 0, 0, 0, None) == -1


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
    def qk_launch(self, slice_index, *args):
        return 700 if slice_index == 1 else 0


def test_failed_launch_raises_with_the_slice():
    case = stark, coeffs, zs, bank, static, qdb = _case(TABLES.index("CpuStark"))
    k6 = _k6(case)
    assert len(k6.cuts) > 1
    inp = tpd.quotient_inputs(coeffs, zs,
                              tpd.class_constants(DEGREE_BITS, qdb, 0, "cpu"),
                              bank, gf.from_u64(k6.tape.pool, "cpu"))
    acc = torch.empty((2, 1 << DEGREE_BITS), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="K6 CpuStark slice 1 of .*error 700"):
        k6.launch_all(_FailingLibrary(), inp, acc, 1)


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
    x = tape.input("lv", 0)
    y = F.scalar_mul(F.add(x, x), 3)
    tape.outputs += [F.scalar_mul(y, 1).index, F.scalar_mul(y, 0).index,
                     F.mul(y, y).index]
    # the union cone: add, the product by 3 and y * y; the products by a
    # pooled 1 and 0 are not needed; Horner: 3 constraints x 2 alphas,
    # and Z_H^{-1} once per alpha
    assert ct.required_ops(tape) == {"add": 1 + 6, "sub": 0,
                                     "mul": 2 + 6 + 2, "neg": 0, "ieq": 0}
    # one slice per constraint recomputes the shared cone in each
    run = [ct.slice_ops(tape, j, j + 1) for j in range(3)]
    assert sum(r["add"] for r in run) == 3 + 6
    assert sum(r["mul"] for r in run) == 3 * 2 + 6 + 2
