"""K11 (ctl_combine), the row combination of a CTL Z (csrc/ctl.cu,
stark/ctl_kernels.py), on the CPU, exact throughout (tolerance 0: field
arithmetic has one answer):

- every view of all_cross_table_lookups() fits the kernel's limits, and a
  view past them raises, naming the view;
- ctl_combine_plain for every view, on a random and an edge-value trace of
  its table's width (2^6 and 2^8 rows; filter columns drawn from 0, 1, 2
  and p - 1), equals the op-by-op chain it replaced (ctl_combine_ops), and
  its grand product, each Z, equals olavm_tpu's ctl_z_device on the CPU;
- the plain version against Python ints on views with constants, p - 1
  coefficients and a filter of 1 - x;
- csrc/ctl.cu built by g++ (the CUDA qualifiers stubbed, every thread of a
  launch run on the host) equals the plain version for every view, at row
  counts that are not a multiple of a block's rows, and past one row a
  thread (the grid's stride);
- the lazy helpers K11 and K12 lean on (goldilocks.cuh), and 160-bit sums
  that take terms off a start at a multiple of p, built by g++ from
  chip_smoke.LAZY_SOURCE, equal Python's integers mod p (the card's build
  is held to this one in tests/test_torch_cuda.py and chip_smoke.py:
  ROADMAP Queue 3, item 1).
On the card, tests/test_torch_cuda.py holds K11 to its plain version and
chip_smoke.py does so at the main path's shapes.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from olavm_tpu.field import gf as jgf
from olavm_tpu.stark import ctl_device as jctl
from olavm_tpu_torch import kernels
from olavm_tpu_torch.field import gf
from olavm_tpu_torch.stark import ctl_kernels as ck
from olavm_tpu_torch.stark.cross_table_lookup import Column
from olavm_tpu_torch.tables.ola_stark import OlaStark, all_cross_table_lookups
from torch_host_block import HOST_BLOCK_STUB
import chip_smoke
import torch_threads  # noqa: F401  (torch's share of the cores)

P = gf.P
EDGE = np.array([0, 1, 2, P - 1, P - 2, 1 << 32, (1 << 32) - 1,
                 (1 << 32) + 1, 1 << 63, P - (1 << 32) + 1], dtype=np.uint64)
FILTER_VALUES = np.array([0, 0, 0, 1, 1, 2, P - 1], dtype=np.uint64)

VIEWS = [t for ctl in all_cross_table_lookups()
         for t in list(ctl.looking_tables) + [ctl.looked_table]]
WIDTHS = [s.COLUMNS for s in OlaStark().starks]


def _constants() -> dict:
    text = (kernels.CSRC / "ctl.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", text)}


def test_wrapper_limits_are_the_sources():
    c = _constants()
    assert (ck.MAX_SLOTS, ck.MAX_COLUMNS, ck.MAX_TERMS) == (
        c["MAX_SLOTS"], c["MAX_COLUMNS"], c["MAX_TERMS"])
    assert (ck.USE_VALUE, ck.USE_FILTER) == (c["USE_VALUE"], c["USE_FILTER"])
    assert "ctl" in kernels.SOURCES
    assert "ctl_combine" in kernels.LAUNCHES


def test_every_view_fits_the_kernel():
    assert len(VIEWS) == 88
    widest = 0
    for t in VIEWS:
        v = ck.view_params(t.columns, t.filter_column)
        assert v.slots <= ck.MAX_SLOTS and v.columns <= ck.MAX_COLUMNS
        assert v.terms <= ck.MAX_TERMS
        assert max(v.row[:v.slots]) < WIDTHS[t.table]
        widest = max(widest, v.slots)
    assert widest == 25


def test_a_view_past_the_limits_raises_naming_it():
    cols = [Column.single(c) for c in range(ck.MAX_SLOTS + 1)]
    with pytest.raises(ValueError, match=r"ctl_combine.*columns \[\(\(\(0, 1"):
        ck.view_params(cols, None)
    many = [Column([(0, 1)] * 3) for _ in range(ck.MAX_TERMS // 3 + 1)]
    with pytest.raises(ValueError, match="terms"):
        ck.view_params(many[:ck.MAX_COLUMNS], None)


def _filter_rows(table: int) -> set:
    return {c for t in VIEWS if t.table == table and t.filter_column
            for c, _ in t.filter_column.linear_combination}


def _trace(table: int, n: int, rng, edge: bool) -> np.ndarray:
    """A (C, n) trace of the table's width: random canonical values or
    EDGE values, and every column that a filter reads drawn from 0, 1, 2
    and p - 1 (mostly 0), so that filters of one or more terms meet 1 and
    miss it."""
    width = WIDTHS[table]
    if edge:
        x = EDGE[rng.integers(0, len(EDGE), (width, n))]
    else:
        x = rng.integers(0, P, (width, n), dtype=np.uint64)
    for c in _filter_rows(table):
        x[c] = FILTER_VALUES[rng.integers(0, len(FILTER_VALUES), n)]
    return x


def _bank(rng) -> np.ndarray:
    return rng.integers(0, P, 2, dtype=np.uint64)


@pytest.mark.parametrize("log_n,edge", [(6, False), (8, True)])
def test_plain_equals_the_chain_and_olavm_tpu_for_every_view(log_n, edge):
    rng = np.random.default_rng(log_n)
    n = 1 << log_n
    traces = {t: _trace(t, n, rng, edge) for t in range(len(WIDTHS))}
    met = {True: 0, False: 0}
    for i, t in enumerate(VIEWS):
        bank = _bank(rng)
        trace = gf.from_u64(traces[t.table], "cpu")
        bg = gf.from_u64(bank, "cpu")
        got = ck.ctl_combine_plain(trace, t.columns, t.filter_column, bg)
        assert got.shape == (n,)
        assert torch.equal(got, ck.ctl_combine_ops(trace, t.columns,
                                                   t.filter_column, bg)), i
        if t.filter_column is not None:
            filt = t.filter_column.eval_table(traces[t.table])
            met[True] += int((filt == 1).sum())
            met[False] += int((filt != 1).sum())
        z = gf.prefix_prod_plain(got)
        want = jctl.ctl_z_device(jgf.from_u64(traces[t.table]), t.columns,
                                 t.filter_column, jgf.from_u64(bank))
        np.testing.assert_array_equal(gf.to_u64(z), jgf.to_u64(want),
                                      err_msg=f"view {i}")
    assert met[True] > n and met[False] > n


def _python_combine(trace: np.ndarray, columns, filter_column, beta, gamma):
    out = []
    for j in range(trace.shape[1]):
        def ev(col):
            return (sum(k * int(trace[c, j]) for c, k in col.linear_combination)
                    + col.constant) % P
        v = (sum(ev(col) * pow(beta, i, P) for i, col in enumerate(columns))
             + gamma) % P
        out.append(v if filter_column is None or ev(filter_column) == 1
                   else 1)
    return out


@pytest.mark.parametrize("case", range(4))
def test_plain_against_python_ints(case):
    rng = np.random.default_rng(40 + case)
    n = 16
    trace = _trace(0, n, rng, edge=bool(case % 2))
    trace[:4] = FILTER_VALUES[rng.integers(0, len(FILTER_VALUES), (4, n))]
    cols = [Column.linear_combination_with_constant([(5, P - 1), (7, 3)], 9),
            Column.constant_col(P - 2), Column.single(9),
            Column([(11, (1 << 40) + 5), (5, 2), (11, 1)])][:case + 1]
    filters = [None, Column.linear_combination_with_constant([(0, -1)], 1),
               Column([(1, 1), (2, 1), (3, P - 1)]), Column.single(2)]
    bank = _bank(rng)
    got = ck.ctl_combine_plain(gf.from_u64(trace, "cpu"), cols,
                               filters[case], gf.from_u64(bank, "cpu"))
    want = _python_combine(trace, cols, filters[case], int(bank[0]),
                           int(bank[1]))
    assert [int(v) for v in gf.to_u64(got)] == want


def test_a_view_without_columns_gives_gamma():
    rng = np.random.default_rng(5)
    trace = gf.from_u64(_trace(0, 8, rng, False), "cpu")
    bg = gf.from_u64(_bank(rng), "cpu")
    got = ck.ctl_combine_plain(trace, [], None, bg)
    assert torch.equal(got, bg[1].expand(8))


def test_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(6)
    t = VIEWS[0]
    trace = gf.from_u64(_trace(t.table, 32, rng, False), "cpu")
    bg = gf.from_u64(_bank(rng), "cpu")
    kernels.reset_launches()
    assert torch.equal(ck.ctl_combine(trace, t.columns, t.filter_column, bg),
                       ck.ctl_combine_plain(trace, t.columns,
                                            t.filter_column, bg))
    assert kernels.LAUNCHES["ctl_combine"] == 0


# ---------------------------------------------------------------------------
# csrc/ctl.cu built by g++, every launch run on the host
# ---------------------------------------------------------------------------

CTL_HOST_GRID = """
static const ctl::View* g_view;
static const uint64_t *g_trace, *g_bank;
static uint64_t* g_out;
static int64_t g_n;
template <int S> static void combine() {
  ctl::combine_kernel<S>(*g_view, g_trace, g_bank, g_out, g_n);
}
extern "C" void host_ctl_combine(const void* view, const uint64_t* trace,
                                 const uint64_t* bank, uint64_t* out,
                                 int64_t n) {
  g_view = static_cast<const ctl::View*>(view);
  g_trace = trace; g_bank = bank; g_out = out; g_n = n;
  const int slots = g_view->slots;
  void (*run)() = slots <= 8 ? combine<8>
                             : (slots <= 16 ? combine<16> : combine<32>);
  host_grid_in_turn(ctl::blocks(n), ctl::THREADS, run);
}
"""


@pytest.fixture(scope="module")
def ctl_host(tmp_path_factory):
    """csrc/ctl.cu's kernel built by g++ (tests/torch_host_block.py's
    stub, goldilocks.cuh's host twins), each launch run on the host."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    text = (kernels.CSRC / "ctl.cu").read_text()
    start = text.index('#include "goldilocks.cuh"')
    end = text.index("}  // namespace ctl") + len("}  // namespace ctl")
    d = tmp_path_factory.mktemp("ctl_host")
    (d / "stub.h").write_text(HOST_BLOCK_STUB)
    (d / "ctl_host.cpp").write_text(text[start:end] + CTL_HOST_GRID)
    so = d / "libctlhost.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-pthread", "-Wno-unknown-pragmas", "-I",
                    str(kernels.CSRC), "-include", str(d / "stub.h"),
                    str(d / "ctl_host.cpp"), "-o", str(so)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    lib.host_ctl_combine.argtypes = [vp, vp, vp, vp, ctypes.c_int64]
    lib.host_ctl_combine.restype = None
    return lib


def _combine_host(lib, trace, columns, filter_column, bg):
    n = trace.shape[1]
    out = torch.full((n,), -1, dtype=torch.int64)
    v = ck.view_params(columns, filter_column)
    lib.host_ctl_combine(ctypes.addressof(v), trace.data_ptr(), bg.data_ptr(),
                         out.data_ptr(), n)
    return out


# n not a multiple of a block's rows (THREADS = 256), and past one row a
# thread (MAX_BLOCKS x THREADS = 135,168)
@pytest.mark.parametrize("n,edge", [(1, False), (3, True), (300, True),
                                    (257, False), (135_168 + 77, True)])
def test_k11_built_by_gxx_equals_plain(ctl_host, n, edge):
    rng = np.random.default_rng(n)
    traces = {}
    views = VIEWS if n < 1000 else [t for t in VIEWS if t.table in (0, 5)]
    for i, t in enumerate(views):
        if t.table not in traces:
            traces[t.table] = gf.from_u64(_trace(t.table, n, rng, edge), "cpu")
        trace = traces[t.table]
        bg = gf.from_u64(EDGE[rng.integers(0, len(EDGE), 2)] if edge
                         else _bank(rng), "cpu")
        got = _combine_host(ctl_host, trace, t.columns, t.filter_column, bg)
        assert torch.equal(got, ck.ctl_combine_plain(
            trace, t.columns, t.filter_column, bg)), (n, i)


def test_k11_built_by_gxx_on_constants_and_wide_coefficients(ctl_host):
    rng = np.random.default_rng(7)
    trace = gf.from_u64(_trace(0, 600, rng, True), "cpu")
    cols = [Column.linear_combination_with_constant([(5, P - 1), (7, 3)], 9),
            Column.constant_col(P - 2), Column([]),
            Column([(11, (1 << 40) + 5), (5, 2), (11, P - 1), (11, 7)])]
    for filt in (None, Column.linear_combination_with_constant([(0, -1)], 1),
                 Column([(1, 1), (2, 1), (3, P - 1), (1, 1)])):
        for c in (cols, [], cols[1:3]):
            bg = gf.from_u64(EDGE[rng.integers(0, len(EDGE), 2)], "cpu")
            assert torch.equal(_combine_host(ctl_host, trace, c, filt, bg),
                               ck.ctl_combine_plain(trace, c, filt, bg))


def test_lazy_sums_built_by_gxx_equal_python_ints(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    pairs, sums = chip_smoke.lazy_inputs(np.random.default_rng(2), 1024)
    host = chip_smoke.lazy_host(pairs, sums, str(tmp_path))
    assert chip_smoke.lazy_mismatches(host, pairs, sums) == {}
    # the words a mismatch would be counted on
    broken = host.copy()
    broken[5] += np.uint64(1)
    assert chip_smoke.lazy_mismatches(broken, pairs, sums, host) == {
        "reduce160_lazy": 1}
