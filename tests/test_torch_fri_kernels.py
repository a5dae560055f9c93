"""K9 (fri_combine) and K10 (fri_quotient), the FRI composition's two passes,
and K12 (fri_fold), the FRI fold (csrc/fri.cu, stark/fri_kernels.py), on
the CPU, exact throughout (tolerance 0: field arithmetic has one answer):

- the composition that the port runs (fri_composition: the plain K9, K1,
  the plain K10, K1 inverse and the coset scaling) equals the op-by-op
  chain it replaced (fri_composition_ops) and olavm_tpu's
  prove_openings_device, on an instance of fri_instance_for_stark's shape:
  three oracles, batch 0 at zeta over all three, batch 1 at g zeta over the
  trace and Z rows (rows shared by batches), batch 2 at the base point
  g^-1 over the CTL Zs only;
- in the port alone: runs of 1, 16 and 17 rows (a batch cut into runs of
  at most 16), n from 2 to 2^10, edge values and a zero norm;
- K9's segment table reads every (batch, row) of a plan once, with its
  alpha powers, a row listed twice by one batch included;
- csrc/fri.cu built by g++ (the CUDA qualifiers stubbed, every thread of a
  launch run on the host) equals the plain versions at chip_smoke's
  EDGE_VALUES, at sizes that are not a multiple of a thread's columns or
  points, odd sizes, and with a zero norm; K10 both on any omega and on
  K1's twiddles of a power-of-two coset (the card's wrapper);
- the fold's plain version at arity 2, 4, 8 and 16 equals the op-by-op
  chain it replaced (fri_kernels.fri_fold_ops) and olavm_tpu's
  fold_fn formula on its gfe (powers, products, a tree of sums), and K12
  built by g++ equals it on a whole vector, on contiguous slices (a mesh
  rank's rows) and past one output a thread.
On the card, tests/test_torch_cuda.py holds the kernels to their plain
versions and chip_smoke.py does so at the main path's shapes.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from olavm_tpu.field import gf as jgf
from olavm_tpu.field import gfe as jgfe
from olavm_tpu_torch import kernels
from olavm_tpu_torch.field import gf
from olavm_tpu_torch.field import goldilocks as g
from olavm_tpu_torch.ntt import ntt as dntt
from olavm_tpu_torch.stark import fri_kernels as fk
from olavm_tpu_torch.stark import prover_device as tpd
from test_torch_inv_scan import _composition
import torch_threads  # noqa: F401  (torch's share of the cores)

P = gf.P
RATE_BITS = chip_smoke.FRI_RATE_BITS


def _constants() -> dict:
    text = (kernels.CSRC / "fri.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", text)}


K9K10 = _constants()


def test_wrapper_limits_are_the_sources():
    assert (fk.MAX_ORACLES, fk.MAX_BATCHES, fk.MAX_SEGMENTS,
            fk.COMBINE_BANK) == (
        K9K10["MAX_ORACLES"], K9K10["MAX_BATCHES"], K9K10["MAX_SEGMENTS"],
        K9K10["COMBINE_BANK"])
    assert "fri" in kernels.SOURCES
    assert {"fri_combine", "fri_quotient", "fri_fold"} <= set(
        kernels.LAUNCHES)
    assert fk.FOLD_ARITIES == (2, 4, 8, 16)


# ---------------------------------------------------------------------------
# the composition against the chain it replaced and olavm_tpu's
# ---------------------------------------------------------------------------


def _both(coeffs, bank, plan):
    got = tpd.fri_composition(*coeffs, bank, plan=plan, rate_bits=RATE_BITS)
    want = tpd.fri_composition_ops(*coeffs, bank, plan=plan,
                                   rate_bits=RATE_BITS)
    return got, want


def test_three_batches_equal_olavm_tpu(monkeypatch):
    rng = np.random.default_rng(15)
    n = 8
    # runs of 1 and 2 rows: olavm_tpu traces a program for each run length
    widths, num_perm = (2, 2, 1), 1
    coeffs = [rng.integers(0, P, (w, n), dtype=np.uint64) for w in widths]
    trace = [(0, i) for i in range(widths[0])]
    zs = [(1, i) for i in range(widths[1])]
    points = [rng.integers(0, P, 2, dtype=np.uint64) for _ in range(2)]
    points.append(np.asarray([g.inv(g.primitive_root_of_unity(3)), 0],
                             dtype=np.uint64))
    polys = [trace + zs + [(2, 0)], trace + zs,
             [(1, i) for i in range(num_perm, widths[1])]]
    openings = [[tuple(int(v) for v in rng.integers(0, P, 2, dtype=np.uint64))
                 for _ in q] for q in polys]
    got = _composition(monkeypatch, "olavm_tpu_torch", coeffs, points, polys,
                       openings)
    want = _composition(monkeypatch, "olavm_tpu", coeffs, points, polys,
                        openings)
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_, w)


@pytest.mark.parametrize("rows", [1, 16, 17])
@pytest.mark.parametrize("log_n", [1, 3, 6, 10])
def test_composition_equals_the_op_by_op_chain(rows, log_n):
    rng = np.random.default_rng(rows * 100 + log_n)
    n = 1 << log_n
    # the trace and Z batches cut into runs of at most 16 rows, the CTL Zs
    # (rows 1 on) cut elsewhere
    coeffs, bank, plan = chip_smoke.fri_case((rows, rows + 1, 2), 1, n, rng,
                                             "cpu")
    got, want = _both(coeffs, bank, plan)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("log_n", [1, 4])
def test_composition_on_edge_values_and_a_zero_norm(log_n):
    rng = np.random.default_rng(log_n)
    coeffs, bank, plan = chip_smoke.fri_case((17, 3, 2), 1, 1 << log_n, rng,
                                             "cpu", edge=True)
    got, want = _both(coeffs, bank, plan)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(chip_smoke.FRI_SHAPES))
def test_segments_read_each_batch_row_once(name):
    """The segment table of each shape chip_smoke checks, and of plans with
    runs that overlap across batches and a row listed twice: each (batch,
    listing of a row) once, with the bank offsets of its alpha powers."""
    widths, num_perm, _ = chip_smoke.FRI_SHAPES[name]
    _, _, plan = chip_smoke.fri_case(widths, num_perm, 2,
                                     np.random.default_rng(0), "cpu")
    dup = (((0, 0, 3, 0), (0, 1, 2, 6)), 10), (((0, 2, 5, 16),), 26)
    for p in (plan, dup):
        want = sorted((b, oi, p0 + r, roff + r, roff + k + r)
                      for b, (runs, _) in enumerate(p)
                      for oi, p0, k, roff in runs for r in range(k))
        got = sorted((b, oi, first + r, re[b] + r, im[b] + r)
                     for oi, first, count, re, im in fk.segments(p)
                     for b in range(len(p)) if re[b] >= 0
                     for r in range(count))
        assert got == want
        assert len(fk.segments(p)) <= fk.MAX_SEGMENTS


@pytest.mark.parametrize("widths,num_perm", [((94, 78, 12), 0),
                                             ((17, 5, 2), 2)])
def test_composition_plans_nest_batch_one_in_batch_zero(widths, num_perm):
    """composition_bank gives batch 1 (the trace and Z rows) the bank words
    of batch 0's same rows, so K9 forms their products once and folds batch
    1's sums into batch 0's; a plan whose batch 1 reads other words does
    not nest."""
    rng = np.random.default_rng(2)
    _, bank, plan = chip_smoke.fri_case(widths, num_perm, 1 << 4, rng, "cpu")
    segs = fk.segments(plan)
    assert fk.nested(segs)
    assert len(bank) == 2 * (sum(widths) + widths[1] - num_perm) + 18
    other = (plan[0], (tuple((oi, p0, k, roff + 1)
                             for oi, p0, k, roff in plan[1][0]),
                       plan[1][1]), plan[2])
    assert not fk.nested(fk.segments(other))


def test_wrappers_take_the_plain_versions_on_the_cpu():
    rng = np.random.default_rng(3)
    coeffs, bank, plan = chip_smoke.fri_case((3, 2, 1), 0, 16, rng, "cpu")
    kernels.reset_launches()
    combined = fk.fri_combine(coeffs, bank, plan, RATE_BITS)
    assert torch.equal(combined, fk.fri_combine_plain(coeffs, bank, plan,
                                                      RATE_BITS))
    assert torch.equal(fk.fri_quotient(combined, bank, plan),
                       fk.fri_quotient_plain(combined, bank, plan))
    assert kernels.LAUNCHES["fri_combine"] == kernels.LAUNCHES[
        "fri_quotient"] == 0


def test_combine_plain_against_python_ints():
    rng = np.random.default_rng(4)
    n = 4
    coeffs, bank, plan = chip_smoke.fri_case((2, 3, 1), 1, n, rng, "cpu")
    got = gf.to_u64(fk.fri_combine_plain(coeffs, bank, plan, 1))
    c = [gf.to_u64(x) for x in coeffs]
    bk = [int(v) for v in gf.to_u64(bank)]
    for b, (runs, _) in enumerate(plan):
        for part in range(2):
            for j in range(2 * n):
                want = 0
                if j < n:
                    for oi, p0, k, roff in runs:
                        for r in range(k):
                            want += (bk[roff + part * k + r]
                                     * int(c[oi][p0 + r, j]))
                    want = want * pow(fk.SHIFT, j, P) % P
                assert int(got[b, part, j]) == want


# ---------------------------------------------------------------------------
# csrc/fri.cu built by g++, every thread run on the host
# ---------------------------------------------------------------------------

# a launch of csrc/fri.cu's kernels on the host (tests/torch_host_block.py):
# K9's threads side by side (they meet at a barrier after the bank's copy),
# K10's and K12's one after another (K10's first thread fills its block's
# constants; K12's threads share nothing)
FRI_HOST_GRID = """
static void grid(unsigned blocks, unsigned threads, void (*run)()) {
  host_grid_in_turn(blocks, threads, run);
}
static const fri::CombinePlan* g_cplan;
static const fri::QuotientPlan* g_qplan;
static const uint64_t *g_bank, *g_values, *g_tw;
static uint64_t* g_out;
static int64_t g_n, g_size;
static uint64_t g_shift, g_half;
static int g_bank_words;
static bool g_vec;
template <int B> static void combine() {
  if (g_vec)
    fri::combine_kernel<B, true>(*g_cplan, g_bank, g_bank_words, g_out, g_n,
                                 g_size, g_shift);
  else
    fri::combine_kernel<B, false>(*g_cplan, g_bank, g_bank_words, g_out, g_n,
                                  g_size, g_shift);
}
template <int B> static void quotient() {
  fri::quotient_kernel<B>(*g_qplan, g_values, g_bank, g_tw, g_out, g_size,
                          g_shift, g_half);
}
extern "C" void host_fri_combine(const void* plan, int batches,
                                 const uint64_t* bank, int bank_words,
                                 uint64_t* out, int64_t n, int64_t size,
                                 uint64_t shift, int vec) {
  g_cplan = static_cast<const fri::CombinePlan*>(plan);
  g_bank = bank; g_bank_words = bank_words; g_out = out; g_n = n;
  g_size = size; g_shift = shift; g_vec = vec;
  void (*run[])() = {combine<1>, combine<2>, combine<3>, combine<4>};
  host_grid(fri::combine_blocks(n), fri::COMBINE_THREADS, run[batches - 1]);
}
static const uint64_t *g_re, *g_im, *g_bpows;
static int64_t g_m;
template <int A> static void fold() {
  fri::fold_kernel<A>(g_re, g_im, g_bpows, g_out, g_m);
}
extern "C" void host_fri_fold(const uint64_t* re, const uint64_t* im,
                              const uint64_t* bpows, uint64_t* out, int64_t m,
                              int arity) {
  g_re = re; g_im = im; g_bpows = bpows; g_out = out; g_m = m;
  void (*run)() = arity == 2 ? fold<2> : arity == 4 ? fold<4>
                : arity == 8 ? fold<8> : fold<16>;
  grid(fri::fold_blocks(m), fri::FOLD_THREADS, run);
}
extern "C" void host_fri_quotient(const void* plan, int batches,
                                  const uint64_t* values,
                                  const uint64_t* bank, const uint64_t* tw,
                                  uint64_t* out, int64_t size, uint64_t shift,
                                  uint64_t half_step) {
  g_qplan = static_cast<const fri::QuotientPlan*>(plan);
  g_values = values; g_bank = bank; g_tw = tw; g_out = out; g_size = size;
  g_shift = shift; g_half = half_step;
  void (*run[])() = {quotient<1>, quotient<2>, quotient<3>, quotient<4>};
  grid(fri::quotient_blocks(size), fri::QUOTIENT_THREADS, run[batches - 1]);
}
"""


@pytest.fixture(scope="module")
def fri_host(tmp_path_factory):
    """csrc/fri.cu's kernels built by g++ (tests/torch_host_block.py's
    stub, goldilocks.cuh's and the copy helpers' host twins), each launch
    run on the host."""
    from torch_host_block import HOST_BLOCK_STUB

    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    text = (kernels.CSRC / "fri.cu").read_text()
    start = text.index('#include "goldilocks.cuh"')
    end = text.index("}  // namespace fri") + len("}  // namespace fri")
    d = tmp_path_factory.mktemp("fri_host")
    (d / "stub.h").write_text(HOST_BLOCK_STUB)
    (d / "fri_host.cpp").write_text(text[start:end] + FRI_HOST_GRID)
    so = d / "libfrihost.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-pthread", "-Wno-unknown-pragmas", "-I",
                    str(kernels.CSRC), "-include", str(d / "stub.h"),
                    str(d / "fri_host.cpp"), "-o", str(so)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    vp, i64, u64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64
    lib.host_fri_combine.argtypes = [vp, ctypes.c_int, vp, ctypes.c_int, vp,
                                     i64, i64, u64, ctypes.c_int]
    lib.host_fri_quotient.argtypes = [vp, ctypes.c_int, vp, vp, vp, vp, i64,
                                      u64, u64]
    lib.host_fri_fold.argtypes = [vp, vp, vp, vp, i64, ctypes.c_int]
    lib.host_fri_combine.restype = lib.host_fri_quotient.restype = None
    lib.host_fri_fold.restype = None
    return lib


def _combine_host(lib, coeffs, bank, plan, rate_bits, vec=None):
    """K9 by g++ on the host: with 16-byte rows (vec) where n is even,
    unless vec says otherwise."""
    n = coeffs[0].shape[1]
    size = n << rate_bits
    out = torch.full((len(plan), 2, size), -1, dtype=torch.int64)
    p = fk.combine_params(coeffs, plan)
    lib.host_fri_combine(ctypes.addressof(p), len(plan), bank.data_ptr(),
                         bank.numel(), out.data_ptr(), n, size, fk.SHIFT,
                         int(n % 2 == 0 if vec is None else vec))
    return out


# n not a multiple of a thread's columns (COMBINE_STRIP = 256), nor of a
# block's, nor of a stage's rows, with and without padding (shares of it
# ragged and past the end), odd n (8-byte copies)
@pytest.mark.parametrize("n,rate_bits", [(2, 3), (3, 0), (300, 1), (257, 2),
                                         (1024, 3), (600, 2)])
def test_k9_built_by_gxx_equals_plain(fri_host, n, rate_bits):
    rng = np.random.default_rng(n)
    for edge in (False, True):
        coeffs, bank, plan = chip_smoke.fri_case((17, 5, 2), 2, n, rng,
                                                 "cpu", edge)
        want = fk.fri_combine_plain(coeffs, bank, plan, rate_bits)
        for vec in sorted({False, n % 2 == 0}):
            got = _combine_host(fri_host, coeffs, bank, plan, rate_bits, vec)
            assert torch.equal(got, want), (edge, vec)


def test_k9_built_by_gxx_on_one_to_four_batches(fri_host):
    rng = np.random.default_rng(9)
    n = 40
    coeffs = [gf.from_u64(rng.integers(0, P, (6, n), dtype=np.uint64), "cpu")]
    bank = gf.from_u64(chip_smoke.edge_values(rng, 64), "cpu")
    runs = (((0, 0, 6, 0),), 12), (((0, 2, 3, 20),), 26), \
        (((0, 5, 1, 32), (0, 0, 2, 34)), 38), (((0, 1, 4, 44),), 52)
    for b in range(1, 5):
        plan = runs[:b]
        assert torch.equal(_combine_host(fri_host, coeffs, bank, plan, 2),
                           fk.fri_combine_plain(coeffs, bank, plan, 2))


def _quotient_host(lib, values, bank, points, shift: int, tw, half_step: int
                   ) -> torch.Tensor:
    batches, _, size = values.shape
    p = fk._QuotientPlan()
    p.point[:batches] = points
    got = torch.full((2, size), -1, dtype=torch.int64)
    tw = tw.contiguous()
    lib.host_fri_quotient(ctypes.addressof(p), batches,
                          values.contiguous().data_ptr(), bank.data_ptr(),
                          tw.data_ptr(), got.data_ptr(), size, shift,
                          half_step)
    return got


def _quotient_inputs(rng, batches: int, size: int, shift: int, omega: int):
    """EDGE_VALUES for the values and the bank, batch 0's point a point of
    the coset (a zero norm there)."""
    values = gf.from_u64(chip_smoke.edge_values(rng, (batches, 2, size)),
                         "cpu")
    bank = chip_smoke.edge_values(rng, 6 * batches + 3)
    points = [3 + 6 * b for b in range(batches)]
    x = shift * pow(omega, int(rng.integers(size)), P) % P
    bank[points[0]:points[0] + 2] = (x, 0)
    return values, gf.from_u64(bank, "cpu"), points


# sizes not a multiple of a thread's pairs of points (QUOTIENT_PAIRS = 8)
# or of a block's, odd sizes (a last pair of one point), any omega: the
# pairs' upper points are x w^ceil(size / 2)
@pytest.mark.parametrize("size", [1, 5, 12, 17, 1000, (1 << 12) + 3])
@pytest.mark.parametrize("batches", [1, 3, 4])
def test_k10_built_by_gxx_equals_plain(fri_host, size, batches):
    rng = np.random.default_rng(size * 10 + batches)
    shift, omega = (int(v) for v in rng.integers(1, P, 2, dtype=np.uint64))
    values, bank, points = _quotient_inputs(rng, batches, size, shift, omega)
    half = (size + 1) // 2
    tw = gf.from_u64([pow(omega, j, P) for j in range(half)], "cpu")
    got = _quotient_host(fri_host, values, bank, points, shift, tw,
                         pow(omega, half, P))
    assert torch.equal(got, fk.quotient_plain(values, bank, points, shift,
                                              omega))


# the coset as the card's wrapper gives it: K1's twiddles of the size,
# w^{size/2} = -1 (the upper points negated), at sizes below one pair a
# thread, one block's points and past several blocks
@pytest.mark.parametrize("log_size", [1, 2, 4, 8, 11, 13])
def test_k10_built_by_gxx_on_the_twiddles(fri_host, log_size):
    rng = np.random.default_rng(log_size)
    size = 1 << log_size
    omega = g.primitive_root_of_unity(log_size)
    for batches in (2, 3):
        values, bank, points = _quotient_inputs(rng, batches, size, fk.SHIFT,
                                                omega)
        tw = dntt.twiddles(log_size, False, "cpu")
        got = _quotient_host(fri_host, values, bank, points, fk.SHIFT, tw,
                             P - 1)
        plan = tuple(((), off) for off in points)
        assert torch.equal(got, fk.fri_quotient_plain(values, bank, plan))


# ---------------------------------------------------------------------------
# K12: the FRI fold
# ---------------------------------------------------------------------------


def _fold_case(m: int, arity: int, rng, edge: bool):
    """(m,) re and im coefficients and beta's (2, arity) powers, from a
    random beta, or EDGE_VALUES throughout."""
    if edge:
        re, im = (gf.from_u64(chip_smoke.edge_values(rng, m), "cpu")
                  for _ in range(2))
        beta = tuple(int(v) for v in chip_smoke.edge_values(rng, 2))
    else:
        re, im = (gf.from_u64(rng.integers(0, P, m, dtype=np.uint64), "cpu")
                  for _ in range(2))
        beta = tuple(int(v) for v in rng.integers(0, P, 2, dtype=np.uint64))
    pws = [(1, 0)]
    for _ in range(1, arity):
        a, b = pws[-1]
        pws.append(((a * beta[0] + 7 * b * beta[1]) % P,
                    (a * beta[1] + b * beta[0]) % P))
    bpows = gf.from_u64(np.asarray(pws, dtype=np.uint64).T.copy(), "cpu")
    return re, im, beta, bpows


def _olavm_tpu_fold(re, im, beta, arity: int) -> np.ndarray:
    """olavm_tpu's fold_fn formula (olavm_tpu/stark/prover_device.py:887):
    each coefficient times its power of beta (gfe.powers), a tree of
    sums."""
    r = gf.to_u64(re).reshape(-1, arity)
    q = gf.to_u64(im).reshape(-1, arity)
    bp = jgfe.powers(jgfe.from_u64_pair(np.asarray(beta, dtype=np.uint64)),
                     arity)
    terms = [jgfe.mul(jgfe.GFE(jgf.from_u64(r[:, i].copy()),
                               jgf.from_u64(q[:, i].copy())), bp[i])
             for i in range(arity)]
    while len(terms) > 1:
        nxt = [jgfe.add(terms[j], terms[j + 1])
               for j in range(0, len(terms) - 1, 2)]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return jgfe.to_u64_pair(terms[0]).T


@pytest.mark.parametrize("arity", [2, 4, 8, 16])
@pytest.mark.parametrize("edge", [False, True])
def test_fold_plain_equals_the_chain_and_olavm_tpu(arity, edge):
    rng = np.random.default_rng(arity + 100 * edge)
    re, im, beta, bpows = _fold_case(arity * 37, arity, rng, edge)
    got = fk.fri_fold_plain(re, im, bpows)
    assert got.shape == (2, 37)
    assert torch.equal(got, fk.fri_fold_ops(re, im, bpows))
    np.testing.assert_array_equal(gf.to_u64(got),
                                  _olavm_tpu_fold(re, im, beta, arity))


def test_fold_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(12)
    re, im, _, bpows = _fold_case(16 * 8, 16, rng, False)
    kernels.reset_launches()
    assert torch.equal(tpd.fold_stacked(re, im, bpows),
                       fk.fri_fold_plain(re, im, bpows))
    assert kernels.LAUNCHES["fri_fold"] == 0


def _fold_host(lib, re, im, bpows):
    arity = bpows.shape[1]
    m = re.shape[0] // arity
    out = torch.full((2, m), -1, dtype=torch.int64)
    lib.host_fri_fold(re.data_ptr(), im.data_ptr(), bpows.data_ptr(),
                      out.data_ptr(), m, arity)
    return out


# m not a multiple of a block's outputs (FOLD_THREADS = 128), and past one
# output a thread (FOLD_MAX_BLOCKS x FOLD_THREADS = 135,168)
@pytest.mark.parametrize("arity,m", [(2, 1), (4, 3), (8, 129), (16, 1000),
                                     (2, 135_168 + 5)])
def test_k12_built_by_gxx_equals_plain(fri_host, arity, m):
    rng = np.random.default_rng(m + arity)
    for edge in (False, True):
        re, im, _, bpows = _fold_case(m * arity, arity, rng, edge)
        assert torch.equal(_fold_host(fri_host, re, im, bpows),
                           fk.fri_fold_plain(re, im, bpows)), edge


@pytest.mark.parametrize("arity", [2, 16])
def test_k12_built_by_gxx_on_contiguous_slices(fri_host, arity):
    """A mesh rank folds its rows [lo, hi) of the coefficients: a slice
    that starts past the vector's start."""
    rng = np.random.default_rng(arity)
    m = 300
    re, im, _, bpows = _fold_case(m * arity, arity, rng, True)
    whole = fk.fri_fold_plain(re, im, bpows)
    for lo, hi in ((0, 150), (150, 300), (7, 8), (33, 290)):
        part = _fold_host(fri_host, re[lo * arity:hi * arity],
                          im[lo * arity:hi * arity], bpows)
        assert torch.equal(part, whole[:, lo:hi]), (lo, hi)
