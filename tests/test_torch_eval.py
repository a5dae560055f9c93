"""K5 (olavm_tpu_torch/csrc/eval.cu) without a card.

The wrapper's plan (gf.eval_plan, here with a model of the card's
occupancy): for shapes at every edge of the register tile, the sub-tile, the
point groups and the chunking, each (column, point, term) is summed by
exactly one thread of the launch, within the card's limits. A thread (chunk
x, column group y, point group z; tile ct, pt; slice s) sums columns y *
cols + RC * ct + r, points z * points + RT * pt + q and, of each sub-tile of
its chunk, the term pairs s, s + slices, ...: the threads are a product of a
column, a point and a term axis, so each triple is covered once iff each
axis is.

The tile arithmetic (csrc/eval_tile.cuh with goldilocks.cuh) compiled with
g++ through the stub of the CUDA qualifiers that
tests/test_torch_poseidon_host.py uses, held against Python integers: random
terms, every coefficient and power at p - 1 (and 2^64 - 1) over the largest
count of terms one thread sums at n = 2^26, the reduction of a sum at the
ends of its words' ranges, and the header's constants equal the plan's.
Takes seconds; the compiled check skips only where g++ is absent.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from olavm_tpu_torch import kernels
from olavm_tpu_torch.field import gf
import torch_threads  # noqa: F401  (torch's share of the cores)

P = 2**64 - 2**32 + 1
M64 = 2**64 - 1
SMS = 132  # H100 SXM
SMEM_LIMIT = 232448  # a block's shared memory on sm_90 (csrc/eval.cu)
RC, RT, TERMS = gf.EVAL_RC, gf.EVAL_RT, gf.EVAL_TERMS


def _resident(threads: int, smem_bytes: int) -> int:
    """A model of the card's occupancy of K5: 128 registers a thread of
    65,536 an SM, 228 KB of shared memory an SM (1 KB of it reserved per
    block), at most 32 blocks."""
    warps = -(-threads // 32)
    return max(1, min(32, 65536 // (128 * 32 * warps),
                      233472 // (smem_bytes + 1024)))


def _plan(C, n, k):
    return gf.eval_plan(C, n, k, SMS, _resident)


# the chunk length the plan gives the main path's largest K5 shape
CHUNK = _plan(94, 1 << 20, 28).chunk_len
EDGE_C = tuple(sorted({1, RC - 1, RC, RC + 1, 134}))
EDGE_K = (1, 2, 3, 4, 5, 28, 32, 33, 40)
EDGE_N = (1, 2, 17, TERMS - 1, TERMS + 1, CHUNK - 1, CHUNK + 1, 1 << 20,
          1 << 26)


def _axis_once(group: int, tiles: int, width: int, total: int) -> None:
    """Groups of `tiles` tiles of `width`: index g * tiles * width + width *
    tile + j, kept where below `total`, covers [0, total) once."""
    g, tile, j = np.meshgrid(np.arange(group), np.arange(tiles),
                             np.arange(width), indexing="ij")
    idx = (g * tiles * width + width * tile + j).ravel()
    idx = idx[idx < total]
    np.testing.assert_array_equal(np.bincount(idx, minlength=total),
                                  np.ones(total, dtype=np.int64))


def _terms_once(plan: gf.EvalPlan, n: int) -> None:
    L, S = plan.chunk_len, plan.slices
    # a tile's slices are consecutive lanes of one warp, a power of two
    assert L % TERMS == 0 and 1 <= S <= min(32, TERMS // 2)
    assert S & (S - 1) == 0
    # the slices' term pairs cover a sub-tile once
    pairs = np.concatenate([np.arange(s, TERMS // 2, S) for s in range(S)])
    np.testing.assert_array_equal(np.sort(pairs), np.arange(TERMS // 2))
    # the sub-tiles of every chunk, as the kernel walks them, tile [0, n)
    # (words past n are zero-filled); no chunk is empty
    starts = np.arange(plan.grid[0], dtype=np.int64) * L
    ends = np.minimum(starts + L, n)
    assert (ends > starts).all()
    subs = -(-(ends - starts) // TERMS)
    bases = np.repeat(starts, subs) + TERMS * (
        np.arange(subs.sum()) - np.repeat(np.cumsum(subs) - subs, subs))
    np.testing.assert_array_equal(bases, np.arange(0, n, TERMS))


@pytest.mark.parametrize("n", EDGE_N)
@pytest.mark.parametrize("C", EDGE_C)
def test_plan_covers_every_term_once(C, n):
    for k in EDGE_K:
        plan = _plan(C, n, k)
        chunks, col_groups, point_groups = plan.grid
        assert plan.cols % RC == 0 and plan.points % RT == 0
        assert plan.points <= gf.EVAL_MAX_POINTS
        tiles = plan.cols // RC * (plan.points // RT)
        assert plan.threads == tiles * plan.slices <= gf.EVAL_MAX_THREADS
        assert plan.smem_bytes <= SMEM_LIMIT
        # the overflow invariant of eval_tile.cuh: under 2^31 terms a sum
        assert plan.chunk_len < 2**31
        assert chunks < 2**31 and col_groups < 2**16 and point_groups < 2**16
        # no group is all padding
        assert (col_groups - 1) * plan.cols < C
        assert (point_groups - 1) * plan.points < k
        _axis_once(col_groups, plan.cols // RC, RC, C)
        _axis_once(point_groups, plan.points // RT, RT, k)
        _terms_once(plan, n)


def test_plan_fills_the_card_at_the_main_path_shapes():
    # one block of all columns and points at k = 28, term slices at k <= 4
    for C, k, slices in ((94, 28, 1), (94, 4, 8), (134, 28, 1), (18, 2, 32)):
        plan = _plan(C, 1 << 20, k)
        assert plan.grid[1:] == (1, 1)
        assert plan.slices == slices
        # one wave, all but a few slots filled
        wave = _resident(plan.threads, plan.smem_bytes) * SMS
        assert wave - SMS // 4 <= plan.grid[0] <= wave


STUB = """
#define __device__
#define __host__
#define __forceinline__ inline
"""

HOST_SOURCE = """
#include "eval_tile.cuh"

using eval::Tile;

extern "C" void k5_constants(int* out) {
  out[0] = eval::RC;
  out[1] = eval::RT;
  out[2] = eval::TERMS;
  out[3] = eval::STRIDE;
  out[4] = eval::STAGES;
  out[5] = eval::MAX_THREADS;
}

// one thread's sums over m terms: x (m, RC) coefficients, y (m, RT) powers
// -> out (RC, RT)
extern "C" void k5_tile(const uint64_t* x, const uint64_t* y, int64_t m,
                        uint64_t* out) {
  Tile tile;
  tile.zero();
  for (int64_t i = 0; i < m; ++i) {
    uint64_t xs[eval::RC], ys[eval::RT];
    for (int r = 0; r < eval::RC; ++r) xs[r] = x[i * eval::RC + r];
    for (int q = 0; q < eval::RT; ++q) ys[q] = y[i * eval::RT + q];
    tile.add(xs, ys);
  }
  for (int r = 0; r < eval::RC; ++r)
    for (int q = 0; q < eval::RT; ++q) out[r * eval::RT + q] = tile.sum(r, q);
}

// the residue of a sum given as its words
extern "C" uint64_t k5_residue(uint64_t dlo, uint64_t dhi, uint32_t dtop,
                               uint64_t m, uint32_t mtop) {
  return eval::residue({dlo, dhi, m, dtop, mtop});
}

// the same term m times: every coefficient xv, every power yv
extern "C" void k5_tile_repeat(uint64_t xv, uint64_t yv, int64_t m, uint64_t* out) {
  Tile tile;
  tile.zero();
  uint64_t xs[eval::RC], ys[eval::RT];
  for (int r = 0; r < eval::RC; ++r) xs[r] = xv;
  for (int q = 0; q < eval::RT; ++q) ys[q] = yv;
  for (int64_t i = 0; i < m; ++i) tile.add(xs, ys);
  for (int r = 0; r < eval::RC; ++r)
    for (int q = 0; q < eval::RT; ++q) out[r * eval::RT + q] = tile.sum(r, q);
}
"""


@pytest.fixture(scope="module")
def k5(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("k5_host")
    (d / "stub.h").write_text(STUB)
    (d / "k5_host.cpp").write_text(HOST_SOURCE)
    so = d / "libk5host.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-I", str(kernels.CSRC),
                    "-include", str(d / "stub.h"), str(d / "k5_host.cpp"),
                    "-o", str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    vp, i64, u64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64
    lib.k5_constants.argtypes = [vp]
    lib.k5_tile.argtypes = [vp, vp, i64, vp]
    lib.k5_tile_repeat.argtypes = [u64, u64, i64, vp]
    for fn in (lib.k5_constants, lib.k5_tile, lib.k5_tile_repeat):
        fn.restype = None
    lib.k5_residue.argtypes = [u64, u64, ctypes.c_uint32, u64, ctypes.c_uint32]
    lib.k5_residue.restype = u64
    return lib


def test_header_constants_equal_the_plan(k5):
    got = np.zeros(6, dtype=np.int32)
    k5.k5_constants(got.ctypes.data)
    assert got.tolist() == [gf.EVAL_RC, gf.EVAL_RT, gf.EVAL_TERMS,
                            gf.EVAL_STRIDE, gf.EVAL_STAGES,
                            gf.EVAL_MAX_THREADS]


def test_tile_sums_match_python_integers(k5):
    rng = np.random.default_rng(5)
    m = 300
    x = rng.integers(0, P, size=(m, RC), dtype=np.uint64)
    y = rng.integers(0, P, size=(m, RT), dtype=np.uint64)
    x[:7], y[:7] = P - 1, P - 1
    x[7], y[8] = 0, 0
    out = np.zeros((RC, RT), dtype=np.uint64)
    k5.k5_tile(x.ctypes.data, y.ctypes.data, m, out.ctypes.data)
    for r in range(RC):
        for q in range(RT):
            want = sum(int(a) * int(b) for a, b in zip(x[:, r], y[:, q])) % P
            assert int(out[r, q]) == want


def test_tile_sums_the_largest_terms_at_the_most_terms_per_thread(k5):
    # the most terms one thread adds into a sum over the main path's K5
    # shapes at n = 2^26 (a chunk, split over the slices)
    most = max(-(-plan.chunk_len // plan.slices) for plan in (
        _plan(C, 1 << 26, k)
        for C, k in ((94, 28), (94, 4), (134, 28), (18, 2), (1, 1))))
    assert most < 2**31
    # below 2^31 terms: D below 2^160, M below 2^96
    assert (2**31 - 1) * M64 * M64 < 2**160
    assert (2**31 - 1) * 2 * (2**32 - 1) ** 2 < 2**96
    out = np.zeros((RC, RT), dtype=np.uint64)
    for v in (P - 1, M64):
        k5.k5_tile_repeat(v, v, most, out.ctypes.data)
        assert (out == most * v * v % P).all()


def test_residue_at_the_ends_of_the_sums_ranges(k5):
    # D = dlo + dhi 2^64 + dtop 2^128, M = m + mtop 2^64; value D + M 2^32
    words = (0, 1, 2**32 - 1, 2**32, P - 1, P, M64)
    tops = (0, 1, 2**31, 2**32 - 1)
    for dlo in words:
        for dhi in words:
            for dtop in tops:
                for m in (0, 1, P, M64):
                    for mtop in tops:
                        want = (dlo + (dhi << 64) + (dtop << 128)
                                + ((m + (mtop << 64)) << 32)) % P
                        assert k5.k5_residue(dlo, dhi, dtop, m, mtop) == want
