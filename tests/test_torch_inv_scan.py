"""K7 (field inversion, csrc/gf_inv.cu) and K8 (the grand-product scan,
csrc/scan.cu) on the CPU, exact throughout (tolerance 0: field arithmetic
has one answer):

- the port's gf.inv, gfe.inv and gf.prefix_prod (inclusive and exclusive),
  which run their plain versions on CPU tensors, equal olavm_tpu's
  (olavm_tpu/field/gf.py:252 and :317, gfe.py:115) and a Python-int ground
  truth (pow(x, p - 2, p), the norm formula, running products) on 2^10
  random elements with the edge values 0, 1, p - 1, EPSILON, 2^32, and on
  scan lengths 1, 2, 3, a tile - 1, a tile, a tile + 1 and 2^12;
- K7's kernels, compiled by g++ with the CUDA qualifiers stubbed and run
  thread by thread on the host, and a numpy model of its chunked batch
  inversion (the points of a thread strided across the grid, a zero
  entering the running product as 1 and written as 0) equal the plain
  versions, on all zeros and on a zero in every chunk too;
- a model of K8's tile scan (threads, items, warps, shuffles) and of its
  decoupled look-back (windows of 32 earlier tiles, each seen as
  aggregate-only or with its prefix), scanning in place, equals the plain
  version, at the kernel's tile and at small tiles that take several
  windows;
- K8's kernel, compiled by g++ with the CUDA qualifiers, the barrier, the
  warp intrinsics and its atomic and acquire/release helpers stubbed
  (tests/torch_host_block.py), its blocks run in the counter's order with
  each block's threads side by side, equals the plain version over (rows,
  n) arrays, inclusive and exclusive, into another array and in place,
  with 16-byte and 8-byte loads;
- the FRI composition (fri_composition, through prove_openings_device)
  equals olavm_tpu's on the same oracles and transcript.
On the card, tests/test_torch_cuda.py holds both kernels to their plain
versions.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from olavm_tpu.field import gf as jgf
from olavm_tpu.field import gfe as jgfe
from olavm_tpu_torch import kernels
from olavm_tpu_torch.field import gf, gfe
import torch_threads  # noqa: F401  (torch's share of the cores)

P = gf.P
EPSILON = 0xFFFFFFFF
EDGE = [0, 1, P - 1, EPSILON, 1 << 32]


def _constants(source: str) -> dict:
    """The `constexpr int NAME = value;` constants of a csrc source."""
    text = (kernels.CSRC / source).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", text)}


K7 = _constants("gf_inv.cu")
K8 = _constants("scan.cu")
TILE = K8["THREADS"] * K8["ITEMS"]


def _elements(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([np.asarray(EDGE, dtype=np.uint64),
                           rng.integers(0, P, n, dtype=np.uint64)])


def _t(a: np.ndarray) -> torch.Tensor:
    return gf.from_u64(a, "cpu")


def _ext_inv_int(a: int, b: int) -> tuple[int, int]:
    """1/(a + b phi), phi^2 = 7, in Python ints (0 maps to 0)."""
    ninv = pow((a * a - 7 * b * b) % P, P - 2, P)
    return a * ninv % P, (-b) * ninv % P


def test_inv_equals_olavm_tpu_and_python():
    a = _elements(1 << 10, 1)
    want = np.array([pow(int(x), P - 2, P) for x in a], dtype=np.uint64)
    got = gf.to_u64(gf.inv(_t(a)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, gf.to_u64(gf.inv_plain(_t(a))))
    np.testing.assert_array_equal(got, jgf.to_u64(jgf.inv(jgf.from_u64(a))))
    assert got[0] == 0


def test_ext_inv_equals_olavm_tpu_and_python():
    re_ = _elements(1 << 10, 2)
    im = _elements(1 << 10, 3)[::-1].copy()
    # (0, 0), and every pair of edge values
    edge = np.asarray(EDGE, dtype=np.uint64)
    re_ = np.concatenate([[0], np.repeat(edge, len(edge)), re_])
    im = np.concatenate([[0], np.tile(edge, len(edge)), im])
    want = np.array([_ext_inv_int(int(a), int(b)) for a, b in zip(re_, im)],
                    dtype=np.uint64)
    x = gfe.GFE(_t(re_), _t(im))
    got = gfe.to_u64_pair(gfe.inv(x))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, gfe.to_u64_pair(gfe.inv_plain(x)))
    jx = jgfe.GFE(jgf.from_u64(re_), jgf.from_u64(im))
    np.testing.assert_array_equal(got, jgfe.to_u64_pair(jgfe.inv(jx)))
    assert got[0].tolist() == [0, 0]


def _running_product(a: np.ndarray) -> np.ndarray:
    out, acc = [], 1
    for x in a:
        acc = acc * int(x) % P
        out.append(acc)
    return np.array(out, dtype=np.uint64)


SCAN_LENGTHS = [1, 2, 3, TILE - 1, TILE, TILE + 1, 1 << 12]


@pytest.fixture(scope="module")
def scan_case():
    """Points of the longest scan length, and olavm_tpu's prefix_prod of
    them: the prefix product of the first n points is the first n of it, so
    one call of the JAX function (seconds for each new shape on the CPU)
    serves every length."""
    a = _elements(max(SCAN_LENGTHS), 5)[-max(SCAN_LENGTHS):]
    a[[0, 2, TILE - 1, TILE, 3000]] = [P - 1, EPSILON, 1 << 32, P - 1, 1]
    return a, jgf.to_u64(jgf.prefix_prod(jgf.from_u64(a)))


@pytest.mark.parametrize("n", SCAN_LENGTHS)
def test_prefix_prod_equals_olavm_tpu_and_python(scan_case, n):
    a, jax_scan = scan_case[0][:n], scan_case[1][:n]
    want = _running_product(a)
    got = gf.to_u64(gf.prefix_prod(_t(a)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_scan)
    excl = gf.to_u64(gf.prefix_prod(_t(a), exclusive=True))
    np.testing.assert_array_equal(excl, np.concatenate([[1], want[:-1]]))
    np.testing.assert_array_equal(
        excl, gf.to_u64(gf.prefix_prod_plain(_t(a), exclusive=True)))


def test_prefix_prod_along_a_dimension():
    a = _elements(3 * 37 - 5, 4).reshape(3, 37)
    for dim, axis in ((-1, 1), (0, 0)):
        want = np.apply_along_axis(_running_product, axis, a)
        np.testing.assert_array_equal(gf.to_u64(gf.prefix_prod(_t(a), dim)),
                                      want)
        excl = np.apply_along_axis(
            lambda r: np.concatenate([[1], _running_product(r)[:-1]]), axis, a)
        np.testing.assert_array_equal(
            gf.to_u64(gf.prefix_prod(_t(a), dim, exclusive=True)), excl)


# ---------------------------------------------------------------------------
# K7: its batch inversion as a numpy model, and its kernels built by g++
# ---------------------------------------------------------------------------


def k7_model(a: np.ndarray, chunk: int) -> np.ndarray:
    """K7's base-field kernel in Python ints: thread t of ceil(n / chunk)
    takes the points t + k T, k < chunk; a zero (or a point past the end)
    enters the running product as 1 and is written as 0; one inversion a
    thread, then the walk back."""
    n = len(a)
    threads = -(-n // chunk)
    out = np.full(n, 12345, dtype=np.uint64)
    for t in range(threads):
        idx = [t + k * threads for k in range(chunk)]
        xs = [int(a[i]) if i < n else 0 for i in idx]
        pre, acc = [], 1
        for x in xs:
            acc = acc * (x or 1) % P
            pre.append(acc)
        inv_acc = pow(acc, P - 2, P)
        for k in reversed(range(chunk)):
            r = inv_acc * pre[k - 1] % P if k else inv_acc
            inv_acc = inv_acc * (xs[k] or 1) % P
            if idx[k] < n:
                out[idx[k]] = r if xs[k] else 0
    return out


def _k7_inputs(n: int, chunk: int, seed: int) -> dict:
    """Random points with the edge values, all zeros, and a zero in every
    chunk (each thread's first point, so the walk back crosses it)."""
    rnd = _elements(n, seed)[-n:]
    every = rnd.copy()
    every[:-(-n // chunk)] = 0
    return {"random": rnd, "zeros": np.zeros(n, dtype=np.uint64),
            "zero in every chunk": every}


@pytest.mark.parametrize("n", [1, 15, 16, 17, 1000, 1 << 12])
def test_k7_model_equals_plain(n):
    for chunk in (K7["CHUNK"], K7["EXT_CHUNK"], 3):
        for name, a in _k7_inputs(n, chunk, n).items():
            np.testing.assert_array_equal(
                k7_model(a, chunk), gf.to_u64(gf.inv_plain(_t(a))),
                err_msg=f"{name}, chunk {chunk}")


K7_STUB = """
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct HostDim { unsigned x; };
static HostDim blockIdx, blockDim, threadIdx, gridDim;
template <class T> static inline T __ldg(const T* p) { return *p; }
"""

# every (block, thread) of a launch of csrc/gf_inv.cu, in turn
K7_HOST_GRID = """
static void grid(unsigned blocks, unsigned threads, void (*run)()) {
  gridDim.x = blocks;
  blockDim.x = threads;
  for (blockIdx.x = 0; blockIdx.x < blocks; ++blockIdx.x)
    for (threadIdx.x = 0; threadIdx.x < threads; ++threadIdx.x) run();
}
static const uint64_t *g_a, *g_b;
static uint64_t *g_x, *g_y;
static int64_t g_n;
extern "C" void host_inv(const uint64_t* a, uint64_t* out, int64_t n) {
  g_a = a; g_x = out; g_n = n;
  grid(blocks_for(n, CHUNK), THREADS, [] { inv_kernel(g_a, g_x, g_n); });
}
extern "C" void host_ext_inv(const uint64_t* re, const uint64_t* im,
                             uint64_t* out_re, uint64_t* out_im, int64_t n) {
  g_a = re; g_b = im; g_x = out_re; g_y = out_im; g_n = n;
  grid(blocks_for(n, EXT_CHUNK), THREADS, [] {
    ext_inv_kernel(g_a, g_b, g_x, g_y, g_n);
  });
}
"""


@pytest.fixture(scope="module")
def k7_host(tmp_path_factory):
    """csrc/gf_inv.cu's two kernels built by g++ (the CUDA qualifiers and
    index registers stubbed, gl::inv's host twin) with a loop that runs
    every thread of a launch on the host."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    text = (kernels.CSRC / "gf_inv.cu").read_text()
    start = text.index('#include "goldilocks.cuh"')
    end = text.index("}  // namespace") + len("}  // namespace")
    d = tmp_path_factory.mktemp("k7_host")
    (d / "stub.h").write_text(K7_STUB)
    (d / "k7_host.cpp").write_text(text[start:end] + K7_HOST_GRID)
    so = d / "libk7host.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-I", str(kernels.CSRC),
                    "-include", str(d / "stub.h"), str(d / "k7_host.cpp"),
                    "-o", str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.host_inv.argtypes = [vp, vp, i64]
    lib.host_ext_inv.argtypes = [vp, vp, vp, vp, i64]
    lib.host_inv.restype = lib.host_ext_inv.restype = None
    return lib


@pytest.mark.parametrize("n", [1, 7, 8, 9, 16, 17, 1000, 1 << 12])
def test_k7_built_by_gxx_equals_plain(k7_host, n):
    for name, a in _k7_inputs(n, K7["CHUNK"], n + 1).items():
        x = _t(a)
        got = torch.full_like(x, -1)
        k7_host.host_inv(x.data_ptr(), got.data_ptr(), n)
        assert torch.equal(got, gf.inv_plain(x)), name
    for name, a in _k7_inputs(n, K7["EXT_CHUNK"], n + 2).items():
        b = _elements(n, n + 3)[-n:]
        b[a == 0] = 0  # (0, 0) where a is 0
        x = gfe.GFE(_t(a), _t(b))
        got = gfe.GFE(torch.full_like(x.re, -1), torch.full_like(x.im, -1))
        k7_host.host_ext_inv(x.re.data_ptr(), x.im.data_ptr(),
                             got.re.data_ptr(), got.im.data_ptr(), n)
        want = gfe.inv_plain(x)
        assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im), name


# ---------------------------------------------------------------------------
# K8: its tile scan and decoupled look-back as a model
# ---------------------------------------------------------------------------


def k8_model(x: np.ndarray, threads: int, items: int, exclusive: bool,
             rng, prefix_share: float) -> np.ndarray:
    """K8 on a (rows, n) array in Python ints, in place on a copy, each
    row's tiles in order (the counter hands out a row's tiles in order,
    the rows' interleaved, and a row's tiles read and write only its
    points). Each tile: thread t reads
    and scans its `items` consecutive points, the warp's shuffles (lane l
    takes lane l - d's value for d = 1, 2, 4, 8, 16) scan the threads'
    products, one thread the warps'; then the look-back over windows of 32
    earlier tiles of its row, where each earlier tile is seen with its
    prefix published (with probability `prefix_share`; the row's first
    always) or with its aggregate only, as a block that is still looking
    back would be seen. Thread t writes its own points: the inclusive
    products, or in the exclusive form its prefix, then its inclusive
    products but the last."""
    rows, n = x.shape
    tile = threads * items
    warps = threads // 32
    tiles_per_row = -(-n // tile)
    out = x.copy()
    for r in range(rows):
        aggregate, prefix = [], []
        for part in range(tiles_per_row):
            base = part * tile
            pts = [int(out[r, base + k]) if base + k < n else 1
                   for k in range(tile)]
            v = []
            for t in range(threads):
                acc, row = 1, []
                for j in range(items):
                    acc = acc * pts[t * items + j] % P
                    row.append(acc)
                v.append(row)
            lane_pre, warp_tot = [0] * threads, []
            for w in range(warps):
                y = [v[w * 32 + lane][-1] for lane in range(32)]
                d = 1
                while d < 32:
                    y = [y[lane] * y[lane - d] % P if lane >= d else y[lane]
                         for lane in range(32)]
                    d <<= 1
                for lane in range(32):
                    lane_pre[w * 32 + lane] = y[lane - 1] if lane else 1
                warp_tot.append(y[31])
            warp_pre, total = [], 1
            for p in warp_tot:
                warp_pre.append(total)
                total = total * p % P
            before = 1
            if part:
                seen_prefix = [j == 0 or rng.random() < prefix_share
                               for j in range(part)]
                nearest = part - 1
                while True:
                    window = [nearest - lane for lane in range(32)]
                    flags = [p < 0 or seen_prefix[p] for p in window]
                    stop = flags.index(True) if any(flags) else 32
                    for lane, p in enumerate(window):
                        if lane < stop:
                            before = before * aggregate[p] % P
                        elif lane == stop:
                            before = before * prefix[p] % P
                    if any(flags):
                        break
                    nearest -= 32
            aggregate.append(total)
            prefix.append(before * total % P)
            for t in range(threads):
                pre = before * warp_pre[t // 32] * lane_pre[t] % P
                w = ([pre] + [pre * v[t][j] % P for j in range(items - 1)]
                     if exclusive else [pre * a % P for a in v[t]])
                for j in range(items):
                    i = base + t * items + j
                    if i < n:
                        out[r, i] = w[j]
    return out


@pytest.mark.parametrize("threads,items,n,rows", [
    (K8["THREADS"], K8["ITEMS"], 1, 1),
    (K8["THREADS"], K8["ITEMS"], TILE + 1, 1),
    (K8["THREADS"], K8["ITEMS"], 2 * TILE + 3, 2),
    (64, 2, 40 * 128 + 5, 1),     # 41 tiles: windows past the first 32
    (32, 1, 100, 3)])
@pytest.mark.parametrize("exclusive", [False, True])
def test_k8_model_equals_plain(threads, items, n, rows, exclusive):
    rng = np.random.default_rng(n)
    x = rng.integers(0, P, (rows, n), dtype=np.uint64)
    x[:, n // 3] = 0 if rows > 1 else P - 1
    want = gf.to_u64(gf.prefix_prod_plain(_t(x), exclusive=exclusive))
    for share in (0.0, 0.5, 1.0):
        got = k8_model(x, threads, items, exclusive, rng, share)
        np.testing.assert_array_equal(got, want, err_msg=f"share {share}")


# K8's launch on the host: its blocks in the counter's order, each block's
# threads side by side (tests/torch_host_block.py)
K8_HOST_GRID = """
static const uint64_t* g_x;
static uint64_t *g_out, *g_state;
static int64_t g_n, g_tiles;
static int g_exclusive;
static int64_t g_rows;
template <bool VEC> static void block() {
  scan::scan_kernel<VEC>(g_x, g_out, g_state, g_n, g_rows, g_tiles,
                         g_exclusive);
}
extern "C" void host_prefix_prod(const uint64_t* x, uint64_t* out,
                                 int64_t rows, int64_t n, int exclusive,
                                 int vec) {
  g_tiles = rows * scan::tiles_per_row(n);
  std::vector<uint64_t> state(1 + 3 * g_tiles, 0);
  g_x = x; g_out = out; g_state = state.data(); g_n = n; g_rows = rows;
  g_exclusive = exclusive;
  host_grid(static_cast<unsigned>(g_tiles), scan::THREADS,
            vec ? block<true> : block<false>);
}
"""


@pytest.fixture(scope="module")
def k8_host(tmp_path_factory):
    """csrc/scan.cu's kernel built by g++ (its namespace, with
    tests/torch_host_block.py's stub and goldilocks.cuh's host twins)."""
    from torch_host_block import HOST_BLOCK_STUB

    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    text = (kernels.CSRC / "scan.cu").read_text()
    start = text.index('#include "goldilocks.cuh"')
    end = text.index("}  // namespace scan") + len("}  // namespace scan")
    d = tmp_path_factory.mktemp("k8_host")
    (d / "stub.h").write_text(HOST_BLOCK_STUB)
    (d / "k8_host.cpp").write_text(text[start:end] + K8_HOST_GRID)
    so = d / "libk8host.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-pthread", "-Wno-unknown-pragmas", "-I",
                    str(kernels.CSRC), "-include", str(d / "stub.h"),
                    str(d / "k8_host.cpp"), "-o", str(so)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.host_prefix_prod.argtypes = [vp, vp, i64, i64, ctypes.c_int,
                                     ctypes.c_int]
    lib.host_prefix_prod.restype = None
    return lib


# single rows around a tile, and (rows, n) arrays: a table's Zs of a few
# tiles each, and many short rows (a small table's CTL Zs)
@pytest.mark.parametrize("rows,n", [(1, 1), (1, 3), (1, TILE - 1),
                                    (1, TILE), (1, 2 * TILE + 2),
                                    (3, 2 * TILE + 5), (4, TILE + 6),
                                    (10, 300)])
def test_k8_built_by_gxx_equals_plain(k8_host, rows, n):
    rng = np.random.default_rng(rows * n)
    x = rng.integers(0, P, (rows, n), dtype=np.uint64)
    edge = np.asarray(EDGE[1:], dtype=np.uint64)  # 1, p - 1, EPSILON, 2^32
    x.reshape(-1)[:len(edge)] = edge[:x.size]
    if n > 2:
        x[-1, n // 2] = 0  # the rest of the last row's products are 0
    src = _t(x)
    for exclusive in (False, True):
        want = gf.prefix_prod_plain(src, exclusive=exclusive)
        for vec in sorted({0, int(n % 2 == 0)}):
            out = torch.full((rows, n), -1, dtype=torch.int64)
            k8_host.host_prefix_prod(src.data_ptr(), out.data_ptr(), rows,
                                     n, int(exclusive), vec)
            assert torch.equal(out, want), (exclusive, vec, "out of place")
            y = _t(x)
            k8_host.host_prefix_prod(y.data_ptr(), y.data_ptr(), rows, n,
                                     int(exclusive), vec)
            assert torch.equal(y, want), (exclusive, vec, "in place")


def test_card_checks_use_the_sources_constants():
    # chip_smoke.py sizes its K7 and K8 cases (a zero in every chunk, a
    # tile + 1) by copies of these constants
    import chip_smoke

    assert chip_smoke.SCAN_TILE == TILE and K8["THREADS"] % 32 == 0
    assert (chip_smoke.INV_CHUNK, chip_smoke.EXT_INV_CHUNK) == (
        K7["CHUNK"], K7["EXT_CHUNK"])


# ---------------------------------------------------------------------------
# the FRI composition against olavm_tpu's
# ---------------------------------------------------------------------------


def _composition(monkeypatch, pkg: str, coeffs, points, polys, openings):
    """(values, coefficients) that `pkg`'s prove_openings_device hands to
    its fri_proof_device, on oracles of these coefficients."""
    import importlib

    pd = importlib.import_module(f"{pkg}.stark.prover_device")
    fri = importlib.import_module(f"{pkg}.stark.fri")
    config = importlib.import_module(f"{pkg}.stark.config")
    challenger = importlib.import_module(f"{pkg}.stark.challenger")
    seen = {}

    def capture(oracles, c, v, *args, **kwargs):
        seen["values"], seen["coeffs"] = v, c
        return None

    monkeypatch.setattr(pd, "fri_proof_device", capture)
    cfg = config.StarkConfig.standard_fast_config()
    ch = challenger.Challenger()
    ch.observe_elements([3, 1, 4])
    instance = fri.FriInstance([fri.FriBatchInfo(np.asarray(p, np.uint64), q)
                                for p, q in zip(points, polys)])
    degree_bits = coeffs[0].shape[1].bit_length() - 1

    class Oracle:
        def __init__(self, c):
            self.coeffs = (gf.from_u64(c, "cpu") if pkg == "olavm_tpu_torch"
                           else jgf.from_u64(c))

    args = (instance, openings, [Oracle(c) for c in coeffs], ch, cfg,
            degree_bits)
    if pkg == "olavm_tpu":
        pd.prove_openings_device(*args, cfg.merkle_hasher, None)
        conv = jgfe.to_u64_pair
    else:
        pd.prove_openings_device(*args)
        conv = gfe.to_u64_pair
    return conv(seen["values"]), conv(seen["coeffs"])


def test_fri_composition_equals_olavm_tpu(monkeypatch):
    rng = np.random.default_rng(14)
    n = 8
    coeffs = [rng.integers(0, P, (5, n), dtype=np.uint64),
              rng.integers(0, P, (3, n), dtype=np.uint64)]
    # zeta, g zeta, each over runs of two oracles; short runs, since
    # olavm_tpu traces a program for each run length (tens of seconds for
    # a run of 17 on the CPU)
    points = [rng.integers(0, P, 2, dtype=np.uint64) for _ in range(2)]
    polys = [[(0, 0), (0, 1), (1, 2)], [(1, 1), (0, 4)]]
    openings = [[tuple(int(v) for v in rng.integers(0, P, 2, dtype=np.uint64))
                 for _ in q] for q in polys]
    got = _composition(monkeypatch, "olavm_tpu_torch", coeffs, points, polys,
                       openings)
    want = _composition(monkeypatch, "olavm_tpu", coeffs, points, polys,
                        openings)
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_, w)
