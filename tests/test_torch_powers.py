"""K13 (csrc/powers.cu, gf.powers and gfe.powers: a power table in one
launch) and the coset transforms that now scale through gl_scale_powers
(gf.scale_powers; ntt.scale_by_powers, coset_fft, coset_ifft, coset_lde,
intt), on the CPU, exact throughout (tolerance 0: field arithmetic has one
answer):

- the plain versions (gf.powers_plain, gfe.powers_plain) against Python's
  integers at n in {1, 2, 3, 2^k - 1, 2^k + 1, 2^12} with edge bases (0, 1,
  p - 1, 2^32, phi alone in the extension, random ones), a (k,) row of
  bases, and against olavm_tpu's gf.powers and gfe.powers (jnp
  log-doubling; a few n, its eager calls take seconds);
- csrc/powers.cu built by g++ (the CUDA qualifiers stubbed, every thread of
  a launch run on the host) equals the plain versions in both fields, on
  a row of bases and on one, at n that are not a multiple of a lane's run,
  a block's points or beyond one block;
- scale_by_powers, coset_fft, coset_ifft and coset_lde through the new path
  against olavm_tpu/ntt/ntt.py's (its coset scaling, padding and inverse
  shift; its transforms swapped for olavm_tpu.ntt.host's, which its own
  tests hold equal to the jnp ladder, whose eager calls take seconds a
  shape) at C in {1, 3, 17} and n in {2, 2^5, 2^10};
- the query points' power tables (DevicePolynomialBatch.query_powers, now
  gf.powers on a row of bases) equal gf.power_rows'.
On the card, tests/test_torch_cuda.py holds K13 to its plain version and
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
from olavm_tpu.field import gfe as jgfe
from olavm_tpu.ntt import host as ntt_host
from olavm_tpu.ntt import ntt as jntt
from olavm_tpu_torch import kernels
from olavm_tpu_torch.field import gf, gfe
from olavm_tpu_torch.field import goldilocks as g
from olavm_tpu_torch.ntt import ntt as tntt
from olavm_tpu_torch.stark.oracle_device import DevicePolynomialBatch
import torch_threads  # noqa: F401  (torch's share of the cores)

P = g.P
W = 7
NS = (1, 2, 3, 31, 33, 63, 65, 4095, 4096, 4097)
BASES = (0, 1, P - 1, 1 << 32, 0xFFFFFFFF, 1234567890123456789 % P)
EXT_BASES = ((0, 0), (1, 0), (P - 1, 0), (1 << 32, 0), (0, 1), (0, P - 1),
             (123456789, P - 5), (P - 1, P - 1))


def _u(t):
    return [int(v) for v in gf.to_u64(t).reshape(-1)]


def _ext_mul(a, b):
    return ((a[0] * b[0] + W * a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def _ext_pows(b, n):
    out, x = [], (1, 0)
    for _ in range(n):
        out.append(x)
        x = _ext_mul(x, b)
    return out


def _constants() -> dict:
    text = (kernels.CSRC / "powers.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", text)}


def test_sources_and_counters():
    assert "powers" in kernels.SOURCES
    assert {"powers", "ext_powers", "scale_powers"} <= set(kernels.LAUNCHES)
    k = _constants()
    assert (k["THREADS"], k["WARP"]) == (128, 32) and k["RUN"] >= 1


# ---------------------------------------------------------------------------
# the plain versions against Python's integers and olavm_tpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", NS)
def test_gf_powers_plain_against_python(n):
    for b in BASES:
        want = [pow(b, j, P) for j in range(n)]
        assert _u(gf.powers_plain(gf.scalar(b, "cpu"), n)) == want, b
        # a host int on the CPU takes the plain version too
        assert _u(gf.powers(b, n, "cpu")) == want, b
    rows = gf.powers_plain(gf.from_u64(list(BASES), "cpu"), n)
    assert rows.shape == (len(BASES), n)
    assert [_u(r) for r in rows] == [[pow(b, j, P) for j in range(n)]
                                     for b in BASES]


@pytest.mark.parametrize("n", NS)
def test_gfe_powers_plain_against_python(n):
    for b in EXT_BASES:
        base = gfe.from_u64_pair(np.asarray(b, dtype=np.uint64), "cpu")
        got = gfe.powers(base, n)
        assert list(zip(_u(got.re), _u(got.im))) == _ext_pows(b, n), b
        stacked = gfe.powers_stacked(base, n)
        assert torch.equal(stacked, torch.stack([got.re, got.im]))


def test_powers_equal_olavm_tpu():
    np.testing.assert_array_equal(
        gf.to_u64(gf.powers(1 << 32, 33, "cpu")),
        jgf.to_u64(jgf.powers(1 << 32, 33)))
    for b, n in (((0, 1), 33), ((123456789, P - 5), 3)):
        pair = np.asarray(b, dtype=np.uint64)
        np.testing.assert_array_equal(
            gfe.to_u64_pair(gfe.powers(gfe.from_u64_pair(pair, "cpu"), n)),
            jgfe.to_u64_pair(jgfe.powers(jgfe.from_u64_pair(pair), n)))


def test_wrappers_take_the_plain_versions_on_the_cpu():
    kernels.reset_launches()
    b = gf.scalar(5, "cpu")
    assert torch.equal(gf.powers(b, 100), gf.powers_plain(b, 100))
    e = gfe.GFE(gf.scalar(5, "cpu"), gf.scalar(3, "cpu"))
    assert torch.equal(gfe.powers(e, 100).re, gfe.powers_plain(e, 100).re)
    x = gf.from_u64(np.arange(40, dtype=np.uint64).reshape(2, 20), "cpu")
    assert torch.equal(gf.scale_powers(x, 9, 4),
                       gf.scale_powers_plain(x, gf.scalar(9, "cpu"), 4))
    assert kernels.LAUNCHES["powers"] == kernels.LAUNCHES["ext_powers"] == 0
    assert kernels.LAUNCHES["scale_powers"] == 0


# ---------------------------------------------------------------------------
# csrc/powers.cu built by g++, every thread run on the host
# ---------------------------------------------------------------------------

STUB = """
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct HostDim { unsigned x, y; };
static HostDim blockIdx, blockDim, threadIdx, gridDim;
template <class T> static inline T __ldg(const T* p) { return *p; }
"""

HOST_GRID = """
static void grid(unsigned blocks, unsigned rows, void (*run)()) {
  gridDim = {blocks, rows};
  blockDim.x = powers::THREADS;
  for (blockIdx.y = 0; blockIdx.y < rows; ++blockIdx.y)
    for (blockIdx.x = 0; blockIdx.x < blocks; ++blockIdx.x)
      for (threadIdx.x = 0; threadIdx.x < powers::THREADS; ++threadIdx.x)
        run();
}
static const uint64_t *g_bases, *g_re, *g_im;
static uint64_t* g_out;
static int64_t g_n;
static void base() { powers::base_kernel(g_bases, g_out, g_n); }
static void ext() { powers::ext_kernel(g_re, g_im, g_out, g_n); }
extern "C" void host_powers(const uint64_t* bases, uint64_t* out,
                            int64_t rows, int64_t n) {
  g_bases = bases; g_out = out; g_n = n;
  grid(powers::blocks(n), static_cast<unsigned>(rows), base);
}
extern "C" void host_ext_powers(const uint64_t* re, const uint64_t* im,
                                uint64_t* out, int64_t n) {
  g_re = re; g_im = im; g_out = out; g_n = n;
  grid(powers::blocks(n), 1, ext);
}
"""


@pytest.fixture(scope="module")
def powers_host(tmp_path_factory):
    """csrc/powers.cu's kernels built by g++ (goldilocks.cuh's host twins)
    with a loop that runs every thread of a launch on the host."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    text = (kernels.CSRC / "powers.cu").read_text()
    start = text.index('#include "goldilocks.cuh"')
    end = text.index("}  // namespace powers") + len("}  // namespace powers")
    d = tmp_path_factory.mktemp("powers_host")
    (d / "stub.h").write_text(STUB)
    (d / "powers_host.cpp").write_text(text[start:end] + HOST_GRID)
    so = d / "libpowershost.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-I", str(kernels.CSRC),
                    "-include", str(d / "stub.h"), str(d / "powers_host.cpp"),
                    "-o", str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.host_powers.argtypes = [vp, vp, i64, i64]
    lib.host_ext_powers.argtypes = [vp, vp, vp, i64]
    lib.host_powers.restype = lib.host_ext_powers.restype = None
    return lib


# a lane's run is 32 x RUN points apart; a block writes THREADS x RUN
@pytest.mark.parametrize("n", [1, 2, 3, 31, 33, 1025, 4095, 4096, 4097,
                               2 * 4096 + 5])
def test_k13_built_by_gxx_equals_plain(powers_host, n):
    bases = gf.from_u64(list(BASES), "cpu")
    got = torch.full((len(BASES), n), -1, dtype=torch.int64)
    powers_host.host_powers(bases.data_ptr(), got.data_ptr(), len(BASES), n)
    assert torch.equal(got, gf.powers_plain(bases, n))
    for k, b in enumerate(BASES):  # one row
        one = torch.full((n,), -1, dtype=torch.int64)
        powers_host.host_powers(bases[k:].data_ptr(), one.data_ptr(), 1, n)
        assert torch.equal(one, gf.powers_plain(gf.scalar(b, "cpu"), n)), b
    for b in EXT_BASES:
        base = gfe.from_u64_pair(np.asarray(b, dtype=np.uint64), "cpu")
        ext = torch.full((2, n), -1, dtype=torch.int64)
        powers_host.host_ext_powers(base.re.data_ptr(), base.im.data_ptr(),
                                    ext.data_ptr(), n)
        want = gfe.powers_plain(base, n)
        assert torch.equal(ext, torch.stack([want.re, want.im])), b


# ---------------------------------------------------------------------------
# the coset transforms against olavm_tpu/ntt/ntt.py's
# ---------------------------------------------------------------------------


def _host_transform(fn):
    def run(x):
        return jgf.from_u64(fn(jgf.to_u64(x)))
    return run


@pytest.mark.parametrize("log_n", [1, 5, 10])
@pytest.mark.parametrize("C", [1, 3, 17])
def test_coset_transforms_equal_olavm_tpu(monkeypatch, C, log_n):
    monkeypatch.setattr(jntt, "ntt", _host_transform(ntt_host.ntt))
    monkeypatch.setattr(jntt, "intt", _host_transform(ntt_host.intt))
    n = 1 << log_n
    rng = np.random.default_rng(C * 100 + log_n)
    x = rng.integers(0, P, (C, n), dtype=np.uint64)
    x[0, :3] = (0, P - 1, 1 << 32)[:n]
    t, j = gf.from_u64(x, "cpu"), jgf.from_u64(x)
    shift = g.MULTIPLICATIVE_GROUP_GENERATOR
    base = int(rng.integers(1, P, dtype=np.uint64))
    kernels.reset_launches()
    pairs = [
        (tntt.scale_by_powers(t, base), jntt.scale_by_powers(j, base)),
        (tntt.coset_fft(t), jntt.coset_fft(j)),
        (tntt.coset_fft(t, gf.scalar(base, "cpu")), jntt.coset_fft(j, base)),
        (tntt.coset_ifft(t), jntt.coset_ifft(j)),
        (tntt.coset_ifft(t, base), jntt.coset_ifft(j, base)),
        (tntt.coset_lde(t, 3, base), jntt.coset_lde(j, 3, base)),
        (tntt.intt(t), jgf.from_u64(ntt_host.intt(x))),
    ]
    for k, (got, want) in enumerate(pairs):
        np.testing.assert_array_equal(gf.to_u64(got), jgf.to_u64(want),
                                      err_msg=str(k))
    assert tntt.coset_ifft(tntt.coset_fft(t, shift), shift).equal(t)
    assert sum(kernels.LAUNCHES.values()) == 0


def test_query_powers_are_power_rows():
    rng = np.random.default_rng(7)
    n = 64
    coeffs = gf.from_u64(rng.integers(0, P, (3, n), dtype=np.uint64), "cpu")
    batch = DevicePolynomialBatch(coeffs, None, None, rate_bits=3)
    idx = [int(v) for v in rng.integers(0, n << 3, 28)]
    assert torch.equal(batch.query_powers(idx),
                       gf.power_rows(batch.query_points(idx), n, "cpu"))
