"""K2's arithmetic on the host: olavm_tpu_torch/csrc/poseidon_perm.cuh (and
the goldilocks.cuh it includes) compiled with g++ through a stub header that
defines the CUDA qualifiers away, so the device functions' unsigned __int128
twins stand in for their PTX. The permutation is held bit-exact against the
port's permute_np and olavm_tpu's, at random and edge states; the MDS check
of gl_poseidon_init must refuse tables that differ from the compiled
constants; the reductions are held against Python integers at the ends of
their input ranges. The Poseidon Merkle kernels' device functions
(csrc/poseidon_merkle.cuh: the leaf sponge and two_to_one) are held
bit-exact against olavm_tpu's PoseidonHasher at every leaf width class.
Takes seconds; skips only where g++ is absent."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from olavm_tpu.hash import poseidon as jpos
from olavm_tpu.hash.hashers import by_name
from olavm_tpu_torch import kernels
from olavm_tpu_torch.hash import poseidon as tpos
import torch_threads  # noqa: F401  (torch's share of the cores)

P = 2**64 - 2**32 + 1
M64 = 2**64 - 1

STUB = """
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
"""

# gl_poseidon_init's check and copies, and the kernel's loop, on the host
HOST_SOURCE = """
#include <cstring>
#include "poseidon_perm.cuh"
#include "poseidon_merkle.cuh"

using namespace poseidon;

extern "C" int k2_init(const uint64_t* rc, const uint64_t* circ,
                       const uint64_t* diag, const uint64_t* first,
                       const uint64_t* prc, const uint64_t* vs,
                       const uint64_t* wh, const uint64_t* init) {
  if (mds_mismatch(circ, diag)) return -1;
  std::memcpy(c_rc, rc, sizeof(c_rc));
  std::memcpy(c_first, first, sizeof(c_first));
  std::memcpy(c_prc, prc, sizeof(c_prc));
  std::memcpy(c_vs, vs, sizeof(c_vs));
  std::memcpy(c_wh, wh, sizeof(c_wh));
  std::memcpy(c_init, init, sizeof(c_init));
  return 0;
}

extern "C" void k2_permute(const uint64_t* in, uint64_t* out, int64_t n) {
  for (int64_t lane = 0; lane < n; ++lane) {
    uint64_t s[WIDTH];
    for (int i = 0; i < WIDTH; ++i) s[i] = in[i * n + lane];
    permute(s);
    for (int i = 0; i < WIDTH; ++i) out[i * n + lane] = s[i];
  }
}

// the leaf kernel's chunk loop (poseidon.cu leaves_kernel, without the
// staging): (C, n) columns -> (4, n) digest elements
extern "C" void k2_leaves(const uint64_t* cols, uint64_t* out, int64_t n,
                          int C) {
  const int chunks = (C + RATE - 1) / RATE;
  const int last = C - (chunks - 1) * RATE;
  for (int64_t t = 0; t < n; ++t) {
    uint64_t s[WIDTH] = {};
    for (int c = 0; c < chunks; ++c) {
      absorb(s, cols + static_cast<int64_t>(c) * RATE * n + t, n,
             c + 1 == chunks ? last : RATE);
      permute(s);
    }
    for (int w = 0; w < DIGEST; ++w) out[w * n + t] = s[w];
  }
}

// the level kernel's loop: (4, n) digest elements -> (4, n / 2)
extern "C" void k2_level(const uint64_t* digests, uint64_t* out, int64_t n) {
  const int64_t parents = n / 2;
  for (int64_t i = 0; i < parents; ++i) {
    uint64_t left[DIGEST], right[DIGEST], s[WIDTH];
    for (int w = 0; w < DIGEST; ++w) {
      left[w] = digests[w * n + 2 * i];
      right[w] = digests[w * n + 2 * i + 1];
    }
    two_to_one(left, right, s);
    for (int w = 0; w < DIGEST; ++w) out[w * parents + i] = s[w];
  }
}

extern "C" uint64_t k2_limbs(uint32_t s0, uint32_t s1, uint32_t s2) {
  return limbs_to_lazy(s0, s1, s2);
}

extern "C" uint64_t k2_reduce160(uint64_t lo, uint64_t hi, uint32_t top) {
  return gl::reduce160_lazy({lo, hi, top});
}

extern "C" uint64_t k2_reduce128(uint64_t lo, uint64_t hi) {
  return gl::reduce128_lazy(lo, hi);
}

extern "C" uint64_t k2_mul(uint64_t a, uint64_t b) { return gl::mul(a, b); }

extern "C" uint64_t k2_add_lazy(uint64_t x, uint64_t c) { return gl::add_lazy(x, c); }

extern "C" void k2_mul_small(uint64_t a, uint32_t c, uint64_t* out) {
  const gl::u128 w = mul_small(a, c);
  out[0] = w.lo;
  out[1] = w.hi;
}

extern "C" uint64_t k2_dot(const uint64_t* a, const uint64_t* b, int n) {
  gl::u160 acc = {0, 0, 0};
  for (int i = 0; i < n; ++i) gl::acc_add(acc, gl::mul_wide(a[i], b[i]));
  return gl::reduce160_lazy(acc);
}
"""


@pytest.fixture(scope="module")
def k2(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("k2_host")
    (d / "stub.h").write_text(STUB)
    (d / "k2_host.cpp").write_text(HOST_SOURCE)
    so = d / "libk2host.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-I", str(kernels.CSRC),
                    "-include", str(d / "stub.h"), str(d / "k2_host.cpp"),
                    "-o", str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    vp, u64, u32 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32
    lib.k2_init.argtypes = [vp] * 8
    lib.k2_permute.argtypes = [vp, vp, ctypes.c_int64]
    lib.k2_permute.restype = None
    lib.k2_leaves.argtypes = [vp, vp, ctypes.c_int64, ctypes.c_int]
    lib.k2_leaves.restype = None
    lib.k2_level.argtypes = [vp, vp, ctypes.c_int64]
    lib.k2_level.restype = None
    lib.k2_limbs.argtypes = [u32, u32, u32]
    lib.k2_reduce160.argtypes = [u64, u64, u32]
    lib.k2_reduce128.argtypes = [u64, u64]
    lib.k2_mul.argtypes = [u64, u64]
    lib.k2_add_lazy.argtypes = [u64, u64]
    lib.k2_mul_small.argtypes = [u64, u32, vp]
    lib.k2_mul_small.restype = None
    lib.k2_dot.argtypes = [vp, vp, ctypes.c_int]
    for fn in ("k2_limbs", "k2_reduce160", "k2_reduce128", "k2_mul",
               "k2_dot", "k2_add_lazy"):
        getattr(lib, fn).restype = u64
    tables = tpos._kernel_tables()
    assert lib.k2_init(*[t.ctypes.data for t in tables]) == 0
    return lib


def permute_host(lib, states: np.ndarray) -> np.ndarray:
    """(k, 12) states through the compiled header, as the kernel lays them
    out: (12, k) rows."""
    cols = np.ascontiguousarray(states.T, dtype=np.uint64)
    out = np.empty_like(cols)
    lib.k2_permute(cols.ctypes.data, out.ctypes.data, cols.shape[1])
    return out.T


def test_permutation_matches_numpy(k2):
    rng = np.random.default_rng(4)
    states = np.concatenate([
        tpos.edge_states(),
        rng.integers(0, P, size=(4096, tpos.WIDTH), dtype=np.uint64)])
    got = permute_host(k2, states)
    np.testing.assert_array_equal(got, tpos.permute_np(states))
    np.testing.assert_array_equal(got, jpos.permute_np(states))


def _leaf_rows(C: int) -> np.ndarray:
    """(64, C) leaves: random, then all p-1, all 0, and 0 / p-1 alternating."""
    rows = np.random.default_rng(C).integers(0, P, size=(64, C), dtype=np.uint64)
    rows[0], rows[1] = P - 1, 0
    rows[2] = np.where(np.arange(C) % 2, P - 1, 0)
    return rows


@pytest.mark.parametrize("C", [1, 4, 5, 8, 9, 16, 17, 32, 94, 134])
def test_leaf_sponge_matches_reference_hasher(k2, C):
    # C = 9, 17, 134: the last chunk overwrites only its own words
    rows = _leaf_rows(C)
    cols = np.ascontiguousarray(rows.T)
    out = np.empty((4, rows.shape[0]), dtype=np.uint64)
    k2.k2_leaves(cols.ctypes.data, out.ctypes.data, rows.shape[0], C)
    np.testing.assert_array_equal(out.T, by_name("poseidon").hash_leaves(rows))


def test_two_to_one_matches_reference_hasher(k2):
    digests = _leaf_rows(4)
    elems = np.ascontiguousarray(digests.T)  # (4, 64)
    out = np.empty((4, 32), dtype=np.uint64)
    k2.k2_level(elems.ctypes.data, out.ctypes.data, 64)
    np.testing.assert_array_equal(
        out.T, by_name("poseidon").compress(digests[0::2], digests[1::2]))


@pytest.mark.parametrize("table", [1, 2])
def test_init_refuses_other_mds_tables(k2, table):
    tables = tpos._kernel_tables()
    for i in (0, 11):
        wrong = [t.copy() for t in tables]
        wrong[table][i] += 1
        assert k2.k2_init(*[t.ctypes.data for t in wrong]) == -1
    assert k2.k2_init(*[t.ctypes.data for t in tables]) == 0


def _lazy(got: int, value: int) -> bool:
    """A lazy residue: below 2^64 and congruent to value mod p."""
    return got <= M64 and got % P == value % P


def test_reductions_at_the_ends_of_their_ranges(k2):
    # the MDS layer's three limb sums: below 264 * 2^22 (264 * 2^20 for the
    # top limb) in the permutation, below 2^32 as the function allows
    for s0 in (0, 1, 264 * (2**22 - 1), 2**32 - 1):
        for s1 in (0, 1, 264 * (2**22 - 1), 2**32 - 1):
            for s2 in (0, 1, 2**20, 264 * (2**20 - 1), 2**32 - 1):
                assert _lazy(k2.k2_limbs(s0, s1, s2),
                             s0 + (s1 << 22) + (s2 << 44))
    for lo in (0, 1, 2**32 - 1, 2**32, P - 1, P, M64 - 2**32, M64):
        for hi in (0, 1, 2**32 - 1, 2**32, P - 1, P, 2**64 - 2**32, M64):
            assert _lazy(k2.k2_reduce128(lo, hi), lo + (hi << 64))
            # 160-bit sums of up to 12 products
            for t in (0, 1, 11, 12):
                assert _lazy(k2.k2_reduce160(lo, hi, t),
                             lo + (hi << 64) + (t << 128))
    words = (0, 1, P - 1, P, 2**32 - 1, 2**32, 0xFFFFFFFEFFFFFFFF, M64)
    buf = np.zeros(2, dtype=np.uint64)
    for a in words:
        # a lazy word plus a canonical constant, also where the sum carries
        for c in (0, 1, 2**32 - 1, 2**32, P - 2, P - 1):
            assert _lazy(k2.k2_add_lazy(a, c), a + c)
        for b in words:
            assert k2.k2_mul(a, b) == (a * b) % P
        for c in (1, 25, 49):
            k2.k2_mul_small(a, c, buf.ctypes.data)
            assert int(buf[0]) + (int(buf[1]) << 64) == a * c
    # a dot product of 12 largest words: the 160-bit sum's carries
    for w in (P - 1, M64):
        v = np.full(12, w, dtype=np.uint64)
        assert _lazy(k2.k2_dot(v.ctypes.data, v.ctypes.data, 12), 12 * w * w)
