"""The streamed commit on the CPU path (plain versions of the absorb kernels
and of K5): the port's DevicePolynomialBatch, which keeps only coefficients
and digest levels, against olavm_tpu's streamed DevicePolynomialBatch on the
same seeded values (caps, coefficients, query leaves, Merkle paths and the
openings at an extension point, all bit-exact); LeafStream over 16-column
blocks against the one-shot leaf hash at every width class; K5's plain
version against Python-integer Horner; a quotient class by coset FFT
against the strided slice of the full LDE it replaces; and no LDE kept.

olavm_tpu's batches are built once per module (its jitted programs take most
of this file's time), at the smallest sizes that still have Merkle paths."""

import os
import re

import numpy as np
import pytest
import torch

from olavm_tpu.field import gf as jgf
from olavm_tpu.field import gfe as jgfe
from olavm_tpu.stark.oracle_device import (
    DevicePolynomialBatch as JBatch,
)
from olavm_tpu_torch.field import extension as ge
from olavm_tpu_torch.field import gf
from olavm_tpu_torch.field import gfe
from olavm_tpu_torch.field import goldilocks as g
from olavm_tpu_torch.merkle import device as dmerkle
from olavm_tpu_torch.ntt import ntt as dntt
from olavm_tpu_torch.stark.oracle_device import DevicePolynomialBatch
import torch_threads  # noqa: F401  (torch's share of the cores)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = g.P
RATE = 3
# (hasher, columns, log n, cap height): blake3 at every leaf class (noop,
# one message block, two whole blocks, a block and a partial one, two
# chunks); Poseidon at a noop width and a partial last rate chunk
CASES = [("blake3", 3, 3, 2), ("blake3", 7, 3, 2), ("blake3", 16, 3, 2),
         ("blake3", 17, 3, 2), ("blake3", 134, 3, 2),
         ("poseidon", 3, 2, 3), ("poseidon", 17, 2, 3)]
ZETA = (0x1234_5678_9ABC_DEF0 % P, 0x0FED_CBA9_8765_4321 % P)


def _values(C, logn):
    rng = np.random.default_rng(1000 * C + logn)
    return rng.integers(0, P, size=(C, 1 << logn), dtype=np.uint64)


def _indices(logn):
    size = 1 << (logn + RATE)
    return [0, 1, 5, size // 2 + 3, size - 1]


def _ext_powers(z, n):
    out = [(1, 0)]
    for _ in range(n - 1):
        out.append(ge.t_mul(out[-1], z))
    return np.array(out, dtype=np.uint64)


@pytest.fixture(scope="module")
def reference():
    """olavm_tpu's batch per case: cap, coefficients, leaves, paths and the
    values at ZETA."""
    out = {}
    for hasher, C, logn, cap_h in CASES:
        b = JBatch.from_values(jgf.from_u64(_values(C, logn)), RATE, cap_h,
                               hasher)
        pw = _ext_powers(ZETA, 1 << logn)
        zeta_pows = jgfe.GFE(jgf.from_u64(pw[:, 0]), jgf.from_u64(pw[:, 1]))
        out[(hasher, C)] = {
            "cap": np.asarray(b.cap),
            "coeffs": np.asarray(jgf.to_u64(b.coeffs)),
            "leaves": np.asarray(b.query_leaves(_indices(logn))),
            "paths": b.prove_batch(_indices(logn)),
            "at_zeta": np.asarray(b.eval_at_ext(zeta_pows)),
        }
    return out


def _port_batch(hasher, C, logn, cap_h):
    return DevicePolynomialBatch.from_values(
        gf.from_u64(_values(C, logn), "cpu"), RATE, cap_h, hasher)


@pytest.mark.parametrize("hasher,C,logn,cap_h", CASES)
def test_streamed_batch_matches_reference(reference, hasher, C, logn, cap_h):
    want = reference[(hasher, C)]
    got = _port_batch(hasher, C, logn, cap_h)
    np.testing.assert_array_equal(got.cap, want["cap"])
    np.testing.assert_array_equal(gf.to_u64(got.coeffs), want["coeffs"])
    idx = _indices(logn)
    np.testing.assert_array_equal(got.query_leaves(idx), want["leaves"])
    assert got.prove_batch(idx) == want["paths"]
    pw = _ext_powers(ZETA, 1 << logn)
    pows = gfe.GFE(gf.from_u64(pw[:, 0], "cpu"), gf.from_u64(pw[:, 1], "cpu"))
    np.testing.assert_array_equal(got.eval_at_ext(pows), want["at_zeta"])
    # both points of the openings in one evaluation
    both = torch.stack([pows.re, pows.im, pows.im, pows.re])
    at, swapped = got.eval_at_ext_rows(both)
    np.testing.assert_array_equal(at, want["at_zeta"])
    np.testing.assert_array_equal(swapped, want["at_zeta"][:, ::-1])


@pytest.mark.parametrize("hasher,C,logn,cap_h", CASES[:1] + CASES[-1:])
def test_batch_keeps_no_lde(hasher, C, logn, cap_h):
    b = _port_batch(hasher, C, logn, cap_h)
    assert set(vars(b)) == {"coeffs", "levels", "cap", "degree_log",
                            "rate_bits"}
    size = 1 << (logn + RATE)
    # the digest levels are (8, m) words; no tensor holds C x size values
    assert all(lvl.shape[0] == 8 for lvl in b.levels)
    assert b.levels[0].shape[1] == size and b.coeffs.shape == (C, 1 << logn)
    b.free()
    assert b.coeffs is None and b.levels is None


def test_no_port_source_reads_an_lde():
    reads = re.compile(r"\.lde\b(?!_)")
    for base, _, files in os.walk(os.path.join(ROOT, "olavm_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(base, name)) as f:
                    for line in f:
                        assert not reads.search(line), (name, line)


BLAKE3_WIDTHS = (5, 8, 9, 16, 17, 29, 94, 128, 129, 134, 200, 256)
POSEIDON_WIDTHS = (5, 8, 9, 16, 17, 94, 134)


def _stream(cols, hasher, block=16):
    C, n = cols.shape
    s = dmerkle.LeafStream(C, n, hasher)
    for start in range(0, C, block):
        s.absorb(cols[start:start + block])
    return s.finalize()


@pytest.mark.parametrize("hasher,C", [("blake3", c) for c in BLAKE3_WIDTHS]
                         + [("poseidon", c) for c in POSEIDON_WIDTHS])
def test_leaf_stream_matches_one_shot(hasher, C):
    n = 64 if hasher == "blake3" else 16
    rng = np.random.default_rng(C)
    x = rng.integers(0, P, size=(C, n), dtype=np.uint64)
    x[:, 0] = P - 1
    x[:, 1] = 0
    cols = gf.from_u64(x, "cpu")
    want = dmerkle.leaf_digests(cols, hasher)
    assert torch.equal(_stream(cols, hasher), want)
    # blocks of 8 columns reach every message-block position alone
    assert torch.equal(_stream(cols, hasher, 8), want)


def test_leaf_stream_refuses_misplaced_blocks():
    cols = gf.from_u64(np.arange(40 * 4, dtype=np.uint64).reshape(40, 4), "cpu")
    s = dmerkle.LeafStream(40, 4, "blake3")
    with pytest.raises(ValueError):
        s.absorb(cols[:12])  # ends off an 8-column boundary before the last
    with pytest.raises(ValueError):
        dmerkle.LeafStream(40, 4, "blake3").absorb(cols[:24])  # over 16
    s = dmerkle.LeafStream(40, 4, "blake3")
    s.absorb(cols[:16])
    with pytest.raises(ValueError):
        s.finalize()  # not every column absorbed
    with pytest.raises(ValueError):
        dmerkle.LeafStream(4, 4, "blake3")  # noop leaves have no stream
    s = dmerkle.LeafStream(136, 4, "blake3")
    for start in range(0, 120, 16):
        s.absorb(gf.from_u64(np.zeros((16, 4), dtype=np.uint64), "cpu"))
    with pytest.raises(ValueError):
        # columns 120..135 would cross the chunk boundary at 128
        s.absorb(gf.from_u64(np.zeros((16, 4), dtype=np.uint64), "cpu"))


@pytest.mark.parametrize("C,n,k", [(1, 1, 1), (3, 17, 5), (5, 64, 28),
                                   (2, 200, 33)])
def test_eval_points_plain_matches_horner(C, n, k):
    rng = np.random.default_rng(C * n + k)
    coeffs = rng.integers(0, P, size=(C, n), dtype=np.uint64)
    points = [int(v) for v in rng.integers(0, P, size=k, dtype=np.uint64)]
    points[0] = P - 1
    pows = gf.power_rows(points, n, "cpu")
    for t, x in enumerate(points):
        assert [int(v) for v in gf.to_u64(pows[t])] == [
            pow(x, i, P) for i in range(n)]
    got = gf.to_u64(gf.eval_points(gf.from_u64(coeffs, "cpu"), pows))
    for t, x in enumerate(points):
        for c in range(C):
            acc = 0
            for a in reversed(coeffs[c].tolist()):
                acc = (acc * x + a) % P
            assert int(got[t, c]) == acc


@pytest.mark.parametrize("qdb", [1, 2])
def test_quotient_class_by_coset_fft_equals_lde_slice(qdb):
    degree_bits = 5
    rng = np.random.default_rng(qdb)
    coeffs = gf.from_u64(rng.integers(0, P, size=(3, 1 << degree_bits),
                                      dtype=np.uint64), "cpu")
    lde = dntt.coset_lde(coeffs, RATE)
    w = g.primitive_root_of_unity(degree_bits + qdb)
    step = 1 << (RATE - qdb)
    for r in range(1 << qdb):
        shift = g.mul(g.MULTIPLICATIVE_GROUP_GENERATOR, pow(w, r, P))
        assert torch.equal(dntt.coset_fft(coeffs, shift),
                           lde[:, r * step::1 << RATE])
