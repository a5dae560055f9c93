"""The port's blake3 and Merkle commitment (olavm_tpu_torch.hash.blake3,
merkle/device.py, stark/oracle_device.py) against the official BLAKE3
vectors, olavm_tpu's blake3 leaf hashing, the host PolynomialBatch and the
JAX package's DevicePolynomialBatch: caps, coefficients, query leaves and
paths must be equal. Covers the noop leaves (C <= 4), two-chunk leaves
(C > 128, the 134-column Poseidon table), the 256-column limit, FRI's
32-column extension leaves and the empty paths of degree-2 tables. On CPU
tensors `leaf_digests` and `compress_level` run their plain versions
(`leaf_digests_plain`, `compress_level_plain`), the ones the blake3 kernels
are held against on the card.

The Poseidon configuration (merkle_hasher="poseidon") gets the same checks:
leaf digests at every sponge width class (a partial last chunk at C = 9, 17,
134) and tree levels against olavm_tpu's PoseidonHasher, whole commitments
against the host PolynomialBatch and the JAX DevicePolynomialBatch, and the
FRI trees. Keccak has no device path and must raise."""

import numpy as np
import pytest
import torch

from olavm_tpu.field import extension as ge
from olavm_tpu.field import gf as jgf
from olavm_tpu.field import goldilocks as g
from olavm_tpu.hash.blake3 import hash_leaves_np
from olavm_tpu.hash.hashers import by_name
from olavm_tpu.merkle.tree import MerkleTree
from olavm_tpu.ntt import host as ntt_host
from olavm_tpu.stark.oracle import PolynomialBatch
from olavm_tpu.stark.oracle_device import (
    DevicePolynomialBatch as JaxPolynomialBatch,
)
from olavm_tpu_torch import convert, kernels
from olavm_tpu_torch.field import gfe
from olavm_tpu_torch.hash import blake3 as tb3
from olavm_tpu_torch.hash import poseidon as tpos
from olavm_tpu_torch.merkle import device as tmerkle
from olavm_tpu_torch.stark.oracle_device import DevicePolynomialBatch
import torch_threads  # noqa: F401  (torch's share of the cores)


def _blake3(data: bytes) -> bytes:
    """BLAKE3 of one message of at most 64 bytes through the port's compress."""
    block = np.frombuffer(data.ljust(64, b"\0"), dtype="<u4").astype(np.int64)
    m = torch.from_numpy(block).reshape(16, 1)
    out = tb3.compress(tb3.iv_lanes(1, "cpu"), m, len(data),
                       tb3.CHUNK_START | tb3.CHUNK_END | tb3.ROOT)
    return out[:, 0].numpy().astype("<u4").tobytes()


def test_blake3_official_vectors():
    assert _blake3(b"abc").hex() == (
        "6437b3ac38465133ffb63b75273a8db548c558465d79db03fd359c6cd5bd9d85")
    assert _blake3(b"\x00").hex() == (
        "2d3adedff11b61f14c886e35afa036736dcd87a74d27b5c1510225d0f592e213")


def _eval_at_ext_host(vals: np.ndarray, z: np.ndarray) -> list:
    """Each column's polynomial (interpolated from its values) at the
    extension point z, by Horner on the host."""
    out = []
    for coeffs in ntt_host.intt(vals):
        acc = ge.from_base(0)
        for c in reversed(coeffs.tolist()):
            acc = ge.add(ge.mul(acc, z), ge.from_base(c))
        out.append(ge.t(acc))
    return out


@pytest.mark.parametrize("C", [5, 8, 9, 16, 18, 29, 32, 94, 128, 129, 134, 255,
                               256])
def test_leaf_digests_match_reference(C):
    rows = np.random.default_rng(C).integers(0, g.P, size=(7, C), dtype=np.uint64)
    cols = convert.from_u64(rows.T.copy(), "cpu")
    before = dict(kernels.LAUNCHES)
    digs = tmerkle.leaf_digests(cols)
    np.testing.assert_array_equal(tmerkle.digests_to_u64(digs),
                                  hash_leaves_np(rows))
    assert torch.equal(tmerkle.leaf_digests_plain(cols), digs)
    # a CPU tensor never reaches a kernel
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("arity", [4, 16])
def test_fri_extension_leaves_match_reference(arity):
    # _DeviceExtTree's leaves: `arity` consecutive extension values, each as
    # (re, im), so arity 16 gives 32-column leaves
    from olavm_tpu_torch.stark.prover_device import _DeviceExtTree

    n = 16 * arity
    vals = np.random.default_rng(arity).integers(0, g.P, size=(n, 2),
                                                 dtype=np.uint64)
    tree = _DeviceExtTree(gfe.from_u64_pair(vals, "cpu"), arity, 2)
    perm = np.array([int(f"{i:0{n.bit_length() - 1}b}"[::-1], 2)
                     for i in range(n)])
    rows = vals[perm].reshape(n // arity, 2 * arity)
    host = MerkleTree.build(rows, 2, hasher=by_name("blake3"))
    np.testing.assert_array_equal(tmerkle.digests_to_u64(tree.levels[0]),
                                  hash_leaves_np(rows))
    np.testing.assert_array_equal(tree.cap, np.asarray(host.cap, dtype=np.uint64))


def test_noop_leaves_and_width_limit():
    rows = np.random.default_rng(0).integers(0, g.P, size=(5, 3), dtype=np.uint64)
    digs = tmerkle.digests_to_u64(
        tmerkle.leaf_digests(convert.from_u64(rows.T.copy(), "cpu")))
    np.testing.assert_array_equal(digs[:, :3], rows)
    assert not digs[:, 3].any()
    with pytest.raises(ValueError):
        tmerkle.leaf_digests(torch.zeros((257, 2), dtype=torch.int64))


def test_compress_level_matches_reference():
    digs = np.random.default_rng(1).integers(0, 1 << 63, size=(8, 4),
                                             dtype=np.uint64)
    words = np.stack([digs & np.uint64(0xFFFFFFFF), digs >> np.uint64(32)],
                     axis=-1).reshape(8, 8).T.astype(np.int64)
    parent = tmerkle.compress_level(torch.from_numpy(words.copy()))
    assert torch.equal(
        tmerkle.compress_level_plain(torch.from_numpy(words.copy())), parent)
    np.testing.assert_array_equal(tmerkle.digests_to_u64(parent),
                                  by_name("blake3").compress(digs[0::2],
                                                             digs[1::2]))


@pytest.mark.parametrize("C,logn", [(1, 5), (4, 4), (9, 6), (134, 3), (53, 1),
                                    (26, 1)])
def test_commit_matches_host_batch(C, logn):
    vals = np.random.default_rng(C * 100 + logn).integers(
        0, g.P, size=(C, 1 << logn), dtype=np.uint64)
    host = PolynomialBatch.from_values(vals, 3, 4, by_name("blake3"))
    port = DevicePolynomialBatch.from_values(convert.from_u64(vals, "cpu"), 3, 4)
    np.testing.assert_array_equal(port.cap, host.cap)
    np.testing.assert_array_equal(convert.to_u64(port.coeffs), host.polynomials)
    size = 1 << (logn + 3)
    idxs = [0, 1, 5, size - 1]
    leaves = port.query_leaves(idxs)
    proofs = port.prove_batch(idxs)
    for i, x in enumerate(idxs):
        hleaf, hproof = host.leaf_and_proof(x)
        assert [int(v) for v in leaves[i]] == hleaf
        assert proofs[i] == hproof
        assert MerkleTree.verify(hleaf, x, port.cap, proofs[i],
                                 hasher=by_name("blake3"))
    if logn == 1:  # degree 2: the leaves are the cap, the paths are empty
        assert all(p == [] for p in proofs)


def test_commit_and_openings_match_jax_batch():
    vals = np.random.default_rng(7).integers(0, g.P, size=(9, 16),
                                             dtype=np.uint64)
    ref = JaxPolynomialBatch.from_values(jgf.from_u64(vals), 3, 4, "blake3")
    port = DevicePolynomialBatch.from_values(convert.from_u64(vals, "cpu"), 3, 4)
    np.testing.assert_array_equal(port.cap, ref.cap)
    idxs = [3, 77, 127]
    np.testing.assert_array_equal(port.query_leaves(idxs), ref.query_leaves(idxs))
    assert port.prove_batch(idxs) == ref.prove_batch(idxs)
    z = np.array([123456789, g.P - 3], dtype=np.uint64)
    pows = gfe.powers(gfe.from_u64_pair(z, "cpu"), 16)
    want = [[int(v) for v in row] for row in _eval_at_ext_host(vals, z)]
    assert port.eval_at_ext(pows).tolist() == want


POSEIDON_WIDTHS = [1, 4, 5, 8, 9, 16, 17, 32, 94, 134]


@pytest.mark.parametrize("C", POSEIDON_WIDTHS)
def test_poseidon_leaf_digests_match_reference(C):
    rows = np.random.default_rng(C).integers(0, g.P, size=(9, C), dtype=np.uint64)
    rows[0], rows[1] = g.P - 1, 0
    cols = convert.from_u64(rows.T.copy(), "cpu")
    before = dict(kernels.LAUNCHES)
    digs = tmerkle.digests_to_u64(tmerkle.leaf_digests(cols, "poseidon"))
    if C > 4:
        np.testing.assert_array_equal(digs, by_name("poseidon").hash_leaves(rows))
    else:  # a short leaf is its own zero-padded digest
        np.testing.assert_array_equal(digs[:, :C], rows)
        assert not digs[:, C:].any()
    # the plain version is the sponge at every width, short leaves included
    np.testing.assert_array_equal(
        tmerkle.digests_to_u64(tpos.leaves_plain(cols)),
        by_name("poseidon").hash_leaves(rows))
    assert kernels.LAUNCHES == before


def test_poseidon_compress_level_matches_reference():
    digs = np.random.default_rng(2).integers(0, g.P, size=(8, 4), dtype=np.uint64)
    digs[0], digs[1] = g.P - 1, 0
    words = np.stack([digs & np.uint64(0xFFFFFFFF), digs >> np.uint64(32)],
                     axis=-1).reshape(8, 8).T.astype(np.int64)
    parent = tmerkle.compress_level(torch.from_numpy(words.copy()), "poseidon")
    assert torch.equal(tpos.level_plain(torch.from_numpy(words.copy())), parent)
    np.testing.assert_array_equal(tmerkle.digests_to_u64(parent),
                                  by_name("poseidon").compress(digs[0::2],
                                                               digs[1::2]))


def _check_batch_against_host(port, host, C, logn, hasher):
    np.testing.assert_array_equal(port.cap, host.cap)
    np.testing.assert_array_equal(convert.to_u64(port.coeffs), host.polynomials)
    size = 1 << (logn + 3)
    idxs = [0, 1, 5, size - 1]
    leaves = port.query_leaves(idxs)
    proofs = port.prove_batch(idxs)
    for i, x in enumerate(idxs):
        hleaf, hproof = host.leaf_and_proof(x)
        assert [int(v) for v in leaves[i]] == hleaf
        assert proofs[i] == hproof
        assert MerkleTree.verify(hleaf, x, port.cap, proofs[i], hasher=hasher)
    if logn == 1:  # degree 2: the leaves are the cap, the paths are empty
        assert all(p == [] for p in proofs)


POSEIDON_BATCHES = [(17, 5), (7, 6), (26, 1)]


@pytest.mark.parametrize("C,logn", POSEIDON_BATCHES)
def test_poseidon_commit_matches_host_batch(C, logn):
    vals = np.random.default_rng(C * 100 + logn).integers(
        0, g.P, size=(C, 1 << logn), dtype=np.uint64)
    hasher = by_name("poseidon")
    host = PolynomialBatch.from_values(vals, 3, 4, hasher)
    port = DevicePolynomialBatch.from_values(convert.from_u64(vals, "cpu"), 3, 4,
                                             "poseidon")
    _check_batch_against_host(port, host, C, logn, hasher)


def _poseidon_commit_matches_jax(C, logn):
    vals = np.random.default_rng(C * 100 + logn).integers(
        0, g.P, size=(C, 1 << logn), dtype=np.uint64)
    cap_height = 2 if logn > 1 else 4
    ref = JaxPolynomialBatch.from_values(jgf.from_u64(vals), 3, cap_height,
                                         "poseidon")
    port = DevicePolynomialBatch.from_values(convert.from_u64(vals, "cpu"), 3,
                                             cap_height, "poseidon")
    np.testing.assert_array_equal(port.cap, ref.cap)
    np.testing.assert_array_equal(convert.to_u64(port.coeffs),
                                  jgf.to_u64(ref.coeffs))
    idxs = [0, 17, (1 << (logn + 3)) - 1]
    np.testing.assert_array_equal(port.query_leaves(idxs), ref.query_leaves(idxs))
    assert port.prove_batch(idxs) == ref.prove_batch(idxs)


def test_poseidon_commit_matches_jax_batch():
    # the JAX package's Poseidon commit compiles its permutation on XLA:CPU
    # (about 30 s per shape here), so the default tier takes one shape, the
    # one tests/test_oracle_device.py holds the JAX batch to the host at
    _poseidon_commit_matches_jax(17, 5)


@pytest.mark.slow
@pytest.mark.parametrize("C,logn", [(7, 6), (26, 1)])
def test_poseidon_commit_matches_jax_batch_more_shapes(C, logn):
    _poseidon_commit_matches_jax(C, logn)


def test_poseidon_fri_extension_leaves_match_reference():
    from olavm_tpu_torch.stark.prover_device import _DeviceExtTree

    arity, n = 16, 256
    vals = np.random.default_rng(5).integers(0, g.P, size=(n, 2), dtype=np.uint64)
    tree = _DeviceExtTree(gfe.from_u64_pair(vals, "cpu"), arity, 2, "poseidon")
    perm = np.array([int(f"{i:08b}"[::-1], 2) for i in range(n)])
    rows = vals[perm].reshape(n // arity, 2 * arity)
    host = MerkleTree.build(rows, 2, hasher=by_name("poseidon"))
    np.testing.assert_array_equal(tmerkle.digests_to_u64(tree.levels[0]),
                                  by_name("poseidon").hash_leaves(rows))
    np.testing.assert_array_equal(tree.cap, np.asarray(host.cap, dtype=np.uint64))
    assert tree.paths([3]) == [host.prove(3)]


def test_keccak_has_no_device_path():
    vals = convert.from_u64(np.arange(64, dtype=np.uint64).reshape(4, 16), "cpu")
    with pytest.raises(NotImplementedError, match="host prover"):
        DevicePolynomialBatch.from_values(vals, 3, 2, "keccak")
    with pytest.raises(NotImplementedError, match="host prover"):
        tmerkle.compress_level(torch.zeros((8, 4), dtype=torch.int64), "keccak")
