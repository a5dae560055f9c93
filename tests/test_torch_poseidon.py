"""The port's Poseidon (olavm_tpu_torch.hash.poseidon): the numpy host half
against olavm_tpu's, the reference vectors, and the torch permutation (K2's
plain version on CPU tensors) against permute_np; the PoW grind built on it
against the host prover's lowest-nonce grind. Bit-exact throughout."""

import numpy as np
import pytest

from olavm_tpu.field import goldilocks as g
from olavm_tpu.hash import poseidon as jpos
from olavm_tpu.stark.config import FriConfig
from olavm_tpu.stark.fri import fri_proof_of_work
from olavm_tpu_torch import convert
from olavm_tpu_torch.hash import poseidon as tpos
from olavm_tpu_torch.stark.prover_device import fri_pow_device

from test_reference_vectors import POSEIDON_VECTORS
import torch_threads  # noqa: F401  (torch's share of the cores)


@pytest.mark.parametrize("idx", range(len(POSEIDON_VECTORS)))
def test_reference_vectors(idx):
    inp, expected = POSEIDON_VECTORS[idx]
    host = tpos.permute_np(np.array([inp], dtype=np.uint64))[0]
    assert [int(v) for v in host] == expected
    state = convert.from_u64(np.array(inp, dtype=np.uint64).reshape(12, 1), "cpu")
    out = convert.to_u64(tpos.permute(state))[:, 0]
    assert [int(v) for v in out] == expected


def test_torch_permutation_matches_permute_np():
    rng = np.random.default_rng(2)
    states = rng.integers(0, g.P, size=(17, 12), dtype=np.uint64)
    states[0] = 0
    states[1] = g.P - 1
    want = jpos.permute_np(states.copy())
    got = convert.to_u64(tpos.permute_plain(convert.from_u64(states.T.copy(),
                                                             "cpu"))).T
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tpos.permute(convert.from_u64(states, "cpu"))


def test_host_half_matches_reference_package():
    rng = np.random.default_rng(3)
    states = rng.integers(0, g.P, size=(5, 12), dtype=np.uint64)
    np.testing.assert_array_equal(tpos.permute_np(states), jpos.permute_np(states))
    out, trace = tpos.permute_np(states[0], with_trace=True)
    ref_out, ref_trace = jpos.permute_np(states[0], with_trace=True)
    np.testing.assert_array_equal(out, ref_out)
    assert trace.keys() == ref_trace.keys()
    for k in trace:
        np.testing.assert_array_equal(trace[k], ref_trace[k])
    data = [int(v) for v in rng.integers(0, g.P, size=19, dtype=np.uint64)]
    assert tpos.hash_no_pad(data) == jpos.hash_no_pad(data)
    assert tpos.hash_n_to_m_no_pad(data, 11) == jpos.hash_n_to_m_no_pad(data, 11)
    assert tpos.two_to_one(data[:4], data[4:8]) == jpos.two_to_one(data[:4],
                                                                   data[4:8])
    h, rows = tpos.arbitrary_poseidon_np(data, with_rows=True)
    ref_h, ref_rows = jpos.arbitrary_poseidon_np(data, with_rows=True)
    assert h == ref_h and len(rows) == len(ref_rows)
    for row, ref_row in zip(rows, ref_rows):
        for k in ref_row:
            np.testing.assert_array_equal(row[k], ref_row[k])


def test_native_binding_matches_reference_vectors():
    native = tpos._native()
    assert native is not None and native.available
    for inp, expected in POSEIDON_VECTORS:
        out = native.permute_batch(np.array([inp], dtype=np.uint64))[0]
        assert [int(v) for v in out] == expected


@pytest.mark.parametrize("bits", [6, 9])
def test_pow_grind_returns_lowest_nonce(bits):
    h = [int(v) for v in np.random.default_rng(bits).integers(
        0, g.P, size=4, dtype=np.uint64)]
    cfg = FriConfig(proof_of_work_bits=bits)
    assert fri_pow_device(h, cfg, "cpu") == fri_proof_of_work(h, cfg)
