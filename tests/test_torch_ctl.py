"""The port's grand products (olavm_tpu_torch.stark.ctl_device) on ToySystem
against the host prover's CTL and permutation Z columns
(stark/cross_table_lookup.py, stark/stark_base.py) and the JAX package's
device versions (stark/ctl_device.py), with the challengers in the same
state. Bit-exact throughout."""

import numpy as np
import pytest

from olavm_tpu.field import gf as jgf
from olavm_tpu.stark import ctl_device as jctl
from olavm_tpu.stark.challenger import Challenger
from olavm_tpu.stark.config import StarkConfig
from olavm_tpu.stark.cross_table_lookup import cross_table_lookup_data
from olavm_tpu.stark.stark_base import (
    compute_permutation_z_polys,
    get_n_grand_product_challenge_sets,
)
from olavm_tpu_torch import convert
from olavm_tpu_torch.stark import ctl_device as tctl
from olavm_tpu_torch.stark.challenger import Challenger as TorchChallenger

from test_stark_framework import ToySystem, build_traces
import torch_threads  # noqa: F401  (torch's share of the cores)


def _challengers(seed_values):
    host, port = Challenger(), TorchChallenger()
    host.observe_elements(seed_values)
    port.observe_elements(seed_values)
    return host, port


@pytest.fixture(scope="module")
def toy():
    return ToySystem(), StarkConfig.standard_fast_config(), build_traces(64)


def test_ctl_zs_match_host(toy):
    system, config, traces = toy
    host_ch, port_ch = _challengers([5, 6, 7])
    want = cross_table_lookup_data(config, traces, system.cross_table_lookups,
                                   host_ch)
    got = tctl.ctl_data_device(config, [convert.from_u64(t, "cpu")
                                        for t in traces],
                               system.cross_table_lookups, port_ch)
    assert len(got) == len(want)
    for w, p in zip(want, got):
        assert len(w.zs_columns) == len(p.zs_columns) > 0
        for wz, pz in zip(w.zs_columns, p.zs_columns):
            np.testing.assert_array_equal(convert.to_u64(pz.z), wz.z)
            assert (pz.challenge.beta, pz.challenge.gamma) == (
                wz.challenge.beta, wz.challenge.gamma)
    assert host_ch.get_challenge() == port_ch.get_challenge()


def test_ctl_zs_match_jax_device(toy):
    system, config, traces = toy
    jax_ch, port_ch = _challengers([9])
    want = jctl.ctl_data_device(config, [jgf.from_u64(t) for t in traces],
                                system.cross_table_lookups, jax_ch)
    got = tctl.ctl_data_device(config, [convert.from_u64(t, "cpu")
                                        for t in traces],
                               system.cross_table_lookups, port_ch)
    for w, p in zip(want, got):
        for wz, pz in zip(w.zs_columns, p.zs_columns):
            np.testing.assert_array_equal(convert.to_u64(pz.z),
                                          jgf.to_u64(wz.z))


def test_permutation_zs_match_host(toy):
    system, config, traces = toy
    stark = system.starks[0]
    host_ch, port_ch = _challengers([1, 2])
    sets = get_n_grand_product_challenge_sets(
        host_ch, config.num_challenges, stark.permutation_batch_size())
    port_sets = get_n_grand_product_challenge_sets(
        port_ch, config.num_challenges, stark.permutation_batch_size())
    assert [[(c.beta, c.gamma) for c in s] for s in sets] == [
        [(c.beta, c.gamma) for c in s] for s in port_sets]
    want = compute_permutation_z_polys(stark, config, traces[0], sets)
    got = tctl.permutation_z_polys_device(
        stark, config, convert.from_u64(traces[0], "cpu"), port_sets)
    assert len(got) == len(want) > 0
    for w, p in zip(want, got):
        np.testing.assert_array_equal(convert.to_u64(p), w)


def test_permutation_z_with_a_zero_denominator_matches_jax_device(toy):
    """A row whose permutation denominator is 0 (inverted to 0, as x^(p-2)
    gives): the port's permutation_z, with its inversion and exclusive
    scan, against olavm_tpu's device Z polys on the same trace."""
    system, config, traces = toy
    stark = system.starks[0]
    host_ch, port_ch = _challengers([2, 7])
    sets = get_n_grand_product_challenge_sets(
        host_ch, config.num_challenges, stark.permutation_batch_size())
    port_sets = get_n_grand_product_challenge_sets(
        port_ch, config.num_challenges, stark.permutation_batch_size())
    values, offset = tctl.permutation_bank(port_sets)
    meta = tctl.permutation_meta(stark, config, port_sets, offset)
    # row 5 of the first instance's right-hand side made 0:
    # gamma + sum_i t[b_i] beta^i = 0
    column_pairs, off = meta[0][0]
    beta, gamma = values[off], values[off + 1]
    trace = traces[0].copy()
    P = 0xFFFFFFFF00000001
    rest = sum(int(trace[b][5]) * pow(beta, i, P)
               for i, (_, b) in enumerate(column_pairs) if i)
    trace[column_pairs[0][1]][5] = (-gamma - rest) % P
    want = jctl.permutation_z_polys_device(stark, config,
                                           jgf.from_u64(trace), sets)
    bank = convert.from_u64(np.asarray(values, dtype=np.uint64), "cpu")
    got = [tctl.permutation_z(convert.from_u64(trace, "cpu"), bank, m)
           for m in meta]
    assert len(got) == len(want) > 0
    for p, w in zip(got, want):
        np.testing.assert_array_equal(convert.to_u64(p), jgf.to_u64(w))
    # the zero denominator is there: Z's quotient at row 5 is 0
    z = convert.to_u64(got[0])
    assert z[6] == 0 and z[5] != 0
