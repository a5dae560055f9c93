"""The port's grand products (olavm_tpu_torch.stark.ctl_device) on ToySystem
against the host prover's CTL and permutation Z columns
(stark/cross_table_lookup.py, stark/stark_base.py) and the JAX package's
device versions (stark/ctl_device.py), with the challengers in the same
state. Bit-exact throughout. A table's CTL Zs go through one program a
group (ctl_groups): the Zs equal olavm_tpu's also where a table's Zs span
several groups, and each table's permutation batches go through one
program."""

import numpy as np
import pytest

from olavm_tpu.field import gf as jgf
from olavm_tpu.stark import ctl_device as jctl
from olavm_tpu.stark.challenger import Challenger
from olavm_tpu.stark.config import StarkConfig
from olavm_tpu.stark.cross_table_lookup import (
    Column,
    CrossTableLookup,
    TableWithColumns,
    cross_table_lookup_data,
)
from olavm_tpu.stark.stark_base import (
    compute_permutation_z_polys,
    get_n_grand_product_challenge_sets,
)
from olavm_tpu_torch import convert
from olavm_tpu_torch.stark import ctl_device as tctl
from olavm_tpu_torch.stark import ctl_kernels as ck
from olavm_tpu_torch.utils import jitcache
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
    gives): the port's permutation_zs, with its inversion and exclusive
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
    got = tctl.permutation_zs(convert.from_u64(trace, "cpu"), bank, meta)
    assert len(got) == len(want) > 0
    for p, w in zip(got, want):
        np.testing.assert_array_equal(convert.to_u64(p), jgf.to_u64(w))
    # the zero denominator is there: Z's quotient at row 5 is 0
    z = convert.to_u64(got[0])
    assert z[6] == 0 and z[5] != 0


def _wide_lookups():
    """Four lookups between ToySystem's tables (table 0's column 0 equals
    table 1's, row by row), with several columns, constants and one
    filter: 8 Zs on each table at two challenges."""
    a, b = TableWithColumns, Column
    lc = b.linear_combination_with_constant
    pairs = [([b.single(0)], None),
             ([b.single(0), b.single(0)], None),
             ([lc([(0, 3)], 5), b.single(0), lc([(0, 1), (0, 1)], 0)], None),
             ([b.single(0)], b.one())]
    return [CrossTableLookup(looking_tables=[a(0, cols, f)],
                             looked_table=a(1, cols, f))
            for cols, f in pairs]


@pytest.mark.parametrize("group_words", [tctl.CTL_GROUP_WORDS, 64 * 3, 64])
def test_ctl_groups_match_jax_device(toy, monkeypatch, group_words):
    """At the default budget each table's 8 Zs are one program; at 3 or 1
    Zs a group they span several programs: the Zs equal olavm_tpu's
    ctl_data_device's either way."""
    _, config, traces = toy
    lookups = _wide_lookups()
    monkeypatch.setattr(tctl, "CTL_GROUP_WORDS", group_words)
    jax_ch, port_ch = _challengers([4, 4])
    want = jctl.ctl_data_device(config, [jgf.from_u64(t) for t in traces],
                                lookups, jax_ch)
    jitcache.clear()
    got = tctl.ctl_data_device(config, [convert.from_u64(t, "cpu")
                                        for t in traces], lookups, port_ch)
    keys = [k for k in jitcache.stats() if "ctlz" in k]
    jitcache.clear()
    per_group = min(8, group_words // 64)
    assert len(keys) == 2 * -(-8 // per_group)
    for w, p in zip(want, got):
        assert len(w.zs_columns) == len(p.zs_columns) == 8
        for wz, pz in zip(w.zs_columns, p.zs_columns):
            np.testing.assert_array_equal(convert.to_u64(pz.z),
                                          jgf.to_u64(wz.z))
    assert jax_ch.get_challenge() == port_ch.get_challenge()


@pytest.mark.parametrize("members,n,budget", [
    (78, 1 << 20, 1 << 25), (78, 1 << 22, 1 << 25), (28, 2, 1 << 25),
    (1, 1 << 30, 1 << 25), (7, 10, 30)])
def test_ctl_groups_are_even_and_within_the_budget(monkeypatch, members, n,
                                                    budget):
    monkeypatch.setattr(tctl, "CTL_GROUP_WORDS", budget)
    groups = tctl.ctl_groups(list(range(members)), n)
    assert [i for grp in groups for i in grp] == list(range(members))
    sizes = [len(grp) for grp in groups]
    assert max(sizes) - min(sizes) <= 1
    most = max(1, budget // n)
    assert max(sizes) <= most and len(groups) == -(-members // most)


def test_ctl_combine_into_a_row_equals_plain(toy):
    """ctl_combine(..., out=row) writes the plain version's values into one
    row of a table's array and leaves the others."""
    _, _, traces = toy
    trace = convert.from_u64(traces[0], "cpu")
    bank = convert.from_u64(np.asarray([3, 11, 7, 19], dtype=np.uint64),
                            "cpu")
    zs = convert.from_u64(np.full((3, trace.shape[1]), 5, dtype=np.uint64),
                          "cpu")
    lookup = _wide_lookups()[2].looking_tables[0]
    got = ck.ctl_combine(trace, lookup.columns, lookup.filter_column,
                         bank[2:4], out=zs[1])
    assert got.data_ptr() == zs[1].data_ptr()
    assert (convert.to_u64(zs[[0, 2]]) == 5).all()
    assert convert.to_u64(zs[1]).tolist() == convert.to_u64(
        ck.ctl_combine_plain(trace, lookup.columns, lookup.filter_column,
                             bank[2:4])).tolist()
    with pytest.raises(ValueError, match="out"):
        ck.ctl_combine(trace, lookup.columns, None, bank[:2], out=zs[:, :3])


class _OneAPair(type(ToySystem().starks[0])):
    """FibStark with one permutation instance a batch: two batches at two
    challenges."""

    def permutation_batch_size(self):
        return 1


def test_permutation_batches_are_one_program_a_table(toy):
    _, config, traces = toy
    stark = _OneAPair()
    jax_ch, port_ch = _challengers([6])
    sets = get_n_grand_product_challenge_sets(
        jax_ch, config.num_challenges, stark.permutation_batch_size())
    port_sets = get_n_grand_product_challenge_sets(
        port_ch, config.num_challenges, stark.permutation_batch_size())
    want = jctl.permutation_z_polys_device(stark, config,
                                           jgf.from_u64(traces[0]), sets)
    jitcache.clear()
    got = tctl.permutation_z_polys_device(
        stark, config, convert.from_u64(traces[0], "cpu"), port_sets)
    keys = [k for k in jitcache.stats() if "permz" in k]
    jitcache.clear()
    assert len(keys) == 1 and len(got) == len(want) == 2
    for p, w in zip(got, want):
        np.testing.assert_array_equal(convert.to_u64(p), jgf.to_u64(w))


def _count_calls(monkeypatch):
    """Counts of the kernel wrappers (and gf.ones, a fill) that the
    grand-product programs call, not counting calls made inside them."""
    from olavm_tpu_torch.field import gf

    counts, depth = {}, [0]

    def spy(module, name, as_name):
        real = getattr(module, name)

        def call(*args, **kwargs):
            if not depth[0]:
                counts[as_name] = counts.get(as_name, 0) + 1
            depth[0] += 1
            try:
                return real(*args, **kwargs)
            finally:
                depth[0] -= 1

        monkeypatch.setattr(module, name, call)

    for name in ("mul", "add", "inv", "prefix_prod"):
        spy(gf, name, {"mul": "gf_mul", "add": "gf_add",
                       "inv": "gf_inv"}.get(name, name))
    spy(gf, "ones", "fill")
    spy(ck, "ctl_combine", "ctl_combine")
    return counts


def test_program_kernels_count_the_programs_launches(toy, monkeypatch):
    """chip_smoke.program_kernels, which the card's run holds each ctlz and
    permz graph to, counts the launches, fills and copies those programs
    make: K8's scratch fill a prefix_prod, gf.ones a fill."""
    import chip_smoke

    _, config, traces = toy
    trace = convert.from_u64(traces[0], "cpu")
    lookups = _wide_lookups()
    views = tuple((t.columns, t.filter_column, c) for lk in lookups
                  for c in (0, 1) for t in lk.looking_tables)
    bank = convert.from_u64(np.arange(1, 5, dtype=np.uint64), "cpu")
    counts = _count_calls(monkeypatch)
    tctl.ctl_table_zs(trace, bank, views)
    key = tctl._ctl_program(trace, views).key
    want, fills = chip_smoke.program_kernels("ctlz", repr(key))
    assert counts == {**want, **({"fill": fills - 1} if fills > 1 else {})}
    assert fills == counts["prefix_prod"]

    stark = _OneAPair()
    _, port_ch = _challengers([8])
    sets = get_n_grand_product_challenge_sets(
        port_ch, config.num_challenges, stark.permutation_batch_size())
    values, offset = tctl.permutation_bank(sets)
    meta = tctl.permutation_meta(stark, config, sets, offset)
    counts.clear()
    tctl.permutation_zs(trace, convert.from_u64(
        np.asarray(values, dtype=np.uint64), "cpu"), meta)
    key = ("permz", "m", "q", tuple(trace.shape), meta)
    want, fills = chip_smoke.program_kernels("permz", repr(key))
    assert {k: v for k, v in counts.items() if k != "fill"} == want
    # the fills, K8's scratch fill and each chain's copy into its row
    assert counts["fill"] + counts["prefix_prod"] + 2 * len(meta) == fills
