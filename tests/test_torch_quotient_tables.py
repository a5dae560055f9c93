"""Each OlaStark table's device quotient against olavm_tpu's, on the CPU.

For each of the 12 tables, at degree 2^4 (and most at 2^5, see CASES):
random trace and Z polynomial coefficients, compress challenges,
permutation and CTL challenges and alphas, all drawn from a numpy seed, go
through

- the port's `quotient_class` (olavm_tpu_torch/stark/prover_device.py), once
  per residue class of the quotient coset, on the challenge bank that
  `quotient_bank` builds, and
- olavm_tpu's host `compute_quotient_polys` (olavm_tpu/stark/prover.py) on
  the same coefficients' LDEs, its quotient values taken where they leave
  for the interpolation, so before the divisibility check (a random trace
  breaks the constraints, and both paths raise on that after the values).

The two must be equal element for element (tolerance 0: field arithmetic).
The whole proofs compare the same code only on traces that satisfy the
constraints, and take minutes each; this checks every table's constraints,
permutation and CTL terms on values that reach every branch, in seconds.
"""

import numpy as np
import pytest
import torch

from olavm_tpu.field import goldilocks as jg
from olavm_tpu.stark import prover as jprover
from olavm_tpu.stark.config import StarkConfig as JConfig
from olavm_tpu.stark.cross_table_lookup import CtlData as JCtlData
from olavm_tpu.stark.cross_table_lookup import CtlZData as JCtlZData
from olavm_tpu.stark.oracle import PolynomialBatch
from olavm_tpu.stark.stark_base import GrandProductChallenge as JChallenge
from olavm_tpu.tables.ola_stark import OlaStark as JOlaStark
from olavm_tpu_torch import convert
from olavm_tpu_torch.field import gf
from olavm_tpu_torch.stark import prover_device as tpd
from olavm_tpu_torch.stark.config import StarkConfig
from olavm_tpu_torch.stark.cross_table_lookup import CtlData, CtlZData
from olavm_tpu_torch.stark.stark_base import GrandProductChallenge
from olavm_tpu_torch.tables.ola_stark import OlaStark
import torch_threads  # noqa: F401  (torch's share of the cores)

TABLES = ["CpuStark", "MemoryStark", "BitwiseStark", "CmpStark",
          "RangeCheckStark", "PoseidonStark", "PoseidonChunkStark",
          "StorageAccessStark", "TapeStark", "SCCallStark", "ProgramStark",
          "ProgChunkStark"]


class _QuotientValues:
    """Stands in for olavm_tpu.stark.prover's `ntt` module: keeps each
    quotient value array that compute_quotient_polys interpolates and
    returns zero coefficients, so its divisibility check passes."""

    def __init__(self):
        self.values = []

    def coset_ifft(self, values):
        self.values.append(np.asarray(values, dtype=np.uint64))
        return np.zeros_like(self.values[-1])


def _draw(table: int, degree_bits: int):
    """The table's random inputs, the same for both packages: compress
    challenges, trace and Z coefficients, challenges and alphas."""
    rng = np.random.default_rng(1000 * degree_bits + table)

    def field(*shape):
        return rng.integers(0, jg.P, size=shape, dtype=np.uint64)

    def pairs(k):
        return [tuple(int(v) for v in field(2)) for _ in range(k)]

    config = StarkConfig.standard_fast_config()
    nc = config.num_challenges
    ola = OlaStark()
    stark = ola.starks[table]
    compress = [int(v) for v in field(len(ola.starks))]
    ctl_challenges = pairs(nc)
    # the CTL Z views of this table, in cross_table_lookup_data's order
    views = []
    for ci, ctl in enumerate(ola.cross_table_lookups):
        for k in range(nc):
            for ti, t in enumerate(list(ctl.looking_tables) + [ctl.looked_table]):
                if t.table == table:
                    views.append((ci, k, ti))
    perm_sets = None
    num_perm_zs = 0
    if stark.uses_permutation_args():
        perm_sets = [pairs(nc) for _ in range(stark.permutation_batch_size())]
        num_perm_zs = stark.num_permutation_batches(config)
    degree = 1 << degree_bits
    return {"compress": compress, "ctl_challenges": ctl_challenges,
            "views": views, "perm_sets": perm_sets,
            "num_perm_zs": num_perm_zs,
            "trace": field(stark.COLUMNS, degree),
            "zs": field(num_perm_zs + len(views), degree),
            "alphas": [int(v) for v in field(nc)]}


def _ctl_data(ola, views, challenges, data_cls, zdata_cls, challenge_cls):
    data = data_cls()
    for ci, k, ti in views:
        ctl = ola.cross_table_lookups[ci]
        t = (list(ctl.looking_tables) + [ctl.looked_table])[ti]
        data.zs_columns.append(zdata_cls(None, challenge_cls(*challenges[k]),
                                         t.columns, t.filter_column))
    return data


def _reference(table, degree_bits, d, monkeypatch):
    """olavm_tpu's quotient values, (num_alphas, n << qdb) in coset order."""
    config = JConfig.standard_fast_config()
    ola = JOlaStark()
    ola.set_compress_challenges(d["compress"])
    stark = ola.starks[table]
    rate, cap = config.fri_config.rate_bits, config.fri_config.cap_height
    trace = PolynomialBatch.from_coeffs(d["trace"], rate, cap, config.hasher())
    zs = PolynomialBatch.from_coeffs(d["zs"], rate, cap, config.hasher())
    perm = None
    if d["perm_sets"] is not None:
        perm = [[JChallenge(*c) for c in s] for s in d["perm_sets"]]
    ctl_data = _ctl_data(ola, d["views"], d["ctl_challenges"], JCtlData,
                         JCtlZData, JChallenge)
    capture = _QuotientValues()
    monkeypatch.setattr(jprover, "ntt", capture)
    jprover.compute_quotient_polys(stark, config, trace, zs, perm, ctl_data,
                                   d["alphas"], degree_bits, d["num_perm_zs"])
    return np.stack(capture.values)


def _port(table, degree_bits, d):
    """The port's quotient classes, interleaved into the same order."""
    config = StarkConfig.standard_fast_config()
    ola = OlaStark()
    ola.set_compress_challenges(d["compress"])
    stark = ola.starks[table]
    perm = None
    if d["perm_sets"] is not None:
        perm = [[GrandProductChallenge(*c) for c in s] for s in d["perm_sets"]]
    ctl_data = _ctl_data(ola, d["views"], d["ctl_challenges"], CtlData,
                         CtlZData, GrandProductChallenge)
    values, perm_meta, ctl_offsets = tpd.quotient_bank(
        stark, config, d["alphas"], perm, ctl_data)
    bank = gf.from_u64(values, "cpu")
    ctl_views = [(zc.columns, zc.filter_column) for zc in ctl_data.zs_columns]
    trace = convert.from_u64(d["trace"], "cpu")
    zs = convert.from_u64(d["zs"], "cpu")
    qdb = tpd.quotient_degree_bits(stark, config)
    classes = [
        tpd.quotient_class(
            stark, trace, zs, tpd.class_constants(degree_bits, qdb, r, "cpu"),
            bank, num_alphas=len(d["alphas"]), perm_meta=perm_meta,
            ctl_views=ctl_views, ctl_offsets=ctl_offsets,
            num_permutation_zs=d["num_perm_zs"])
        for r in range(1 << qdb)]
    interleaved = torch.stack(classes).permute(1, 2, 0)
    return convert.to_u64(interleaved.reshape(len(d["alphas"]), -1))


# every table at degree 2^4, and at 2^5 all but the two whose CPU path
# takes seconds per class (CpuStark and PoseidonStark: thousands of torch
# ops each, whatever the degree)
CASES = [(t, 4) for t in range(len(TABLES))] + [
    (t, 5) for t in range(len(TABLES))
    if TABLES[t] not in ("CpuStark", "PoseidonStark")]


@pytest.mark.parametrize("table,degree_bits", CASES,
                         ids=[f"{TABLES[t]}-{b}" for t, b in CASES])
def test_quotient_classes_match_olavm_tpu(table, degree_bits, monkeypatch):
    assert type(OlaStark().starks[table]).__name__ == TABLES[table]
    d = _draw(table, degree_bits)
    want = _reference(table, degree_bits, d, monkeypatch)
    got = _port(table, degree_bits, d)
    assert want.shape == got.shape == (
        2, (1 << degree_bits) << tpd.quotient_degree_bits(
            OlaStark().starks[table], StarkConfig.standard_fast_config()))
    # random traces break the constraints: the values are not all zero
    assert want.any()
    np.testing.assert_array_equal(got, want)
