"""The port's program layer (olavm_tpu_torch/utils/jitcache.py) and the
device prover's bank-driven programs, on the CPU, where a program is its
function called directly:

- key discipline: one program per key, a graph per input signature, clear()
  drops them, the launch counters that replays feed, and the buffer rule:
  a later prove that outgrows a buffer frees the earlier proves' graphs
  that read it;
- no challenge is baked into a program: each program kind that a ToySystem
  prove makes (quotient class, CTL Z, permutation Z, FRI fold, FRI
  composition, the openings' power table) issues the same torch ops, with
  the same host values, under two challenge banks made from a numpy seed,
  and no challenge of either bank is among those values. This is the CPU
  proxy for a capture: a host value inside a program is what a CUDA graph
  would bake into a fill or a kernel argument;
- parity with olavm_tpu at a small size, tolerance 0 (exact field values):
  the bank-driven quotient against olavm_tpu's host compute_quotient_polys
  on the same transcript, the permutation Z polys against olavm_tpu's
  device ones, the FRI fold against olavm_tpu's host fold.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from olavm_tpu.field import extension as jge
from olavm_tpu.field import gf as jgf
from olavm_tpu.field import goldilocks as g
from olavm_tpu.stark import ctl_device as jctl
from olavm_tpu.stark.challenger import Challenger as JChallenger
from olavm_tpu.stark.config import StarkConfig as JConfig
from olavm_tpu.stark.cross_table_lookup import cross_table_lookup_data
from olavm_tpu.stark.oracle import PolynomialBatch
from olavm_tpu.stark.prover import compute_quotient_polys
from olavm_tpu.stark.stark_base import (
    compute_permutation_z_polys,
    get_n_grand_product_challenge_sets as jsets,
)
from olavm_tpu_torch import convert, kernels
from olavm_tpu_torch.field import gf, gfe
from olavm_tpu_torch.stark import ctl_device as tctl
from olavm_tpu_torch.stark import prover_device as tpd
from olavm_tpu_torch.stark.challenger import Challenger
from olavm_tpu_torch.stark.config import FriConfig, StarkConfig
from olavm_tpu_torch.stark.oracle_device import DevicePolynomialBatch
from olavm_tpu_torch.stark.stark_base import (
    GrandProductChallenge,
    get_n_grand_product_challenge_sets,
)
from olavm_tpu_torch.utils import jitcache

from test_stark_framework import ToySystem, build_traces
import torch_threads  # noqa: F401  (torch's share of the cores)

# ---------------------------------------------------------------------------
# key discipline and launch counts
# ---------------------------------------------------------------------------


def test_one_program_per_key_and_clear_drops_them():
    jitcache.clear()
    a = jitcache.cached_jit(("t", 1), lambda x: x + 1)
    assert jitcache.cached_jit(("t", 1), lambda x: x - 1) is a
    b = jitcache.cached_jit(("t", 2), lambda x: x - 1)
    assert b is not a
    x = torch.arange(4)
    # the key's first function is the program's
    assert torch.equal(jitcache.cached_jit(("t", 1), None)(x), x + 1)
    jitcache.clear()
    assert jitcache.stats() == {}
    assert jitcache.cached_jit(("t", 1), lambda x: x * 2) is not a


def test_cpu_program_is_its_function_called_directly():
    jitcache.clear()
    calls = []

    def fn(x, bank):
        calls.append(bank.clone())
        return gf.mul(x, bank[0]), gf.add(x, bank[1])

    prog = jitcache.cached_jit(("direct",), fn)
    x = convert.from_u64(np.arange(8, dtype=np.uint64), "cpu")
    for bank in ([3, 5], [7, 11]):
        b = convert.from_u64(np.asarray(bank, dtype=np.uint64), "cpu")
        got = prog(x, b)
        want = fn(x, b)
        assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert len(calls) == 4
    # no graph on the CPU: nothing captured, nothing replayed
    assert jitcache.stats()["('direct',)"]["captures"] == 0
    assert prog.graphs == {}
    jitcache.clear()


class _Unrun:
    """Stands in for a captured CUDA graph: records its reset."""

    def __init__(self):
        self.was_reset = False

    def reset(self):
        self.was_reset = True

    def replay(self):
        pass


def _graph(key, *inputs):
    """A graph of the program of `key` over these inputs, as a capture
    would record it: its input views in the shared buffers."""
    prog = jitcache.cached_jit(key, None)
    slots = [jitcache._view("in", i, t) for i, t in enumerate(inputs)]
    graph = prog.graphs[tuple(t.shape for t in inputs)] = jitcache._Graph(
        _Unrun(), slots, [], {}, 0, 0.0, 0)
    return graph


def test_a_later_prove_that_outgrows_a_buffer_frees_earlier_graphs():
    """The buffer rule (jitcache.begin_prove): a buffer outgrown within a
    prove stays for the graphs that read it; one outgrown by a later prove
    is freed, with every graph that reads that buffer position and that
    the later prove has not used, and the other graphs stay."""
    jitcache.clear()
    words = lambda n: torch.zeros(n, dtype=torch.int64)  # noqa: E731
    jitcache.begin_prove()
    a = _graph(("a",), words(8))
    b = _graph(("b",), words(16), words(4))  # grows input 0 in the prove
    f = _graph(("f",), torch.zeros(64, dtype=torch.float32))
    r = _graph(("r",), words(4))
    assert not a.graph.was_reset  # it keeps its outgrown buffer
    assert jitcache.buffer_bytes() == (8 + 16 + 4) * 8 + 64 * 4
    jitcache.begin_prove()
    r.replay([words(4)])  # used by this prove too: it stays
    c = _graph(("c",), words(8))  # fits the buffer: nothing dropped
    assert not (a.graph.was_reset or b.graph.was_reset)
    d = _graph(("d",), words(2), words(32))  # outgrows input 1
    assert b.graph.was_reset and not a.graph.was_reset
    e = _graph(("e",), words(64))  # outgrows input 0
    assert a.graph.was_reset
    kept = {k: s for k, s in jitcache.stats().items() if s["dropped"] == 0}
    assert sorted(kept) == ["('c',)", "('d',)", "('e',)", "('f',)",
                            "('r',)"]
    assert [jitcache._PROGRAMS[(k,)].graphs for k in "ab"] == [{}, {}]
    assert not any(g.graph.was_reset for g in (c, d, e, f, r))
    # the outgrown buffers that no graph of this prove reads are held no
    # more (r and c read the 16-word buffer of input 0)
    assert jitcache.buffer_bytes() == (16 + 32 + 64) * 8 + 64 * 4
    jitcache.clear()


def test_enabled_is_scoped():
    assert jitcache._ENABLED.get()
    with pytest.raises(ValueError):
        with jitcache.enabled(False):
            assert not jitcache._ENABLED.get()
            raise ValueError
    assert jitcache._ENABLED.get()


def test_launch_counts_split_host_issued_from_replayed():
    kernels.reset_launches()
    kernels.count("gf_mul")
    with kernels.recording() as captured:
        kernels.count("gf_mul")
        kernels.count("ntt")
    # a capture runs nothing: its launches are the program's, per replay
    assert captured["gf_mul"] == 1 and captured["ntt"] == 1
    assert kernels.LAUNCHES["gf_mul"] == kernels.HOST_LAUNCHES["gf_mul"] == 1
    for _ in range(3):
        kernels.add_replayed(captured)
    assert kernels.LAUNCHES["gf_mul"] == 4 and kernels.LAUNCHES["ntt"] == 3
    assert kernels.HOST_LAUNCHES["gf_mul"] == 1
    assert kernels.HOST_LAUNCHES["ntt"] == 0
    kernels.reset_launches()
    assert not any(kernels.LAUNCHES.values())
    assert not any(kernels.HOST_LAUNCHES.values())


# ---------------------------------------------------------------------------
# no challenge baked into a program
# ---------------------------------------------------------------------------


class OpRecorder(TorchDispatchMode):
    """Every torch op a function issues: its name and, per argument, the
    shape and dtype of a tensor that the function was given or made, the
    values of any other tensor (made from host data, outside the ops), or
    the host value itself. `values` collects every host value and every
    value of such a tensor."""

    def __init__(self, inputs):
        super().__init__()
        self.made = {id(t) for t in inputs}
        self.keep = list(inputs)  # ids stay unique while the record lives
        self.ops = []
        self.values = []

    def _arg(self, a):
        if isinstance(a, torch.Tensor):
            if id(a) in self.made:
                return ("tensor", tuple(a.shape), str(a.dtype))
            vals = a.detach().reshape(-1).tolist()
            self.values.extend(vals)
            return ("host tensor", tuple(a.shape), tuple(vals))
        if isinstance(a, (list, tuple)):
            return tuple(self._arg(x) for x in a)
        if isinstance(a, dict):
            return tuple((k, self._arg(v)) for k, v in sorted(a.items()))
        if isinstance(a, (bool, int, float)):
            self.values.append(a)
            return ("value", a)
        return repr(a)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rec = (str(func), self._arg(args), self._arg(kwargs))
        out = func(*args, **kwargs)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.made.add(id(t))
                self.keep.append(t)
        self.ops.append(rec)
        return out


def record(fn, inputs):
    rec = OpRecorder(inputs)
    with rec:
        fn(*inputs)
    return rec


def _bank(like: torch.Tensor, seed: int) -> torch.Tensor:
    vals = np.random.default_rng(seed).integers(0, g.P, size=like.shape,
                                                dtype=np.uint64)
    return convert.from_u64(vals, like.device)


def _forms(t: torch.Tensor) -> set:
    """A bank's values as a recorded host value could hold them: the
    canonical value and its int64 bit pattern."""
    u = convert.to_u64(t).reshape(-1).tolist()
    return {int(v) for v in u} | {int(v) - (1 << 64) for v in u
                                   if v >= 1 << 63}


@pytest.fixture(scope="module")
def toy_programs():
    """(key, fn, inputs) of the first call of each program kind in a
    ToySystem prove on the CPU (the prover's own keys and functions)."""
    seen = {}
    real = jitcache.cached_jit

    def spy(key, fn):
        prog = real(key, fn)

        def call(*inputs):
            seen.setdefault(key[0], (key, prog.fn, inputs))
            return prog(*inputs)

        return call

    jitcache.clear()
    jitcache.cached_jit = spy
    try:
        config = StarkConfig(fri_config=FriConfig(proof_of_work_bits=8))
        tpd.prove_with_traces_device(ToySystem(), config, build_traces(64),
                                     device="cpu")
    finally:
        jitcache.cached_jit = real
        jitcache.clear()
    return seen


# every program kind whose inputs end with a challenge bank
BANKED = ("qclass", "ctlz", "permz", "frifold", "fricomp", "extpows")


@pytest.mark.parametrize("tag", BANKED)
def test_no_challenge_is_baked_into_a_program(toy_programs, tag):
    key, fn, inputs = toy_programs[tag]
    *data, bank = inputs
    banks = [_bank(bank, seed) for seed in (1, 2)]
    recs = [record(fn, (*data, b)) for b in banks]
    assert len(recs[0].ops) > 10
    # the same ops, the same shapes and the same host values under both
    assert recs[0].ops == recs[1].ops
    for rec in recs:
        values = {v for v in rec.values if isinstance(v, int)}
        for b in banks:
            assert not values & _forms(b), (tag, values & _forms(b))


def test_recorder_sees_a_challenge_that_a_host_combine_bakes():
    # GrandProductChallenge.combine_ops, which the programs route around,
    # passes beta to TorchOps.scalar_mul as a host int: a fill of beta
    terms = [convert.from_u64(np.arange(4, dtype=np.uint64) + i, "cpu")
             for i in range(3)]
    rng = np.random.default_rng(3)
    chals = [GrandProductChallenge(*(int(v) for v in rng.integers(
                 1 << 40, g.P, size=2, dtype=np.uint64))) for _ in range(2)]
    F = tpd.TorchOps("cpu")
    recs = [record(lambda *t, c=c: c.combine_ops(F, list(t)), terms)
            for c in chals]
    assert recs[0].ops != recs[1].ops
    beta = convert.from_u64(np.asarray([chals[0].beta], dtype=np.uint64), "cpu")
    assert {v for v in recs[0].values if isinstance(v, int)} & _forms(beta)


# ---------------------------------------------------------------------------
# parity with olavm_tpu
# ---------------------------------------------------------------------------


def _observe(challenger, seed):
    challenger.observe_elements(
        [int(v) for v in np.random.default_rng(seed).integers(0, g.P, 4,
                                                              dtype=np.uint64)])


@pytest.mark.parametrize("table,seed", [(0, 5), (0, 6), (1, 5)])
def test_quotient_matches_olavm_tpu(table, seed):
    """ToySystem's table (FibStark: permutation argument and a CTL;
    CopyStark: a CTL) at degree 64, the transcript seeded from numpy: the
    Z polys, alphas and quotient chunks of the port's device path equal
    olavm_tpu's host prover's."""
    system = ToySystem()
    traces = build_traces(64)
    stark = system.starks[table]
    degree_bits = 6

    jcfg = JConfig.standard_fast_config()
    jch = JChallenger()
    _observe(jch, seed)
    jctl_data = cross_table_lookup_data(jcfg, traces,
                                        system.cross_table_lookups, jch)
    jperm = jzs = None
    if stark.uses_permutation_args():
        jperm = jsets(jch, jcfg.num_challenges, stark.permutation_batch_size())
        jzs = compute_permutation_z_polys(stark, jcfg, traces[table], jperm)
    rate, cap = jcfg.fri_config.rate_bits, jcfg.fri_config.cap_height
    jtrace = PolynomialBatch.from_values(traces[table], rate, cap,
                                         jcfg.hasher())
    jz = PolynomialBatch.from_values(
        np.stack(list(jzs or []) + jctl_data[table].z_polys()), rate, cap,
        jcfg.hasher())
    jch.observe_cap(jz.cap, jcfg.hasher())
    jalphas = jch.get_n_challenges(jcfg.num_challenges)
    want = compute_quotient_polys(stark, jcfg, jtrace, jz, jperm,
                                  jctl_data[table], jalphas, degree_bits,
                                  len(jzs or []))

    cfg = StarkConfig.standard_fast_config()
    ch = Challenger()
    _observe(ch, seed)
    values = [convert.from_u64(t, "cpu") for t in traces]
    ctl_data = tctl.ctl_data_device(cfg, values, system.cross_table_lookups,
                                    ch)
    perm, zs = None, []
    if stark.uses_permutation_args():
        perm = get_n_grand_product_challenge_sets(
            ch, cfg.num_challenges, stark.permutation_batch_size())
        zs = tctl.permutation_z_polys_device(stark, cfg, values[table], perm)
    trace_batch = DevicePolynomialBatch.from_values(values[table], rate, cap)
    zs_batch = DevicePolynomialBatch.from_values(
        torch.stack(zs + [zc.z for zc in ctl_data[table].zs_columns]), rate,
        cap)
    ch.observe_cap(zs_batch.cap, cfg.hasher())
    alphas = ch.get_n_challenges(cfg.num_challenges)
    assert alphas == jalphas
    got = tpd.compute_quotient_polys_device(
        stark, cfg, trace_batch, zs_batch, perm, ctl_data[table], alphas,
        degree_bits, len(zs))
    np.testing.assert_array_equal(convert.to_u64(got), want)


@pytest.mark.parametrize("seed", [7, 8])
def test_permutation_zs_match_olavm_tpu_device(seed):
    system = ToySystem()
    traces = build_traces(64)
    stark = system.starks[0]
    cfg, jcfg = StarkConfig.standard_fast_config(), JConfig.standard_fast_config()
    ch, jch = Challenger(), JChallenger()
    _observe(ch, seed)
    _observe(jch, seed)
    sets = get_n_grand_product_challenge_sets(
        ch, cfg.num_challenges, stark.permutation_batch_size())
    jsets_ = jsets(jch, jcfg.num_challenges, stark.permutation_batch_size())
    jitcache.clear()
    got = tctl.permutation_z_polys_device(
        stark, cfg, convert.from_u64(traces[0], "cpu"), sets)
    # all of the table's batches in one program
    assert [st["tag"] for st in jitcache.stats().values()] == ["permz"]
    jitcache.clear()
    want = jctl.permutation_z_polys_device(
        stark, jcfg, jgf.from_u64(traces[0]), jsets_)
    assert len(got) == len(want) > 0
    for p, w in zip(got, want):
        np.testing.assert_array_equal(convert.to_u64(p), jgf.to_u64(w))


@pytest.mark.parametrize("arity,seed", [(16, 1), (16, 2), (8, 3), (2, 4)])
def test_fri_fold_matches_olavm_tpu(arity, seed):
    """The bank-driven fold against olavm_tpu's host fold
    (olavm_tpu/stark/fri.py fri_proof: Horner in beta over each chunk)."""
    rng = np.random.default_rng(seed)
    m = 1 << 10
    coeffs = rng.integers(0, g.P, size=(m, 2), dtype=np.uint64)
    beta = rng.integers(0, g.P, size=2, dtype=np.uint64)
    chunks = coeffs.reshape(-1, arity, 2)
    acc = np.zeros((chunks.shape[0], 2), dtype=np.uint64)
    for i in range(arity - 1, -1, -1):
        acc = jge.add(jge.mul(acc, np.broadcast_to(beta, acc.shape)),
                      chunks[:, i])
    got = tpd.fri_fold(gfe.from_u64_pair(coeffs, "cpu"), beta, arity)
    np.testing.assert_array_equal(gfe.to_u64_pair(got), acc)


def test_quotient_key_holds_the_compress_challenge():
    """Baked values: ProgramStark's eval_packed turns the trace generator's
    compress challenge into host-int products, so the quotient program's
    key holds it, and a program captured for one challenge is never
    replayed for another."""
    from olavm_tpu_torch.tables.program import ProgramStark

    a, b = ProgramStark(), ProgramStark()
    a.compress_challenge, b.compress_challenge = 5, 7
    assert tpd._stark_key(a) != tpd._stark_key(b)
    b.compress_challenge = 5
    assert tpd._stark_key(a) == tpd._stark_key(b)
