"""The hand-written kernels (olavm_tpu_torch/csrc) on the card: each against
its plain PyTorch version on the same CUDA tensors, bit-exact (the streamed
absorb kernels also against the one-shot leaf kernels, and the streamed
commit against the same commit on the CPU), and the ToySystem proof through
the kernels equal to olavm_tpu's host proof.

K13 (power tables) in both fields, on a row of bases and on one, and in the
extpows program; the coset transforms through gl_scale_powers against the
CPU path; K10 on one to four batches from 2 to 2^23 points.
K7 (inversion) and K8 (the grand-product scan) are also checked on all
zeros, a zero in every chunk, lengths around a tile and inside a CUDA
graph replayed on other inputs; K11 (a CTL Z's row combination) on every
view and on the widest at 2^20 rows, K12 (the FRI fold) at 2^24 and on
slices; goldilocks.cuh's lazy helpers and 160-bit sums that take terms off
against their g++ build (ROADMAP Queue 3, item 1).

These tests need an NVIDIA GPU and nvcc; elsewhere they skip. On the card:
    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from olavm_tpu.field import goldilocks as g
from olavm_tpu.hash import poseidon as jpos
from olavm_tpu_torch import convert, kernels
from olavm_tpu_torch.field import gf
from olavm_tpu_torch.hash import poseidon as tpos
from olavm_tpu_torch.merkle import device as tmerkle
from olavm_tpu_torch.ntt import ntt as tntt
import torch_threads  # noqa: F401  (torch's share of the cores)

pytestmark = pytest.mark.cuda

EDGE = np.array([0, 1, g.P - 1, 2**32 - 1, 2**32], dtype=np.uint64)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, g.P, size=shape,
                                                dtype=np.uint64)


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_elementwise_kernels_match_plain(dev, op):
    a = np.concatenate([np.repeat(EDGE, 5), _rand(4096, 1)])
    b = np.concatenate([np.tile(EDGE, 5), _rand(4096, 2)])
    ta, tb = convert.from_u64(a, dev), convert.from_u64(b, dev)
    fn, plain = getattr(gf, op), getattr(gf, f"{op}_plain")
    before = kernels.LAUNCHES[f"gf_{op}"]
    assert torch.equal(fn(ta, tb), plain(ta, tb))
    assert kernels.LAUNCHES[f"gf_{op}"] == before + 1
    for v in EDGE:
        s = gf.scalar(int(v), dev)
        assert torch.equal(fn(ta, s), plain(ta, s))
        assert torch.equal(fn(s, tb), plain(s, tb))
    want = {"mul": g.mul_arr, "add": g.add_arr, "sub": g.sub_arr}[op](a, b)
    np.testing.assert_array_equal(convert.to_u64(fn(ta, tb)), want)


def test_elementwise_kernel_rejects_other_dtypes(dev):
    x = torch.ones(8, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        gf.mul(x, x)


@pytest.mark.parametrize("n", [2, 4, 1024, 1 << 14])
def test_ntt_kernel_matches_plain(dev, n):
    x = convert.from_u64(_rand((3, n), n), dev)
    for inverse in (False, True):
        assert torch.equal(tntt._ntt_cuda(x, inverse), tntt.ntt_plain(x, inverse))
    back = tntt.intt(tntt.ntt(x))
    assert torch.equal(back, x)


@pytest.mark.parametrize("logn", range(1, 25))
def test_ntt_kernel_matches_plain_at_every_size(dev, logn):
    # every split of the stages into passes: one launch up to 2^13, two up to
    # 2^20, three beyond; odd batches leave a block's last columns empty
    passes = kernels.lib("ntt").gl_ntt_passes(logn)
    assert passes == (1 if logn <= 13 else 2 if logn <= 20 else 3)
    batch = 3 if logn <= 20 else 1
    x = convert.from_u64(_rand((batch, 1 << logn), logn), dev)
    before = kernels.LAUNCHES["ntt"]
    for inverse in (False, True):
        assert torch.equal(tntt._ntt_cuda(x, inverse), tntt.ntt_plain(x, inverse))
    assert kernels.LAUNCHES["ntt"] == before + 2


def test_ntt_kernel_refuses_what_it_does_not_take(dev):
    x = convert.from_u64(_rand((2, 64), 1), dev)
    with pytest.raises(TypeError):
        tntt._ntt_cuda(x.to(torch.int32), False)
    tw = tntt.twiddles(6, False, dev)
    out = torch.empty_like(x)
    lib = kernels.lib("ntt")
    # aliased input and output, and a size beyond three passes
    assert lib.gl_ntt(x.data_ptr(), x.data_ptr(), tw.data_ptr(), 2, 6,
                      kernels.stream_ptr(x)) != 0
    assert lib.gl_ntt(x.data_ptr(), out.data_ptr(), tw.data_ptr(), 2, 31,
                      kernels.stream_ptr(x)) != 0
    with pytest.raises(RuntimeError):
        kernels.check(1, "ntt")


@pytest.mark.parametrize("C", [1, 4, 5, 8, 9, 18, 29, 32, 94, 128, 129, 134, 256])
def test_blake3_leaves_kernel_matches_plain(dev, C):
    cols = convert.from_u64(_rand((C, 1000), C), dev)
    before = kernels.LAUNCHES["blake3_leaves"]
    got = tmerkle.leaf_digests(cols)
    # leaves of at most 4 elements are their own digests: no launch
    assert kernels.LAUNCHES["blake3_leaves"] == before + (1 if C > 4 else 0)
    want = tmerkle.leaf_digests(cols.cpu())
    assert torch.equal(got.cpu(), want)
    if C > 4:
        assert torch.equal(got, tmerkle.leaf_digests_plain(cols))


@pytest.mark.parametrize("n", [2, 6, 1 << 12])
def test_blake3_level_kernel_matches_plain(dev, n):
    digs = torch.from_numpy(np.random.default_rng(n).integers(
        0, 1 << 32, size=(8, n), dtype=np.int64)).to(dev)
    before = kernels.LAUNCHES["blake3_level"]
    got = tmerkle.compress_level(digs)
    assert kernels.LAUNCHES["blake3_level"] == before + 1
    assert torch.equal(got, tmerkle.compress_level_plain(digs))


def test_blake3_kernels_refuse_what_they_do_not_take(dev):
    cols = convert.from_u64(_rand((9, 64), 1), dev)
    with pytest.raises(TypeError):
        tmerkle.leaf_digests(cols.to(torch.int32))
    with pytest.raises(ValueError):
        tmerkle.leaf_digests(cols.T)  # (64, 9) view, not contiguous
    with pytest.raises(ValueError):
        tmerkle.leaf_digests(torch.zeros((257, 2), dtype=torch.int64, device=dev))
    digs = torch.zeros((8, 64), dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        tmerkle.compress_level(digs.to(torch.int32))
    with pytest.raises(ValueError):
        tmerkle.compress_level(digs[:, ::2])  # not contiguous
    with pytest.raises(ValueError):
        tmerkle.compress_level(digs[:, :63].contiguous())  # odd width


def test_poseidon_kernel_matches_plain_and_numpy(dev):
    states = np.concatenate([tpos.edge_states(), _rand((300, 12), 5)])
    out = tpos.permute(convert.from_u64(states.T.copy(), dev))
    assert torch.equal(out, tpos.permute_plain(convert.from_u64(states.T.copy(),
                                                                dev)))
    np.testing.assert_array_equal(convert.to_u64(out).T,
                                  jpos.permute_np(states))


@pytest.mark.parametrize("table", [1, 2])
def test_poseidon_init_refuses_other_mds_tables(dev, table):
    tpos.permute(convert.from_u64(_rand((12, 4), 1), dev))  # initialised
    tables = tpos._kernel_tables()
    tables[table][3] += 1
    lib = kernels.lib("poseidon")
    assert lib.gl_poseidon_init(*[t.ctypes.data for t in tables]) == -1
    # nothing was copied: the kernel still permutes with its own tables
    states = _rand((64, 12), 6)
    out = tpos.permute(convert.from_u64(states.T.copy(), dev))
    np.testing.assert_array_equal(convert.to_u64(out).T, jpos.permute_np(states))


@pytest.mark.parametrize("C", [1, 4, 5, 8, 9, 16, 17, 32, 94, 134])
@pytest.mark.parametrize("n", [1000, 129])
def test_poseidon_leaves_kernel_matches_plain(dev, C, n):
    rows = _rand((n, C), C)
    rows[0], rows[1] = g.P - 1, 0
    cols = convert.from_u64(rows.T.copy(), dev)
    before = kernels.LAUNCHES["poseidon_leaves"]
    got = tpos.leaves(cols)
    assert kernels.LAUNCHES["poseidon_leaves"] == before + 1
    assert torch.equal(got, tpos.leaves_plain(cols))
    assert torch.equal(got.cpu(), tpos.leaves(cols.cpu()))
    # through the Merkle code: leaves of at most 4 elements are their own
    # digests, with no launch
    digs = tmerkle.leaf_digests(cols, "poseidon")
    assert kernels.LAUNCHES["poseidon_leaves"] == before + 1 + (C > 4)
    assert torch.equal(digs.cpu(), tmerkle.leaf_digests(cols.cpu(), "poseidon"))


@pytest.mark.parametrize("n", [2, 6, 1 << 12, 2 * 1001, 2 * 32769])
def test_poseidon_level_kernel_matches_plain(dev, n):
    digs = tpos.leaves(convert.from_u64(_rand((4, n), n), dev))
    before = kernels.LAUNCHES["poseidon_level"]
    got = tmerkle.compress_level(digs, "poseidon")
    assert kernels.LAUNCHES["poseidon_level"] == before + 1
    assert torch.equal(got, tpos.level_plain(digs))
    assert torch.equal(got.cpu(), tpos.level(digs.cpu()))


def _big_path_n(dev) -> int:
    """An odd item count that takes the Merkle kernels' 640-thread path
    (csrc/poseidon.cu: one block per SM from 320 items per SM), one more
    round of the grid for 77 threads: not a multiple of any block."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * 640 + 77


@pytest.mark.parametrize("C", [1, 5, 8, 9, 17, 94, 134])
def test_poseidon_leaves_kernel_big_path_matches_plain(dev, C):
    n = _big_path_n(dev)
    cols = torch.randint(0, 1 << 62, (C, n), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(C))
    cols[:, 0] = int(np.uint64(g.P - 1).view(np.int64))  # p - 1 as stored
    cols[:, 1] = 0
    got = tpos.leaves(cols)
    # the plain version in pieces (its temporaries grow with C * n)
    for part in range(0, n, 1 << 16):
        sl = slice(part, min(part + (1 << 16), n))
        assert torch.equal(got[:, sl], tpos.leaves_plain(cols[:, sl].contiguous()))


def test_poseidon_level_kernel_big_path_matches_plain(dev):
    parents = _big_path_n(dev)
    digs = torch.randint(0, 1 << 32, (8, 2 * parents), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(7))
    got = tpos.level(digs)
    for part in range(0, parents, 1 << 16):
        sl = slice(part, min(part + (1 << 16), parents))
        want = tpos.level_plain(digs[:, 2 * sl.start:2 * sl.stop].contiguous())
        assert torch.equal(got[:, sl], want)


def test_poseidon_merkle_kernels_refuse_what_they_do_not_take(dev):
    cols = convert.from_u64(_rand((9, 64), 1), dev)
    with pytest.raises(TypeError):
        tpos.leaves(cols.to(torch.int32))
    with pytest.raises(ValueError):
        tpos.leaves(cols.T)  # (64, 9) view, not contiguous
    digs = torch.zeros((8, 64), dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        tpos.level(digs.to(torch.int32))
    with pytest.raises(ValueError):
        tpos.level(digs[:, ::2])  # not contiguous
    with pytest.raises(ValueError):
        tpos.level(digs[:, :63].contiguous())  # odd width
    with pytest.raises(NotImplementedError, match="host prover"):
        tmerkle.leaf_digests(cols, "keccak")


def test_toy_proof_through_kernels_equals_host(dev):
    from olavm_tpu.stark import config as jconfig
    from olavm_tpu.stark.prover import prove_with_traces
    from olavm_tpu.stark.serialization import serialize_all_proof
    from olavm_tpu_torch.stark import config as tconfig
    from olavm_tpu_torch.stark.prover_device import prove_with_traces_device
    from olavm_tpu_torch.stark.serialization import serialize_all_proof as tser

    from test_stark_framework import ToySystem, build_traces

    traces = build_traces(64)
    host = prove_with_traces(ToySystem(), jconfig.StarkConfig(), traces)
    kernels.reset_launches()
    port = prove_with_traces_device(ToySystem(), tconfig.StarkConfig(), traces,
                                    device=dev)
    assert tser(port) == serialize_all_proof(host)
    # ToySystem's commits have at most 4 columns (leaves that are their own
    # digests), so the streamed absorb runs only in the wider tests below;
    # K7's extension entry left the prove with K10, which inverts its norms,
    # and the sub kernel with K13 (its last launches were the extension
    # products of the openings' power tables)
    blake3 = {k: v for k, v in kernels.LAUNCHES.items()
              if not k.startswith("poseidon_")
              and k not in ("blake3_absorb", "gf_ext_inv", "gf_sub")}
    assert all(v > 0 for v in blake3.values()), kernels.LAUNCHES
    assert kernels.LAUNCHES["gf_ext_inv"] == kernels.LAUNCHES["gf_sub"] == 0


def test_toy_poseidon_proof_through_kernels_equals_host(dev):
    from olavm_tpu.stark import config as jconfig
    from olavm_tpu.stark.prover import prove_with_traces
    from olavm_tpu.stark.serialization import serialize_all_proof
    from olavm_tpu_torch.stark import config as tconfig
    from olavm_tpu_torch.stark.prover_device import prove_with_traces_device
    from olavm_tpu_torch.stark.serialization import serialize_all_proof as tser

    from test_stark_framework import ToySystem, build_traces

    traces = build_traces(64)
    host = prove_with_traces(
        ToySystem(), jconfig.StarkConfig(merkle_hasher="poseidon"), traces)
    kernels.reset_launches()
    port = prove_with_traces_device(
        ToySystem(), tconfig.StarkConfig(merkle_hasher="poseidon"), traces,
        device=dev)
    assert tser(port) == serialize_all_proof(host)
    assert kernels.LAUNCHES["poseidon_leaves"] > 0
    assert kernels.LAUNCHES["poseidon_level"] > 0
    assert kernels.LAUNCHES["blake3_leaves"] == kernels.LAUNCHES["blake3_level"] == 0


def _stream(cols, hasher, block=16):
    stream = tmerkle.LeafStream(cols.shape[0], cols.shape[1], hasher)
    for start in range(0, cols.shape[0], block):
        stream.absorb(cols[start:start + block].contiguous())
    return stream.finalize()


@pytest.mark.parametrize("C", [5, 8, 9, 16, 17, 29, 94, 128, 129, 134, 256])
def test_blake3_absorb_kernel_matches_plain(dev, C):
    cols = convert.from_u64(_rand((C, 1000), C), dev)
    before = kernels.LAUNCHES["blake3_absorb"]
    got = _stream(cols, "blake3")
    assert kernels.LAUNCHES["blake3_absorb"] == before + (C + 15) // 16
    assert torch.equal(got, _stream(cols.cpu(), "blake3").to(dev))
    assert torch.equal(got, tmerkle.leaf_digests(cols))
    assert torch.equal(_stream(cols, "blake3", 8), got)


@pytest.mark.parametrize("C", [5, 8, 9, 16, 17, 94, 134])
@pytest.mark.parametrize("big", [False, True])
def test_poseidon_absorb_kernel_matches_plain(dev, C, big):
    n = _big_path_n(dev) if big else 1000
    cols = torch.randint(0, 1 << 62, (C, n), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(C))
    cols[:, 0] = int(np.uint64(g.P - 1).view(np.int64))
    before = kernels.LAUNCHES["poseidon_absorb"]
    got = _stream(cols, "poseidon")
    assert kernels.LAUNCHES["poseidon_absorb"] == before + (C + 15) // 16
    assert torch.equal(got, tpos.leaves(cols))
    part = cols[:, :4096].contiguous()
    assert torch.equal(got[:, :4096], _stream(part.cpu(), "poseidon").to(dev))
    # one block's states against the plain sponge's
    state = tpos.absorb(cols[:8].contiguous(), None, False)
    assert torch.equal(state[:, :4096],
                       tpos.absorb_plain(part[:8], None, False))


# K5's shapes in an N=94000 prove (2^20 CPU rows): per table (C, n) the
# trace, Z and quotient batches at the 28 FRI query points, the trace and Z
# batches at the openings' 4 extension rows, the quotient batch at 2
K5_TABLES = (
    (1 << 20, (94, 78, 12)), (1 << 18, (29, 8, 14)), (1 << 18, (59, 10, 4)),
    (1 << 17, (6, 4, 4)), (1 << 19, (12, 12, 4)), (1024, (134, 6, 12)),
    (2, (53, 28, 4)), (256, (48, 12, 6)), (2, (6, 2, 8)), (2, (26, 4, 2)),
    (1 << 21, (18, 6, 4)), (4, (40, 20, 6)))
K5_MAIN = sorted({(C, n, k) for n, widths in K5_TABLES
                  for C, ks in zip(widths, ((28, 4), (28, 4), (28, 2)))
                  for k in ks})


@pytest.mark.parametrize("C,n,k", [(1, 1, 1), (3, 17, 5), (94, 4096, 28),
                                   (5, 1 << 14, 4), (2, 300, 40),
                                   (134, 1024, 28), *K5_MAIN])
def test_eval_points_kernel_matches_plain(dev, C, n, k):
    coeffs = convert.from_u64(_rand((C, n), n), dev)
    points = [int(v) for v in _rand(k, k)]
    points[0] = g.P - 1
    pows = gf.power_rows(points, n, dev)
    before = kernels.LAUNCHES["eval_points"]
    got = gf.eval_points(coeffs, pows)
    assert kernels.LAUNCHES["eval_points"] == before + 1
    assert torch.equal(got, gf.eval_points_plain(coeffs, pows))


@pytest.mark.parametrize("C", sorted({1, gf.EVAL_RC - 1, gf.EVAL_RC,
                                      gf.EVAL_RC + 1, 134}))
def test_eval_points_kernel_at_plan_edges(dev, C):
    # every k at every edge of the sub-tile and of the chunks the plan gives
    # this card at the main path's largest shape
    chunk = gf.eval_plan_on(dev, 94, 1 << 20, 28).chunk_len
    for k in (1, 2, 3, 4, 5, 28, 32, 33, 40):
        for n in (1, 2, 17, gf.EVAL_TERMS - 1, gf.EVAL_TERMS + 1, chunk - 1,
                  chunk + 1):
            coeffs = convert.from_u64(_rand((C, n), C * n + k), dev)
            pows = convert.from_u64(_rand((k, n), k * n + C), dev)
            coeffs[:, 0] = pows[:, 0] = int(np.uint64(g.P - 1).view(np.int64))
            assert torch.equal(gf.eval_points(coeffs, pows),
                               gf.eval_points_plain(coeffs, pows)), (k, n)


def test_eval_points_kernel_refuses_what_it_does_not_take(dev):
    x = torch.ones((2, 8), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        gf.eval_points(x, x)
    with pytest.raises(ValueError):
        gf.eval_points(torch.ones((2, 8), dtype=torch.int64, device=dev),
                       torch.ones((2, 4), dtype=torch.int64, device=dev))


@pytest.mark.parametrize("hasher,C", [("blake3", 17), ("blake3", 134),
                                      ("poseidon", 17), ("poseidon", 3)])
def test_streamed_commit_on_card_equals_cpu(dev, hasher, C):
    from olavm_tpu_torch.field import gfe
    from olavm_tpu_torch.stark.oracle_device import DevicePolynomialBatch

    vals = _rand((C, 1 << 10), C)
    batches = [DevicePolynomialBatch.from_values(convert.from_u64(vals, d), 3,
                                                 4, hasher)
               for d in (dev, torch.device("cpu"))]
    on_card, on_cpu = batches
    np.testing.assert_array_equal(on_card.cap, on_cpu.cap)
    idx = [0, 3, 4095, 8191]
    np.testing.assert_array_equal(on_card.query_leaves(idx),
                                  on_cpu.query_leaves(idx))
    assert on_card.prove_batch(idx) == on_cpu.prove_batch(idx)
    z = [(5, 7), (g.P - 1, 3)]
    pows = [gfe.powers(gfe.from_u64_pair(np.asarray(p, dtype=np.uint64), d),
                       1 << 10) for d in (dev, "cpu") for p in z]
    rows = [torch.stack([pows[2 * i].re, pows[2 * i].im,
                         pows[2 * i + 1].re, pows[2 * i + 1].im])
            for i in range(2)]
    for a, b in zip(on_card.eval_at_ext_rows(rows[0]),
                    on_cpu.eval_at_ext_rows(rows[1])):
        np.testing.assert_array_equal(a, b)


def _toy_programs(dev):
    """(key, program, first inputs) of each program kind in a ToySystem
    prove on the card, which captures them."""
    from olavm_tpu_torch.stark import config as tconfig
    from olavm_tpu_torch.stark.prover_device import prove_with_traces_device
    from olavm_tpu_torch.utils import jitcache

    from test_stark_framework import ToySystem, build_traces

    seen = {}
    real = jitcache.cached_jit

    def spy(key, fn):
        prog = real(key, fn)

        def call(*inputs):
            seen.setdefault(key[0], (key, prog, inputs))
            return prog(*inputs)

        return call

    jitcache.clear()
    jitcache.cached_jit = spy
    try:
        prove_with_traces_device(ToySystem(), tconfig.StarkConfig(),
                                 build_traces(64), device=dev)
    finally:
        jitcache.cached_jit = real
    return seen


def test_program_replay_with_a_second_bank_equals_the_eager_run(dev):
    """Each program kind, captured by a prove, replayed with a second
    challenge bank: the same values as its function run eagerly with that
    bank, and the same kernel launches, none of them issued by the host."""
    from olavm_tpu_torch.utils import jitcache

    programs = _toy_programs(dev)
    assert {"qclass", "ctlz", "permz", "frifold", "fricomp",
            "extpows"} <= set(programs)
    for tag, (key, prog, inputs) in programs.items():
        *data, bank = inputs
        bank2 = convert.from_u64(_rand(tuple(bank.shape), 99), dev)
        replays = jitcache.stats()[repr(key)]["replays"]
        kernels.reset_launches()
        got = prog(*data, bank2)
        replayed = dict(kernels.LAUNCHES)
        assert jitcache.stats()[repr(key)]["replays"] == replays + 1, tag
        assert not any(kernels.HOST_LAUNCHES.values()), tag
        kernels.reset_launches()
        with jitcache.enabled(False):
            want = prog(*data, bank2)
        assert dict(kernels.LAUNCHES) == replayed, tag
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), tag
    jitcache.clear()


def test_toy_proof_with_programs_equals_eager_and_host(dev):
    from olavm_tpu.stark import config as jconfig
    from olavm_tpu.stark.prover import prove_with_traces
    from olavm_tpu.stark.serialization import serialize_all_proof
    from olavm_tpu_torch.stark import config as tconfig
    from olavm_tpu_torch.stark.prover_device import prove_with_traces_device
    from olavm_tpu_torch.stark.serialization import serialize_all_proof as tser
    from olavm_tpu_torch.utils import jitcache

    from test_stark_framework import ToySystem, build_traces

    traces = build_traces(64)
    want = serialize_all_proof(
        prove_with_traces(ToySystem(), jconfig.StarkConfig(), traces))
    jitcache.clear()
    for programs in (True, True, False):
        proof = prove_with_traces_device(ToySystem(), tconfig.StarkConfig(),
                                         traces, device=dev,
                                         programs=programs)
        assert tser(proof) == want
    stats = jitcache.stats().values()
    assert sum(s["captures"] for s in stats) > 0
    assert sum(s["replays"] for s in stats) > 0
    jitcache.clear()


def test_programs_follow_a_stark_constant_that_changes(dev):
    """A table whose constraints scale a column by a constant of the STARK
    object (as ProgramStark and BitwiseStark use the trace generator's
    compress challenge): proves with two values of it, in one process with
    the programs, both verify, each with its own quotient program."""
    from olavm_tpu_torch.stark.config import FriConfig, StarkConfig
    from olavm_tpu_torch.stark.cross_table_lookup import (
        Column, CrossTableLookup, TableWithColumns)
    from olavm_tpu_torch.stark.prover_device import prove_with_traces_device
    from olavm_tpu_torch.stark.stark_base import Stark
    from olavm_tpu_torch.stark.verifier import verify_proof
    from olavm_tpu_torch.utils import jitcache

    class Scaled(Stark):
        COLUMNS = 2

        def __init__(self, k):
            self.k = k

        def eval_packed(self, local, nxt, consumer):
            F = consumer.F
            consumer.constraint(F.sub(F.scalar_mul(local[0], self.k),
                                      local[1]))

    class Copy(Stark):
        COLUMNS = 1

        def eval_packed(self, local, nxt, consumer):
            pass

    class System:
        def __init__(self, k):
            self.starks = [Scaled(k), Copy()]
            self.cross_table_lookups = [CrossTableLookup(
                looking_tables=[TableWithColumns(0, [Column.single(0)], None)],
                looked_table=TableWithColumns(1, [Column.single(0)], None))]

        def compress_challenges(self):
            return [0, 0]

    a = _rand(64, 5)
    config = StarkConfig(fri_config=FriConfig(proof_of_work_bits=8))
    jitcache.clear()
    for k in (3, 5, 3):
        scaled = np.stack([a, g.mul_arr(a, np.uint64(k))])
        proof = prove_with_traces_device(System(k), config,
                                         [scaled, a.reshape(1, -1)],
                                         device=dev)
        verify_proof(System(k), proof, config)
    qkeys = [s for s in jitcache.stats().values() if s["tag"] == "qclass"]
    assert len(qkeys) == 3  # one per (table, constant); k = 3 replayed
    jitcache.clear()


def test_a_later_prove_that_outgrows_the_buffers_frees_earlier_graphs(dev):
    """The buffer rule on the card (jitcache.begin_prove): a program
    captured by one prove, then captured at a larger shape by a later prove,
    drops the earlier graph with its buffers; both shapes still give the
    eager values, the smaller one captured again on the larger buffers."""
    from olavm_tpu_torch.utils import jitcache

    jitcache.clear()
    prog = jitcache.cached_jit(("rule",), lambda x, y: gf.mul(gf.add(x, y), y))
    small = [convert.from_u64(_rand(1 << 10, s), dev) for s in (1, 2)]
    large = [convert.from_u64(_rand(1 << 20, s), dev) for s in (3, 4)]
    want = {n: gf.mul(gf.add(x, y), y) for n, (x, y) in
            (("small", small), ("large", large))}
    jitcache.begin_prove()
    for _ in range(2):  # the capture, then a replay
        assert torch.equal(prog(*small), want["small"])
    held = jitcache.buffer_bytes()
    assert held == 3 * 8 << 10  # two inputs and the output
    jitcache.begin_prove()
    for _ in range(2):
        assert torch.equal(prog(*large), want["large"])
    st = jitcache.stats()[repr(("rule",))]
    assert (st["captures"], st["dropped"], st["replays"]) == (2, 1, 2)
    assert jitcache.buffer_bytes() == 3 * 8 << 20
    jitcache.begin_prove()
    for _ in range(2):
        assert torch.equal(prog(*small), want["small"])
    st = jitcache.stats()[repr(("rule",))]
    assert (st["captures"], st["dropped"], st["replays"]) == (3, 1, 3)
    assert jitcache.buffer_bytes() == 3 * 8 << 20
    jitcache.clear()


def _quotient_case(table, degree, dev):
    import chip_smoke

    from olavm_tpu_torch.stark import prover_device as tpd

    case = chip_smoke.quotient_case(table, degree,
                                    np.random.default_rng(table), dev)
    qdb = tpd.quotient_degree_bits(case["stark"], case["config"])
    return case, qdb


@pytest.mark.parametrize("table", range(12))
def test_k6_matches_quotient_class_ops(dev, table):
    """K6, every class of each table at 2^8 rows and one at 2^13: the
    slices' launches, and values equal to the op-by-op quotient's."""
    from olavm_tpu_torch.stark import prover_device as tpd

    for degree in (1 << 8, 1 << 13):
        case, qdb = _quotient_case(table, degree, dev)
        args = (case["stark"], case["coeffs"], case["zs_coeffs"])
        k6 = tpd.quotient_kernels(*args[:1], args[1].shape[0],
                                  args[2].shape[0], **case["static"])
        # K1's twiddle table, made once per size with K3 products, is not
        # the class's work: make it before counting
        tntt.twiddles(degree.bit_length() - 1, False, dev)
        for r in range(1 << qdb) if degree == 1 << 8 else (1,):
            cls = tpd.class_constants(degree.bit_length() - 1, qdb, r, dev)
            kernels.reset_launches()
            got = tpd.quotient_class(*args, cls, case["bank"], **case["static"])
            # the constant table, then each slice
            assert kernels.LAUNCHES["constraints"] == len(k6.plan.slices) + 1
            assert (kernels.LAUNCHES["scale_powers"],
                    kernels.LAUNCHES["quotient_selectors"]) == (2, 1)
            assert not any(kernels.LAUNCHES[k]
                           for k in ("gf_mul", "gf_add", "gf_sub"))
            want = tpd.quotient_class_ops(*args, cls, case["bank"],
                                          **case["static"])
            assert torch.equal(got, want), (degree, r)


@pytest.mark.parametrize("C,n", [(1, 1), (3, 2), (53, 2), (7, 1000),
                                 (94, 1 << 14), (2, 1 << 21)])
def test_quotient_fixed_kernels_match_plain(dev, C, n):
    from olavm_tpu_torch.stark import constraint_codegen as cg

    x = convert.from_u64(_rand((C, n), C), dev)
    base = convert.from_u64(_rand(1, n), dev)
    assert torch.equal(cg.scale_powers(x, base),
                       cg.scale_powers_plain(x, base))
    if n & (n - 1) == 0 and n <= 1 << 14:
        bits = n.bit_length() - 1
        cls = convert.from_u64(_rand(4, bits), dev)
        assert torch.equal(cg.selectors(cls, bits),
                           cg.selectors_plain(cls, bits))


def test_k6_on_a_row_block_equals_plain(dev):
    """The sharded quotient_eval_fn's form of K6: explicit next rows
    (nshift 0) and a Z_H^{-1} column, on the card against the plain
    version."""
    from olavm_tpu_torch.stark import constraint_codegen as cg
    from olavm_tpu_torch.stark import constraint_tape as ct
    from olavm_tpu_torch.tables.cpu import CpuStark

    stark = CpuStark()
    tape = ct.record(lambda consumer, F, lv, nv, zl, zn, bank:
                     stark.eval_packed(lv, nv, consumer), stark.COLUMNS, 0, 2)
    k6 = cg.Kernels("CpuStark", tape)
    m = 3000
    cols = [convert.from_u64(_rand((stark.COLUMNS, m), s), dev) for s in (1, 2)]
    none = gf.zeros((0, m), dev)
    inp = ct.Inputs(cols[0], cols[1], none, none, 0,
                    convert.from_u64(_rand((3, m), 3), dev),
                    convert.from_u64(_rand(2, 4), dev),
                    gf.from_u64(tape.pool, dev),
                    convert.from_u64(_rand(m, 5), dev))
    want = ct.evaluate_plain(k6.plan, inp)
    assert torch.equal(cg.evaluate(k6, inp), want)


def _inv_inputs(n: int, chunk: int, seed: int) -> dict:
    """K7's inputs: random points with the edge values, all zeros, and a
    zero in every chunk of a thread (the first of each)."""
    rnd = np.concatenate([EDGE, _rand(n, seed)])[-n:]
    every = rnd.copy()
    every[:-(-n // chunk)] = 0
    return {"random": rnd, "zeros": np.zeros(n, dtype=np.uint64),
            "zero in every chunk": every}


@pytest.mark.parametrize("n", [1, 7, 16, 17, 1000, 1 << 14, (1 << 21) + 3])
def test_inv_kernel_matches_plain(dev, n):
    from olavm_tpu_torch.field import gfe

    for name, a in _inv_inputs(n, 16, n).items():
        x = convert.from_u64(a, dev)
        before = kernels.LAUNCHES["gf_inv"]
        got = gf.inv(x)
        assert kernels.LAUNCHES["gf_inv"] == before + 1
        assert torch.equal(got, gf.inv_plain(x)), name
    for name, a in _inv_inputs(n, 8, n + 1).items():
        b = _rand(n, n + 2)
        b[a == 0] = 0
        x = gfe.GFE(convert.from_u64(a, dev), convert.from_u64(b, dev))
        before = kernels.LAUNCHES["gf_ext_inv"]
        got = gfe.inv(x)
        assert kernels.LAUNCHES["gf_ext_inv"] == before + 1
        want = gfe.inv_plain(x)
        assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im), name
    if n == 1000:
        np.testing.assert_array_equal(
            convert.to_u64(gf.inv(convert.from_u64(a, dev))),
            np.array([pow(int(v), g.P - 2, g.P) for v in a], dtype=np.uint64))


@pytest.mark.parametrize("rows,n", [(1, 1), (1, 2), (1, 3), (1, 2047),
                                    (1, 2048), (1, 2049), (1, 1 << 12),
                                    (3, 5000), (1, 40 * 2048 + 5),
                                    (1, (1 << 21) + 1), (2, 1 << 20)])
def test_prefix_prod_kernel_matches_plain(dev, rows, n):
    x = convert.from_u64(_rand((rows, n), n), dev)
    x[:, n // 2] = 0 if rows > 1 else 1
    for exclusive in (False, True):
        before = kernels.LAUNCHES["prefix_prod"]
        got = gf.prefix_prod(x, exclusive=exclusive)
        assert kernels.LAUNCHES["prefix_prod"] == before + 1
        assert torch.equal(got, gf.prefix_prod_plain(x, exclusive=exclusive))
    # the same bytes on every launch, whatever order the tiles ran in
    want = gf.prefix_prod_plain(x)
    for _ in range(3):
        assert torch.equal(gf.prefix_prod(x), want)


@pytest.mark.parametrize("rows,n,offset", [(3, 5000, 0), (2, 4097, 0),
                                           (8, 1 << 18, 0), (4, 1000, 1)])
def test_prefix_prod_kernel_in_place(dev, rows, n, offset):
    """Both forms scan in place (out= x); at an odd offset into its
    storage the rows take the kernel's 8-byte path."""
    buf = convert.from_u64(_rand(rows * n + offset, n + 3), dev)
    x = buf[offset:].view(rows, n)
    for exclusive in (False, True):
        want = gf.prefix_prod_plain(x, exclusive=exclusive)
        y = buf.clone()[offset:].view(rows, n)
        assert gf.prefix_prod(y, exclusive=exclusive, out=y) is y
        assert torch.equal(y, want)


def test_prefix_prod_kernel_in_a_graph_replays(dev):
    x = convert.from_u64(_rand(70000, 9), dev)
    y = convert.from_u64(_rand(70000, 10), dev)
    static = x.clone()
    gf.prefix_prod(static, exclusive=True)  # load the library first
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gf.prefix_prod(static, exclusive=True)
    for z in (x, y, x):
        static.copy_(z)
        graph.replay()
        assert torch.equal(out, gf.prefix_prod_plain(z, exclusive=True))


# ---------------------------------------------------------------------------
# K13, power tables (csrc/powers.cu), and the coset transforms through
# gl_scale_powers
# ---------------------------------------------------------------------------

POWER_BASES = [0, 1, g.P - 1, 1 << 32, 0xFFFFFFFF, 1234567890123456789 % g.P]
EXT_POWER_BASES = [(0, 0), (1, 0), (g.P - 1, 0), (1 << 32, 0), (0, 1),
                   (0, g.P - 1), (123456789, g.P - 5), (g.P - 1, g.P - 1)]


@pytest.mark.parametrize("n", [1, 2, 3, 31, 33, 4095, 4097, 1 << 20,
                               (1 << 23) + 3])
def test_powers_kernel_matches_plain(dev, n):
    """Both fields, a row of bases and one (a host int made a 0-dim
    tensor), edge bases, one launch a table."""
    from olavm_tpu_torch.field import gfe

    bases = gf.from_u64(POWER_BASES, dev)
    before = kernels.LAUNCHES["powers"]
    assert torch.equal(gf.powers(bases, n), gf.powers_plain(bases, n))
    assert kernels.LAUNCHES["powers"] == before + 1
    for b in POWER_BASES[2:4]:
        assert torch.equal(gf.powers(b, n, dev),
                           gf.powers_plain(gf.scalar(b, dev), n))
        assert torch.equal(gf.powers(gf.scalar(b, dev), n),
                           gf.powers_plain(gf.scalar(b, dev), n))
    for b in EXT_POWER_BASES:
        base = gfe.from_u64_pair(np.asarray(b, dtype=np.uint64), dev)
        before = kernels.LAUNCHES["ext_powers"]
        got = gfe.powers_stacked(base, n)
        assert kernels.LAUNCHES["ext_powers"] == before + 1
        want = gfe.powers_plain(base, n)
        assert torch.equal(got, torch.stack([want.re, want.im])), b


def test_powers_kernel_refuses_what_it_does_not_take(dev):
    with pytest.raises(TypeError):
        gf.powers(torch.ones(3, dtype=torch.int32, device=dev), 8)
    with pytest.raises(ValueError):
        gf.powers(torch.ones((2, 2), dtype=torch.int64, device=dev), 8)


def test_extpows_and_refft_programs_are_one_kernel_each(dev):
    """The openings' power table (the extpows program) is one K13 launch
    and the FRI re-FFT one gl_scale_powers and one K1 launch: each graph's
    nodes are those launches and its outputs' copies (no cat, fill or K3),
    and a replay under another challenge equals the plain version."""
    import functools

    from olavm_tpu_torch.field import gfe
    from olavm_tpu_torch.stark import prover_device as tpd
    from olavm_tpu_torch.utils import jitcache

    jitcache.clear()
    n = 1 << 12
    prog = jitcache.cached_jit(("extpows", n),
                               functools.partial(tpd.ext_powers, n=n))
    for z in ((5, 7), (g.P - 1, 3), (0, 1)):
        zb = gf.from_u64(list(z), dev)
        want = gfe.powers_plain(gfe.GFE(zb[0], zb[1]), n)
        assert torch.equal(prog(zb), torch.stack([want.re, want.im])), z
    rows = convert.from_u64(_rand((2, 1 << 10), 3), dev)
    for shift in (7, 7 ** 16 % g.P):
        for _ in range(2):
            got = tpd.fri_refft(rows, shift)
            want = tntt.ntt_plain(gf.scale_powers_plain(rows, shift))
            assert torch.equal(got.re, want[0]) and torch.equal(got.im,
                                                                want[1])
    import chip_smoke

    for key, st in jitcache.stats().items():
        assert st["replays"] >= 1
        assert st["kernels"] == chip_smoke.PROGRAM_KERNELS[st["tag"]], st
        assert st["nodes"] == (chip_smoke.kernel_nodes(key, st["kernels"])
                               + st["outputs"]), st
    jitcache.clear()


@pytest.mark.parametrize("C,log_n", [(1, 1), (3, 5), (17, 10), (16, 20)])
def test_coset_transforms_on_the_card_equal_cpu(dev, C, log_n):
    """scale_by_powers, coset_fft (host and device shifts), coset_ifft,
    coset_lde and intt on the card against the CPU path, with no K3, add,
    sub or power table: the scaling is one gl_scale_powers launch each."""
    n = 1 << log_n
    x = _rand((C, n), C + log_n)
    x[0, 0] = g.P - 1
    t, c = convert.from_u64(x, dev), convert.from_u64(x, "cpu")
    for log in (log_n, log_n + 3):  # the twiddles, built once a size
        tntt.twiddles(log, False, dev)
        tntt.twiddles(log, True, dev)
    kernels.reset_launches()
    calls = (lambda a: tntt.scale_by_powers(a, 5),
             lambda a: tntt.coset_fft(a),
             lambda a: tntt.coset_fft(a, gf.scalar(3, a.device)),
             lambda a: tntt.coset_ifft(a),
             lambda a: tntt.coset_lde(a, 3),
             lambda a: tntt.intt(a))
    for k, call in enumerate(calls):
        assert torch.equal(call(t).cpu(), call(c)), k
    assert kernels.LAUNCHES["scale_powers"] == len(calls)
    assert not any(kernels.LAUNCHES[k] for k in ("gf_mul", "gf_add", "gf_sub",
                                                 "powers", "ext_powers"))


# ---------------------------------------------------------------------------
# K9 and K10, the FRI composition (csrc/fri.cu)
# ---------------------------------------------------------------------------


def _fri_check(coeffs, bank, plan, rate_bits):
    """K9 and K10 against their plain versions on these inputs, each one
    launch; the composition against fri_composition_ops, with no K3, add,
    sub or K7 launch."""
    from olavm_tpu_torch.stark import fri_kernels as fk
    from olavm_tpu_torch.stark import prover_device as tpd

    kernels.reset_launches()
    combined = fk.fri_combine(coeffs, bank, plan, rate_bits)
    assert torch.equal(combined,
                       fk.fri_combine_plain(coeffs, bank, plan, rate_bits))
    lde = tntt.ntt(combined)
    assert torch.equal(fk.fri_quotient(lde, bank, plan),
                       fk.fri_quotient_plain(lde, bank, plan))
    assert (kernels.LAUNCHES["fri_combine"],
            kernels.LAUNCHES["fri_quotient"]) == (1, 1)
    # the first call builds the transforms' twiddles (with K3), as a
    # program's warm-up does
    tpd.fri_composition(*coeffs, bank, plan=plan, rate_bits=rate_bits)
    kernels.reset_launches()
    got = tpd.fri_composition(*coeffs, bank, plan=plan, rate_bits=rate_bits)
    assert not any(kernels.LAUNCHES[k] for k in ("gf_mul", "gf_add",
                                                 "gf_sub", "gf_ext_inv"))
    want = tpd.fri_composition_ops(*coeffs, bank, plan=plan,
                                   rate_bits=rate_bits)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("log_n", [1, 8, 12])
@pytest.mark.parametrize("edge", [False, True])
def test_fri_kernels_match_plain(dev, log_n, edge):
    """Runs of 16 and 17 rows, three batches as the prove plans them; with
    `edge`, EDGE_VALUES throughout and a zero norm."""
    import chip_smoke

    rng = np.random.default_rng(log_n + 10 * edge)
    coeffs, bank, plan = chip_smoke.fri_case((17, 16, 2), 1, 1 << log_n, rng,
                                             dev, edge)
    _fri_check(coeffs, bank, plan, chip_smoke.FRI_RATE_BITS)


@pytest.mark.parametrize("log_size", [1, 2, 5, 13, 23])
def test_fri_quotient_kernel_at_every_batch_count(dev, log_size):
    """K10 on one to four batches at cosets from 2 points (one pair) to
    2^23 (CpuStark's at N=94000), EDGE values and a zero norm."""
    import chip_smoke
    from olavm_tpu_torch.stark import fri_kernels as fk

    rng = np.random.default_rng(log_size)
    size = 1 << log_size
    for batches in (1, 2, 3, 4):
        values = convert.from_u64(
            chip_smoke.edge_values(rng, (batches, 2, size)), dev)
        bank = chip_smoke.edge_values(rng, 6 * batches)
        x = fk.SHIFT * pow(g.primitive_root_of_unity(log_size),
                           int(rng.integers(size)), g.P) % g.P
        bank[0:2] = (x, 0)
        bank = convert.from_u64(bank, dev)
        plan = tuple(((), 6 * b) for b in range(batches))
        assert torch.equal(fk.fri_quotient(values, bank, plan),
                           fk.fri_quotient_plain(values, bank, plan)), batches


def test_fri_kernels_on_a_toy_proves_composition(dev):
    from olavm_tpu_torch.utils import jitcache

    key, _, inputs = _toy_programs(dev)["fricomp"]
    *coeffs, bank = inputs
    _fri_check(coeffs, bank, key[3], key[2])
    jitcache.clear()


# ---------------------------------------------------------------------------
# K11, a CTL Z's row combination (csrc/ctl.cu), and K12, the FRI fold
# (csrc/fri.cu)
# ---------------------------------------------------------------------------


def test_ctl_combine_kernel_on_the_widest_view_at_2_20(dev):
    """The widest view (PoseidonStark's: 24 columns over 25 trace columns)
    at 2^20 rows, random and edge values, its filter's columns 0, 1, 2 and
    p - 1: one launch, equal to the plain version."""
    import chip_smoke
    from olavm_tpu_torch.stark import ctl_kernels as ck

    rng = np.random.default_rng(11)
    view = chip_smoke.widest_view(5)
    assert ck.view_params(view.columns, view.filter_column).slots == 25
    for edge in (False, True):
        trace, bank, on = chip_smoke.ctl_case(view, 1 << 20, rng, dev, edge)
        assert 0 < on < 1 << 20
        args = (trace, view.columns, view.filter_column, bank)
        before = kernels.LAUNCHES["ctl_combine"]
        got = ck.ctl_combine(*args)
        assert kernels.LAUNCHES["ctl_combine"] == before + 1
        assert torch.equal(got, ck.ctl_combine_plain(*args))
        assert torch.equal(got, ck.ctl_combine_ops(*args))


@pytest.mark.parametrize("n", [1, 3, 257, 135_168 + 77])
def test_ctl_combine_kernel_on_every_view(dev, n):
    import chip_smoke
    from olavm_tpu_torch.stark import ctl_kernels as ck

    rng = np.random.default_rng(n)
    for i, view in enumerate(chip_smoke.ctl_views()):
        trace, bank, _ = chip_smoke.ctl_case(view, n, rng, dev, edge=i % 2)
        args = (trace, view.columns, view.filter_column, bank)
        assert torch.equal(ck.ctl_combine(*args),
                           ck.ctl_combine_plain(*args)), i
    assert torch.equal(ck.ctl_combine(trace, [], None, bank),
                       bank[1].expand(n))


def test_ctl_z_program_replays_under_another_bank(dev):
    """A table's CTL Zs captured in a graph (K11 a view into its row of one
    (Z, n) array, then one K8 launch over the rows in place), as
    ctl_data_device's per-table program runs them, and replayed with the
    bank refilled give the new challenges' Zs: no challenge is baked into
    the capture."""
    import chip_smoke
    from olavm_tpu_torch.stark import ctl_device as tctl
    from olavm_tpu_torch.stark import ctl_kernels as ck

    rng = np.random.default_rng(12)
    table_views = [t for t in chip_smoke.ctl_views() if t.table == 0][:5]
    views = tuple((t.columns, t.filter_column, c)
                  for c in (0, 1) for t in table_views)
    trace, _, _ = chip_smoke.ctl_case(chip_smoke.widest_view(0), 1 << 14,
                                      rng, dev)
    static = convert.from_u64(_rand(4, 11), dev)
    before = dict(kernels.LAUNCHES)
    tctl.ctl_table_zs(trace, static, views)
    assert kernels.LAUNCHES["ctl_combine"] - before["ctl_combine"] == 10
    assert kernels.LAUNCHES["prefix_prod"] - before["prefix_prod"] == 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tctl.ctl_table_zs(trace, static, views)
    for seed in (1, 2):
        bank = convert.from_u64(_rand(4, seed), dev)
        static.copy_(bank)
        graph.replay()
        for row, (columns, filt, c) in zip(out, views):
            want = gf.prefix_prod_plain(ck.ctl_combine_plain(
                trace, columns, filt, bank[2 * c:2 * c + 2]))
            assert torch.equal(row, want)


def test_ctl_combine_kernel_refuses_what_it_does_not_take(dev):
    from olavm_tpu_torch.stark import ctl_kernels as ck
    from olavm_tpu_torch.stark.cross_table_lookup import Column

    trace = convert.from_u64(_rand((40, 8), 13), dev)
    bank = convert.from_u64(_rand(2, 14), dev)
    wide = [Column.single(c) for c in range(ck.MAX_SLOTS + 1)]
    with pytest.raises(ValueError, match="ctl_combine.*columns"):
        ck.ctl_combine(trace, wide, None, bank)
    with pytest.raises(ValueError, match="past the trace"):
        ck.ctl_combine(trace[:4], [Column.single(9)], None, bank)


@pytest.mark.parametrize("edge", [False, True])
def test_fri_fold_kernel_at_2_24(dev, edge):
    """N=94000's largest fold, 2^24 -> 2^20 at arity 16: one launch, equal
    to the plain version and to the op-by-op chain it replaced."""
    import chip_smoke
    from olavm_tpu_torch.stark import fri_kernels as fk
    from olavm_tpu_torch.stark import prover_device as tpd

    rng = np.random.default_rng(24 + edge)
    re, im, bpows = chip_smoke.fold_case(24, 16, rng, dev, edge)
    before = kernels.LAUNCHES["fri_fold"]
    got = tpd.fold_stacked(re, im, bpows)
    assert kernels.LAUNCHES["fri_fold"] == before + 1
    assert got.shape == (2, 1 << 20)
    assert torch.equal(got, fk.fri_fold_plain(re, im, bpows))
    assert torch.equal(got, fk.fri_fold_ops(re, im, bpows))


@pytest.mark.parametrize("arity", [2, 4, 8, 16])
@pytest.mark.parametrize("log_m", [4, 9, 18])
def test_fri_fold_kernel_at_every_arity_and_on_slices(dev, arity, log_m):
    import chip_smoke
    from olavm_tpu_torch.stark import fri_kernels as fk

    rng = np.random.default_rng(arity * 100 + log_m)
    re, im, bpows = chip_smoke.fold_case(log_m, arity, rng, dev,
                                         edge=log_m % 2 == 1)
    whole = fk.fri_fold(re, im, bpows)
    assert torch.equal(whole, fk.fri_fold_plain(re, im, bpows))
    rows = (1 << log_m) // arity
    for lo, hi in ((0, rows // 2), (rows // 2, rows), (1, rows - 1)):
        part = fk.fri_fold(re[lo * arity:hi * arity],
                           im[lo * arity:hi * arity], bpows)
        assert torch.equal(part, whole[:, lo:hi]), (lo, hi)


def test_fri_fold_kernel_refuses_what_it_does_not_take(dev):
    import chip_smoke
    from olavm_tpu_torch.stark import fri_kernels as fk

    re, im, bpows = chip_smoke.fold_case(8, 16, np.random.default_rng(0), dev)
    with pytest.raises(ValueError, match="aligned"):
        fk.fri_fold(re[1:17], im[1:17], bpows)
    with pytest.raises(ValueError, match="arity"):
        fk.fri_fold(re, im, bpows[:, :3])
    with pytest.raises(ValueError, match="arity"):
        fk.fri_fold(re[:24], im[:24], bpows)


# ---------------------------------------------------------------------------
# ROADMAP Queue 3, item 1: the lazy helpers and 160-bit sums that take terms
# off, on the card against their g++ build
# ---------------------------------------------------------------------------


def test_lazy_helpers_and_subtracting_sums_agree_with_gxx(dev):
    """goldilocks.cuh's lazy helpers on every pair of edge words, and sums
    started at a multiple of p that take terms off (64-bit and 32-bit PTX
    borrows, 64-bit compares) beside the added-and-subtracted form: the
    card's words equal the g++ build's, and both Python's mod p."""
    import chip_smoke

    res = chip_smoke.check_lazy_sums(dev, np.random.default_rng(1))
    assert res["card_vs_host"] == {} and res["host_vs_python"] == {}
