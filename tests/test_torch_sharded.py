"""The sharded prover (olavm_tpu_torch/parallel/sharded.py) on the CPU: gloo
process groups of W ranks spawned by run_ranks, device "cpu", the plain
versions of the kernels. One group per W runs every check of that W
(_rank_checks); the tests compare what its ranks returned.

- make_mesh picks olavm_tpu's mesh shape for 1..8 devices;
- the sharded commit's coefficients, digest levels and cap equal the port's
  single-device DevicePolynomialBatch at W = 2, 4 and 8 (blake3 at 3 and 17
  columns, Poseidon at 17, rate 3; blake3 at rate 1, where 4 and 8 ranks
  exceed 2^rate_bits and fold the shifted coefficients), the caps equal
  olavm_tpu's host commit, and olavm_tpu's sharded_commit on the 8-device
  CPU mesh for the blake3 cases at n = 2^6;
- quotient_eval_fn equals olavm_tpu's on a 64 x 8-row window of CmpStark;
- prove_with_traces_sharded on ToySystem (degree 64, 8 PoW bits) at W = 2
  and 4 with blake3 caps and W = 2 with Poseidon caps: every rank's bytes
  equal the port's single-device proof and olavm_tpu's host prover, the
  port's verifier accepts them, and at W = 2 the sharded quotient, fold and
  tree ran (PHASES);
- without a card the default device raises, and no rank loads jax or
  olavm_tpu.

All values are exact field or hash arithmetic: tolerance 0. jax and
olavm_tpu are imported inside the tests only: the ranks import this module,
and must load neither."""

import dataclasses
import functools
import sys

import numpy as np
import pytest
import torch

from olavm_tpu_torch.field import gf
from olavm_tpu_torch.field import goldilocks as g
from olavm_tpu_torch.parallel import sharded as psh
from olavm_tpu_torch.stark.config import FriConfig, MeshConfig, StarkConfig
from olavm_tpu_torch.stark.oracle_device import DevicePolynomialBatch
from olavm_tpu_torch.stark.prover_device import prove_with_traces_device
from olavm_tpu_torch.stark.serialization import (
    deserialize_all_proof,
    serialize_all_proof,
)
from olavm_tpu_torch.stark.verifier import verify_proof
import torch_threads  # noqa: F401  (torch's share of the cores)
from torch_toy_system import ToySystem, build_traces

P = g.P
CAP_HEIGHT = 4
# (hasher, columns, log n, rate bits)
COMMITS = [("blake3", 3, 6, 3), ("blake3", 17, 8, 3), ("poseidon", 17, 7, 3),
           ("blake3", 17, 6, 1)]
# the cases held against olavm_tpu's sharded_commit (its jitted programs
# take 14-19 s a case here; a Poseidon case takes over 100 s)
REFERENCE_SHARDED = [COMMITS[0], COMMITS[3]]
# (W, Merkle hasher) of the sharded proves
PROVES = [(2, "blake3"), (4, "blake3"), (2, "poseidon")]
GROUPS = (2, 4, 8)
DEGREE = 64
POW_BITS = 8
ALPHAS = [3, 5]
# the quotient window: 64 x 8 rows of CmpStark
WINDOW_ROWS = 64 * 8


def _config(hasher):
    return StarkConfig(fri_config=FriConfig(proof_of_work_bits=POW_BITS),
                       merkle_hasher=hasher,
                       mesh=MeshConfig(backend="gloo", device_type="cpu"))


def _commit_values(case):
    _, C, logn, _ = case
    rng = np.random.default_rng(1000 * C + logn)
    return rng.integers(0, P, size=(C, 1 << logn), dtype=np.uint64)


def _window():
    """CmpStark's (R, C) windows at x and g*x, selectors and Z_H^-1."""
    from olavm_tpu_torch.tables.cmp import CmpStark

    rng = np.random.default_rng(3)
    C = CmpStark.COLUMNS
    local = rng.integers(0, P, (WINDOW_ROWS, C), dtype=np.uint64)
    cols = [rng.integers(0, P, WINDOW_ROWS, dtype=np.uint64) for _ in range(4)]
    return local, np.roll(local, -8, axis=0), cols


def _batch_host(batch):
    return (gf.to_u64(batch.coeffs), [gf.to_u64(lv) for lv in batch.levels],
            np.asarray(batch.cap))


# ---------------------------------------------------------------------------
# what every rank of a group runs
# ---------------------------------------------------------------------------


def _rank_checks(world: int) -> dict:
    from olavm_tpu_torch.tables.cmp import CmpStark

    mesh = psh.make_mesh(device_type="cpu")
    out = {"shape": tuple(mesh.mesh.shape), "commits": {}, "proofs": {}}
    for case in COMMITS:
        hasher, _, _, rate_bits = case
        values = gf.from_u64(_commit_values(case), "cpu")
        out["commits"][case] = _batch_host(psh.sharded_batch_from_values(
            mesh, values, rate_bits, CAP_HEIGHT, hasher))
    if world <= 4:
        local, nxt, cols = _window()
        fn = psh.quotient_eval_fn(mesh, CmpStark(), ALPHAS)
        out["quotient"] = [gf.to_u64(q) for q in fn(
            gf.from_u64(local, "cpu"), gf.from_u64(nxt, "cpu"),
            *(gf.from_u64(c, "cpu") for c in cols))]
    for w, hasher in PROVES:
        if w != world:
            continue
        psh.reset_phases()
        proof = psh.prove_with_traces_sharded(
            ToySystem(), _config(hasher), build_traces(DEGREE), device="cpu")
        out["proofs"][hasher] = (serialize_all_proof(proof), dict(psh.PHASES))
    if world == 2:
        try:
            psh.prove_with_traces_sharded(
                ToySystem(), StarkConfig(fri_config=FriConfig(
                    proof_of_work_bits=POW_BITS)), build_traces(DEGREE))
        except RuntimeError as e:
            out["default_device_error"] = str(e)
    out["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "olavm_tpu"))
    return out


_GROUPS: dict = {}


def _group(world: int) -> list[dict]:
    """Every rank's _rank_checks in one gloo group of `world` ranks, run
    once per module."""
    if world not in _GROUPS:
        _GROUPS[world] = psh.run_ranks(_rank_checks, world, "gloo", "cpu",
                                       world)
    return _GROUPS[world]


@pytest.fixture(scope="module")
def single_proofs():
    """The port's single-device proof bytes by Merkle hasher."""
    return {hasher: serialize_all_proof(prove_with_traces_device(
        ToySystem(), _config(hasher), build_traces(DEGREE), device="cpu"))
        for hasher in sorted({h for _, h in PROVES})}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_matches_reference(n):
    from olavm_tpu.parallel.sharded import make_mesh

    assert psh.mesh_shape(n) == make_mesh(n).devices.shape
    if n in GROUPS:
        assert all(r["shape"] == psh.mesh_shape(n) for r in _group(n))


@functools.lru_cache(maxsize=None)
def _single_device_commit(case):
    """The port's single-device commit of a case (coefficients, digest
    levels, cap) and olavm_tpu's host cap, made once for every group size."""
    from olavm_tpu.hash.hashers import by_name
    from olavm_tpu.stark.oracle import PolynomialBatch

    hasher, _, _, rate_bits = case
    values = _commit_values(case)
    single = _batch_host(DevicePolynomialBatch.from_values(
        gf.from_u64(values, "cpu"), rate_bits, CAP_HEIGHT, hasher))
    host = PolynomialBatch.from_values(values, rate_bits, CAP_HEIGHT,
                                       hasher=by_name(hasher))
    return single, np.asarray(host.cap, dtype=np.uint64)


@pytest.mark.parametrize("world", GROUPS)
@pytest.mark.parametrize("case", COMMITS, ids=str)
def test_sharded_commit_equals_single_device(world, case):
    (coeffs, levels, cap), host_cap = _single_device_commit(case)
    for got_coeffs, got_levels, got_cap in (
            r["commits"][case] for r in _group(world)):
        np.testing.assert_array_equal(got_coeffs, coeffs)
        assert len(got_levels) == len(levels)
        for a, b in zip(got_levels, levels):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got_cap, cap)
    np.testing.assert_array_equal(cap, host_cap)


@pytest.mark.parametrize("case", REFERENCE_SHARDED, ids=str)
def test_sharded_commit_cap_equals_reference_sharded_commit(case):
    import jax

    from olavm_tpu.field import gf as jgf
    from olavm_tpu.parallel.sharded import make_mesh, sharded_commit

    hasher, _, _, rate_bits = case
    want, _ = sharded_commit(make_mesh(len(jax.devices())),
                             jgf.from_u64(_commit_values(case)), rate_bits,
                             CAP_HEIGHT, hasher)
    for rank in _group(2):
        np.testing.assert_array_equal(rank["commits"][case][2],
                                      np.asarray(want, dtype=np.uint64))


@pytest.fixture(scope="module")
def reference_quotient():
    """olavm_tpu's quotient_eval_fn over the window on the 8-device mesh."""
    import jax

    from olavm_tpu.field import gf as jgf
    from olavm_tpu.parallel.sharded import make_mesh, quotient_eval_fn
    from olavm_tpu.tables.cmp import CmpStark

    local, nxt, cols = _window()
    mesh = make_mesh(len(jax.devices()))
    args = []
    for a in (local, nxt, *cols):
        x = jgf.from_u64(a)
        args += [x.lo, x.hi]
    with mesh:
        outs = jax.jit(quotient_eval_fn(mesh, CmpStark(), ALPHAS))(*args)
    return [np.asarray(jgf.to_u64(jgf.GF(outs[2 * i], outs[2 * i + 1])))
            for i in range(len(ALPHAS))]


@pytest.mark.parametrize("world", [2, 4])
def test_quotient_eval_fn_matches_reference(world, reference_quotient):
    for rank in _group(world):
        assert len(rank["quotient"]) == len(ALPHAS)
        for got, want in zip(rank["quotient"], reference_quotient):
            np.testing.assert_array_equal(got, want)


@functools.lru_cache(maxsize=None)
def _host_proof(hasher):
    """olavm_tpu's host prover on its ToySystem, serialized, once per
    hasher."""
    from olavm_tpu.stark import config as jconfig
    from olavm_tpu.stark.prover import prove_with_traces
    from olavm_tpu.stark.serialization import (
        serialize_all_proof as j_serialize,
    )
    from test_stark_framework import ToySystem as JToySystem

    return j_serialize(prove_with_traces(JToySystem(), jconfig.StarkConfig(
        fri_config=jconfig.FriConfig(proof_of_work_bits=POW_BITS),
        merkle_hasher=hasher), build_traces(DEGREE)))


@pytest.mark.parametrize("world,hasher", PROVES)
def test_sharded_proof_bytes(world, hasher, single_proofs):
    data = [r["proofs"][hasher][0] for r in _group(world)]
    assert all(d == data[0] for d in data)
    assert data[0] == single_proofs[hasher]
    assert data[0] == _host_proof(hasher)


@pytest.mark.parametrize("world,hasher", PROVES)
def test_sharded_proof_verifies(world, hasher):
    data = _group(world)[0]["proofs"][hasher][0]
    verify_proof(ToySystem(), deserialize_all_proof(data), _config(hasher))


def test_sharded_branches_ran():
    # at W = 2 every branch's layout condition holds: two quotient classes
    # (constraint degree 3), folded rows and tree leaves in even counts
    for hasher in ("blake3", "poseidon"):
        for rank in _group(2):
            phases = rank["proofs"][hasher][1]
            # per table: trace and Z commits iNTT their values; trace, Z and
            # quotient commits; one quotient; one fold and tree per arity
            assert phases["intt"] == 4 and phases["commit"] == 6
            assert phases["quotient"] == 2
            assert phases["fold"] >= 2 and phases["tree"] == phases["fold"]
    # at W = 4 the two classes are not shared out: every rank runs both
    for rank in _group(4):
        phases = rank["proofs"]["blake3"][1]
        assert phases["quotient"] == 0 and phases["commit"] == 6


def test_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    for rank in _group(2):
        assert "no CUDA device" in rank["default_device_error"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        psh.run_ranks(_rank_checks, 2)
    # no process group in this process
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        psh.make_mesh()


@pytest.mark.parametrize("world", GROUPS)
def test_ranks_load_neither_jax_nor_reference(world):
    assert all(r["modules"] == [] for r in _group(world))


def _fail_on_rank_one():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank one fails")
    return dist.get_rank()


def test_run_ranks_raises_a_ranks_error():
    from torch.multiprocessing import ProcessRaisedException

    with pytest.raises(ProcessRaisedException, match="rank one fails"):
        psh.run_ranks(_fail_on_rank_one, 2, "gloo", "cpu")


def test_dryrun_prove_step_over_gloo(capsys):
    # olavm_tpu's dryrun_prove_step on the port: a gloo group of two ranks
    # proves the port's ToySystem, every rank's bytes equal the single-device
    # proof's and the proof verifies (8 PoW bits, as the proves above)
    psh.dryrun_prove_step(2, config=_config("blake3"))
    assert "proof-bytes-equal=True, verified=True" in capsys.readouterr().out


def test_dryrun_prove_step_needs_a_card_per_rank():
    # one rank per card: more ranks than cards fail before any rank starts
    config = dataclasses.replace(_config("blake3"), mesh=MeshConfig(
        backend="nccl", device_type="cuda"))
    with pytest.raises(ValueError, match="one rank per card"):
        psh.dryrun_prove_step(torch.cuda.device_count() + 1, config=config)


def test_dryrun_prove_step_without_a_mesh_needs_a_card(monkeypatch):
    # no mesh in the config and no card: it raises, naming the CPU mesh to
    # ask for, before any rank is spawned
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(psh, "run_ranks", _no_ranks)
    with pytest.raises(RuntimeError, match=r'MeshConfig\(device_type="cpu"\)'):
        psh.dryrun_prove_step(2)


def _no_ranks(*args, **kwargs):
    raise AssertionError("a rank was spawned")


def test_dryrun_toy_system_leaves_torch_threads_as_they_are():
    # the dry run's ToySystem module sets no thread count in the caller
    before = torch.get_num_threads()
    loaded = sys.modules.pop("torch_toy_system")
    torch.set_num_threads(1 if before > 1 else 2)
    try:
        want = torch.get_num_threads()
        toy = psh._toy_system()
        assert toy is not loaded
        assert "pytest" not in vars(toy) and "torch_threads" not in vars(toy)
        assert torch.get_num_threads() == want
    finally:
        sys.modules["torch_toy_system"] = loaded
        torch.set_num_threads(before)
