"""The modules the port carries as copies (olavm_tpu_torch/{field, utils, hash,
ntt/host, stark, isa, assembler, tables, native, runtime}) against their
originals in olavm_tpu, on the CPU, from numpy seeds. Everything is exact
integer or field arithmetic, so the tolerance is 0. The copies that are
whole modules (stark/oracle, stark/prover, runtime/trace_io,
utils/trace_analyzer, node/olavm, state/node_state, state/store) must also
equal their originals line for line below
the docstring's "Carried from" note."""

import json
import os

import numpy as np
import pytest

from olavm_tpu.assembler import encoder as j_encoder
from olavm_tpu.field import extension as j_ge
from olavm_tpu.field import goldilocks as j_g
from olavm_tpu.hash import blake3 as j_b3
from olavm_tpu.hash import keccak as j_keccak
from olavm_tpu.isa import opcodes as j_opcodes
from olavm_tpu.native import lookup_native as j_lookup
from olavm_tpu.ntt import host as j_ntt
from olavm_tpu.stark import polynomial as j_poly
from olavm_tpu.stark.consumer import ConstraintConsumer as JConsumer
from olavm_tpu.stark.ops import BaseOps as JBaseOps
from olavm_tpu.stark.ops import ExtOps as JExtOps
from olavm_tpu.utils import bits as j_bits
from olavm_tpu_torch.assembler import encoder as t_encoder
from olavm_tpu_torch.field import extension as t_ge
from olavm_tpu_torch.field import goldilocks as t_g
from olavm_tpu_torch.hash import blake3 as t_b3
from olavm_tpu_torch.hash import keccak as t_keccak
from olavm_tpu_torch.isa import opcodes as t_opcodes
from olavm_tpu_torch.native import lookup_native as t_lookup
from olavm_tpu_torch.ntt import host as t_ntt
from olavm_tpu_torch.stark import polynomial as t_poly
from olavm_tpu_torch.stark.consumer import ConstraintConsumer as TConsumer
from olavm_tpu_torch.stark.ops import BaseOps as TBaseOps
from olavm_tpu_torch.stark.ops import ExtOps as TExtOps
from olavm_tpu_torch.utils import bits as t_bits
import torch_threads  # noqa: F401  (torch's share of the cores)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = j_g.P
EDGE = [0, 1, 2, P - 1, P - 2, 2**32 - 1, 2**32, 2**63]


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


GOLDILOCKS = {
    "scalar_ops": lambda g: [
        [g.add(a, b), g.sub(a, b), g.mul(a, b), g.neg(a), g.exp(a, 65537)]
        for a in EDGE for b in EDGE],
    "inv": lambda g: [g.inv(a) for a in EDGE[1:]],
    "roots_of_unity": lambda g: [g.primitive_root_of_unity(k) for k in range(33)],
    "subgroup": lambda g: g.two_adic_subgroup(6),
    "mul_arr": lambda g: g.mul_arr(_rand(1 << 16, 1), _rand(1 << 16, 2)),
    "mul_arr_small_and_scalar": lambda g: [
        g.mul_arr(_rand(100, 1), _rand(100, 2)),
        g.mul_arr(_rand(1 << 15, 3), np.uint64(P - 5)),
        g.mul_arr(_rand((4, 1 << 13), 4), _rand(1 << 13, 5))],
    "add_sub_neg_arr": lambda g: [
        g.add_arr(_rand(1 << 16, 6), _rand(1 << 16, 7)),
        g.sub_arr(_rand(1 << 16, 6), _rand(1 << 16, 7)),
        g.neg_arr(np.array(EDGE[:6], dtype=np.uint64))],
    "exp_inv_arr": lambda g: [g.exp_arr(_rand(50, 8), 12345),
                              g.inv_arr(_rand(50, 9) | np.uint64(1))],
    "batch_inv": lambda g: [g.batch_inv(_rand(1 << 16, 10) | np.uint64(1)),
                            g.batch_inv(_rand(33, 11) | np.uint64(1))],
    "powers_and_scans": lambda g: [
        g.powers(7, 1 << 16), g.powers(P - 2, 17), g.sum_mod(_rand((5, 300), 12)),
        g.prefix_sum_mod(_rand(300, 13)), g.prefix_prod_mod(_rand(300, 14))],
}


@pytest.mark.parametrize("case", sorted(GOLDILOCKS))
def test_goldilocks_copy_matches_original(case):
    got, want = GOLDILOCKS[case](t_g), GOLDILOCKS[case](j_g)
    for a, b in zip(got, want):
        _same(a, b)


def _ext(seed, n=None):
    return _rand((2,) if n is None else (n, 2), seed)


EXTENSION = {
    "add_sub_neg": lambda e: [e.add(_ext(1), _ext(2)), e.sub(_ext(1), _ext(2)),
                              e.neg(_ext(3)), e.from_base(P - 1)],
    "mul_square_scalar": lambda e: [e.mul(_ext(1), _ext(2)), e.square(_ext(3)),
                                    e.scalar_mul(_ext(4), P - 7),
                                    e.mul(_ext(5, 64), _ext(6, 64))],
    "inv": lambda e: [e.inv(_ext(7)), e.inv(_ext(8, 16)), e.t_inv(e.t(_ext(9)))],
    "exp": lambda e: [e.exp_pow2(_ext(10), 20), e.exp_u64(_ext(11), 2**40 + 3),
                      np.array(e.t_exp(e.t(_ext(12)), 999), dtype=np.uint64)],
    "powers": lambda e: [e.powers(_ext(13), 70)],
    "tuple_ops": lambda e: [
        np.array(f(e.t(_ext(14)), e.t(_ext(15))), dtype=np.uint64)
        for f in (e.t_add, e.t_sub, e.t_mul)] + [
        np.array(e.t_scalar(e.t(_ext(16)), 12345), dtype=np.uint64),
        e.t_arr(e.t(_ext(17)))],
    "predicates": lambda e: [
        np.array([e.is_one(e.from_base(1)), e.is_one(_ext(18)),
                  e.eq(_ext(19), _ext(19)), e.eq(_ext(19), _ext(20))])],
}


@pytest.mark.parametrize("case", sorted(EXTENSION))
def test_extension_copy_matches_original(case):
    for a, b in zip(EXTENSION[case](t_ge), EXTENSION[case](j_ge)):
        _same(a, b)


@pytest.mark.parametrize("n", [1, 2, 8, 1024])
def test_bits_copy_matches_original(n):
    _same(t_bits.bit_reversal_perm(n), j_bits.bit_reversal_perm(n))
    assert t_bits.log2_strict(n) == j_bits.log2_strict(n)
    x = _rand((3, n), n)
    _same(t_bits.reverse_index_bits(x), j_bits.reverse_index_bits(x))
    assert [t_bits.reverse_bits(i, 10) for i in range(0, 1024, 37)] == [
        j_bits.reverse_bits(i, 10) for i in range(0, 1024, 37)]
    with pytest.raises(Exception):
        t_bits.log2_strict(3 * n)


@pytest.mark.parametrize("length", [0, 1, 3, 64, 65, 200, 1024])
def test_numpy_blake3_copy_matches_original(length):
    data = np.random.default_rng(length).integers(0, 256, length,
                                                  dtype=np.uint8).tobytes()
    assert t_b3.blake3_hash_np(data) == j_b3.blake3_hash_np(data)


@pytest.mark.parametrize("width", [1, 5, 8, 32, 129, 134, 256])
def test_numpy_blake3_leaves_copy_matches_original(width):
    rows = _rand((6, width), width)
    _same(t_b3.hash_leaves_np(rows), j_b3.hash_leaves_np(rows))
    if width == 8:
        left, right = _rand((6, 4), 1), _rand((6, 4), 2)
        _same(t_b3.compress_batch_np(left, right),
              j_b3.compress_batch_np(left, right))
    assert (t_b3.IV, t_b3.PERM) == (j_b3.IV, j_b3.PERM)
    assert [t_b3.CHUNK_START, t_b3.CHUNK_END, t_b3.PARENT, t_b3.ROOT] == [
        j_b3.CHUNK_START, j_b3.CHUNK_END, j_b3.PARENT, j_b3.ROOT]


@pytest.mark.parametrize("length", [0, 1, 32, 135, 136, 137, 500])
def test_keccak_copy_matches_original(length):
    rng = np.random.default_rng(length)
    data = rng.integers(0, 256, length, dtype=np.uint8).tobytes()
    assert t_keccak.keccak256(data) == j_keccak.keccak256(data)
    batch = rng.integers(0, 256, (5, length), dtype=np.uint8)
    _same(t_keccak.keccak256_batch(batch), j_keccak.keccak256_batch(batch))


@pytest.mark.parametrize("logn", [0, 1, 4, 10, 16])
def test_host_ntt_copy_matches_original(logn):
    x = _rand((3, 1 << logn), logn)
    _same(t_ntt.ntt(x), j_ntt.ntt(x))
    _same(t_ntt.intt(x), j_ntt.intt(x))
    _same(t_ntt.coset_fft(x), j_ntt.coset_fft(x))
    _same(t_ntt.coset_ifft(x, 7), j_ntt.coset_ifft(x, 7))
    _same(t_ntt.coset_lde(x, 3), j_ntt.coset_lde(x, 3))
    _same(t_ntt.intt(t_ntt.ntt(x)), x)


POLYNOMIAL = {
    "ext_coset_fft": lambda p: p.ext_coset_fft(_ext(1, 64), 7),
    "ext_poly_eval": lambda p: p.ext_poly_eval(_ext(2, 50), _ext(3)),
    "eval_ext_many": lambda p: p.eval_ext_many(_rand((5, 128), 4), _ext(5)),
    "eval_base_many": lambda p: p.eval_base_many(_rand((5, 128), 6), 123456789),
    "ext_powers_block": lambda p: p.ext_powers_block(_ext(7), 100),
    "divide_by_linear": lambda p: np.concatenate(
        [np.asarray(a).reshape(-1, 2)
         for a in p.divide_by_linear(_ext(8, 32), _ext(9))]),
    "zero_poly_and_lagrange": lambda p: np.stack([
        p.ZeroPolyOnCoset(5, 2).eval_inverse_all(128),
        p.lagrange_selector_on_coset(32, 0, 2),
        p.lagrange_selector_on_coset(32, 31, 2)]),
}


@pytest.mark.parametrize("case", sorted(POLYNOMIAL))
def test_polynomial_copy_matches_original(case):
    _same(POLYNOMIAL[case](t_poly), POLYNOMIAL[case](j_poly))


def test_lookup_copy_matches_original():
    rng = np.random.default_rng(3)
    table = np.arange(64, dtype=np.uint64)
    inputs = rng.integers(0, 64, 64).astype(np.uint64)
    assert t_lookup.available and j_lookup.available
    for a, b in zip(t_lookup.permuted_cols(inputs, table),
                    j_lookup.permuted_cols(inputs, table)):
        _same(a, b)


def test_opcode_tables_copy_matches_original():
    assert [(op.name, op.value) for op in t_opcodes.Opcode] == [
        (op.name, op.value) for op in j_opcodes.Opcode]
    assert {k: v.name for k, v in t_opcodes.TOKEN_TO_OPCODE.items()} == {
        k: v.name for k, v in j_opcodes.TOKEN_TO_OPCODE.items()}
    assert {k: v.name for k, v in t_opcodes.SHIFT_TO_OPCODE.items()} == {
        k: v.name for k, v in j_opcodes.SHIFT_TO_OPCODE.items()}
    assert (t_opcodes.NUM_REGISTERS, t_opcodes.FP_REG) == (
        j_opcodes.NUM_REGISTERS, j_opcodes.FP_REG)
    for r in range(t_opcodes.NUM_REGISTERS):
        assert (t_opcodes.op0_mask(r), t_opcodes.op1_mask(r),
                t_opcodes.dst_mask(r)) == (
            j_opcodes.op0_mask(r), j_opcodes.op1_mask(r), j_opcodes.dst_mask(r))


def test_assembled_program_copy_matches_original():
    with open(os.path.join(ROOT, "tests", "fixtures", "fib_loop_asm.json")) as f:
        spec = json.load(f)
    spec["program"] = spec["program"].replace("{N}", "10")
    got = t_encoder.encode_asm_bundle(spec)
    want = j_encoder.encode_asm_bundle(spec)
    assert got.bytecode == want.bytecode and len(got.bytecode) > 0
    assert [(p.host, p.code, p.inputs) for p in got.prophets] == [
        (p.host, p.code, p.inputs) for p in want.prophets]
    assert got.debug_info == want.debug_info


TABLES = {
    "cpu": "CpuStark", "memory": "MemoryStark", "rangecheck": "RangeCheckStark",
    "cmp": "CmpStark", "tape": "TapeStark", "sccall": "SCCallStark",
    "storage_access": "StorageAccessStark",
    "poseidon_chunk": "PoseidonChunkStark",
}


def _eval_table(pkg: str, module: str, Consumer, Ops, ext):
    """The table's constraints on random extension rows through the host
    ExtOps of one package -> the accumulators."""
    import importlib

    mod = importlib.import_module(f"{pkg}.tables.{module}")
    stark = getattr(mod, TABLES[module])()
    rows = _rand((2, stark.COLUMNS, 2), len(module))
    alphas = [ext.from_base(a) for a in (3, P - 11)]
    consumer = Consumer(Ops, alphas, _ext(101), _ext(102), _ext(103))
    stark.eval_packed(list(rows[0]), list(rows[1]), consumer)
    return stark, np.stack([np.asarray(a) for a in consumer.accumulators()])


@pytest.mark.parametrize("module", sorted(TABLES))
def test_table_copy_evaluates_like_original(module):
    t_stark, got = _eval_table("olavm_tpu_torch", module, TConsumer, TExtOps, t_ge)
    j_stark, want = _eval_table("olavm_tpu", module, JConsumer, JExtOps, j_ge)
    _same(got, want)
    assert got.any()
    assert t_stark.COLUMNS == j_stark.COLUMNS
    assert t_stark.constraint_degree() == j_stark.constraint_degree()
    assert [p.column_pairs for p in t_stark.permutation_pairs()] == [
        p.column_pairs for p in j_stark.permutation_pairs()]


WHOLE_COPIES = ["stark/oracle.py", "stark/prover.py", "runtime/trace_io.py",
                "utils/trace_analyzer.py", "node/olavm.py",
                "state/node_state.py", "state/store.py"]


@pytest.mark.parametrize("path", WHOLE_COPIES)
def test_whole_module_copy_is_unchanged(path):
    with open(os.path.join(ROOT, "olavm_tpu", path)) as f:
        original = f.read()
    with open(os.path.join(ROOT, "olavm_tpu_torch", path)) as f:
        copy = f.read()
    note = f'"""Carried from olavm_tpu/{path}: '
    assert copy.startswith(note)
    # the copy's docstring opens with the note, then the original's text;
    # the usage line of a script names the port's module
    body = copy[copy.index("\n\n") + 2:]
    assert body == original[3:].replace("python -m olavm_tpu.",
                                        "python -m olavm_tpu_torch.")


def test_config_copy_adds_only_the_mesh_backend_and_device():
    # stark/config.py is whole but for MeshConfig's two torch.distributed
    # fields and the arguments of build_mesh's make_mesh (the port's)
    import difflib

    from olavm_tpu.stark import config as j_config
    from olavm_tpu_torch.stark import config as t_config

    with open(os.path.join(ROOT, "olavm_tpu", "stark", "config.py")) as f:
        original = f.read()
    with open(os.path.join(ROOT, "olavm_tpu_torch", "stark", "config.py")) as f:
        copy = f.read()
    assert copy.startswith('"""Carried from olavm_tpu/stark/config.py: ')
    body = copy[copy.index("\n\n") + 2:]
    diff = [ln for ln in difflib.ndiff(original[3:].splitlines(),
                                       body.splitlines())
            if ln[:2] in ("- ", "+ ")]
    assert diff == [
        "+     # torch.distributed backend of the ranks' process group; None = \"nccl\"",
        "+     # on the card, \"gloo\" on the CPU",
        "+     backend: str | None = None",
        "+     # the device every rank proves on: \"cuda\" (cuda:(local rank % cards))",
        "+     # or \"cpu\"",
        "+     device_type: str = \"cuda\"",
        "-         return make_mesh(self.n_devices, self.shape, self.axis_names)",
        "+         return make_mesh(self.n_devices, self.shape, self.axis_names,",
        "+                          self.device_type)",
    ]
    for cfg in (j_config, t_config):
        sharded = cfg.StarkConfig.sharded_config(4)
        assert sharded.mesh.n_devices == 4 and sharded.mesh.axis_names == (
            "col", "row")
        assert cfg.StarkConfig.standard_fast_config().mesh is None
    assert t_config.MeshConfig().backend is None
    assert t_config.MeshConfig().device_type == "cuda"


BASE_OPS = {
    "add": lambda o, a, b: o.add(a, b), "sub": lambda o, a, b: o.sub(a, b),
    "mul": lambda o, a, b: o.mul(a, b), "neg": lambda o, a, b: o.neg(a),
    "constant": lambda o, a, b: o.constant(P + 5),
    "scalar_mul": lambda o, a, b: o.scalar_mul(a, P - 3),
    "add_many": lambda o, a, b: o.add_many([a, b, a]),
    "indicator_eq_const": lambda o, a, b: o.indicator_eq_const(
        np.concatenate([a[:3], [np.uint64(7)]]), 7),
}


@pytest.mark.parametrize("op", sorted(BASE_OPS))
def test_base_ops_copy_matches_original(op):
    a, b = _rand(1000, 21), _rand(1000, 22)
    a[:len(EDGE)] = np.array(EDGE, dtype=np.uint64) % np.uint64(P)
    _same(BASE_OPS[op](TBaseOps, a, b), BASE_OPS[op](JBaseOps, a, b))


@pytest.mark.parametrize("hasher", ["poseidon", "blake3", "keccak"])
def test_host_oracle_copy_matches_original(hasher):
    from olavm_tpu.hash.hashers import by_name as j_by_name
    from olavm_tpu.stark.oracle import PolynomialBatch as JBatch
    from olavm_tpu_torch.hash.hashers import by_name as t_by_name
    from olavm_tpu_torch.stark.oracle import PolynomialBatch as TBatch

    vals = _rand((9, 32), 23)
    t = TBatch.from_values(vals, 3, 2, t_by_name(hasher))
    j = JBatch.from_values(vals, 3, 2, j_by_name(hasher))
    _same(t.cap, j.cap)
    _same(t.polynomials, j.polynomials)
    idx = np.array([0, 7, 127])
    _same(t.get_lde_values_many(idx, 2), j.get_lde_values_many(idx, 2))
    assert t.leaf_and_proof(77) == j.leaf_and_proof(77)


def _fib_trace(pkg: str):
    import importlib
    import tempfile

    from chip_smoke import write_fib_program

    harness = importlib.import_module(f"{pkg}.runtime.harness")
    with tempfile.TemporaryDirectory() as d:
        _, program, _ = harness.run_program_full(write_fib_program(3, d),
                                                 [0, 0])
    return program.trace


def test_trace_io_copy_matches_original():
    from olavm_tpu.runtime import trace_io as j_io
    from olavm_tpu_torch.runtime import trace_io as t_io

    text = j_io.trace_to_json(_fib_trace("olavm_tpu"))
    assert t_io.trace_to_json(_fib_trace("olavm_tpu_torch")) == text
    # a round trip through the copy keeps every field
    assert t_io.trace_to_json(t_io.trace_from_json(text)) == text


def test_trace_analyzer_copy_matches_original(tmp_path):
    from olavm_tpu.utils import trace_analyzer as j_an
    from olavm_tpu_torch.utils import trace_analyzer as t_an

    t_trace, j_trace = _fib_trace("olavm_tpu_torch"), _fib_trace("olavm_tpu")
    assert t_an._TABLES == j_an._TABLES
    for name in t_an._TABLES:
        assert ([t_an._flatten(r) for r in getattr(t_trace, name)]
                == [j_an._flatten(r) for r in getattr(j_trace, name)])
    pytest.importorskip("pandas")
    t_files = t_an.dump_trace(t_trace, str(tmp_path / "t"), fmt="csv")
    j_files = j_an.dump_trace(j_trace, str(tmp_path / "j"), fmt="csv")
    assert len(t_files) == len(j_files) == 12
    for a, b in zip(t_files, j_files):
        with open(a) as fa, open(b) as fb:
            assert fa.read() == fb.read()
