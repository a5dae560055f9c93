"""The port's Goldilocks layer (olavm_tpu_torch.field) on CPU tensors against
the host ops (goldilocks.py), the JAX package's two-limb ops (field/gf.py,
field/gfe.py) and the Pallas multiply in interpret mode. Every comparison is
bit-exact: the values are exact field arithmetic."""

import numpy as np
import pytest
import torch

from olavm_tpu.field import extension as ge
from olavm_tpu.field import gf as jgf
from olavm_tpu.field import gfe as jgfe
from olavm_tpu.field import goldilocks as g
from olavm_tpu.field.pallas_kernels import _mul_call
from olavm_tpu_torch import convert
from olavm_tpu_torch.field import gf
from olavm_tpu_torch.field import gfe
from olavm_tpu_torch.stark.ops import TorchOps
import torch_threads  # noqa: F401  (torch's share of the cores)

P = g.P
EDGE = [0, 1, 2, 0xFFFFFFFF, 0x100000000, 0x100000001, P - 1, P - 2,
        P - 0xFFFFFFFF, 0x7FFFFFFFFFFFFFFF % P, 1753635133440165772, 7]


def _rand(n, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, P, size=n, dtype=np.uint64)
    vals[: len(EDGE)] = EDGE
    return vals


@pytest.fixture(scope="module")
def ab():
    """Random operands whose head pairs every edge value with every other."""
    k = len(EDGE)
    a, b = _rand(400, 1), _rand(400, 2)
    a[k:k + k * k] = np.repeat(np.array(EDGE, dtype=np.uint64), k)
    b[k:k + k * k] = np.tile(np.array(EDGE, dtype=np.uint64), k)
    return a, b


def _t(x):
    return convert.from_u64(x, "cpu")


def _u(t):
    return convert.to_u64(t)


def test_roundtrip_and_jax_carry(ab):
    a, _ = ab
    np.testing.assert_array_equal(_u(_t(a)), a)
    np.testing.assert_array_equal(
        _u(convert.from_jax_gf(jgf.from_u64(a), "cpu")), a)
    assert _t(a).dtype == torch.int64


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binops_match_host_and_jax(ab, op):
    a, b = ab
    want = {"add": g.add_arr, "sub": g.sub_arr, "mul": g.mul_arr}[op](a, b)
    jax_out = jgf.to_u64(getattr(jgf, op)(jgf.from_u64(a), jgf.from_u64(b)))
    np.testing.assert_array_equal(jax_out, want)
    got = getattr(gf, op)(_t(a), _t(b))
    np.testing.assert_array_equal(_u(got), want)
    np.testing.assert_array_equal(_u(getattr(gf, f"{op}_plain")(_t(a), _t(b))),
                                  want)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binops_with_0dim_operand(ab, op):
    a, _ = ab
    host = {"add": g.add_arr, "sub": g.sub_arr, "mul": g.mul_arr}[op]
    for c in EDGE:
        s = gf.scalar(c, "cpu")
        assert s.dim() == 0
        cv = np.uint64(c)
        np.testing.assert_array_equal(_u(getattr(gf, op)(_t(a), s)),
                                      host(a, cv))
        np.testing.assert_array_equal(_u(getattr(gf, op)(s, _t(a))),
                                      host(np.full_like(a, cv), a))


def test_neg_square_mul_u32(ab):
    a, _ = ab
    xa = jgf.from_u64(a)
    np.testing.assert_array_equal(_u(gf.neg(_t(a))), jgf.to_u64(jgf.neg(xa)))
    np.testing.assert_array_equal(_u(gf.square(_t(a))),
                                  jgf.to_u64(jgf.square(xa)))
    for k in [0, 1, 3, 7, 0xFFFFFFFF]:
        np.testing.assert_array_equal(_u(gf.mul_u32(_t(a), k)),
                                      jgf.to_u64(jgf.mul_u32(xa, k)))


def test_exp_inv_powers():
    a = _rand(48, 3)
    a[0] = 0
    for e in (0, 1, 5, 7, 2**32 + 3):
        np.testing.assert_array_equal(
            _u(gf.exp_const(_t(a), e)),
            np.array([pow(int(x), e, P) for x in a], dtype=np.uint64))
    np.testing.assert_array_equal(_u(gf.inv(_t(a))),
                                  jgf.to_u64(jgf.inv(jgf.from_u64(a))))
    for n in (1, 2, 13, 64):
        np.testing.assert_array_equal(
            _u(gf.powers(g.POWER_OF_TWO_GENERATOR, n, "cpu")),
            jgf.to_u64(jgf.powers(g.POWER_OF_TWO_GENERATOR, n)))


def test_sum_reduce_prefix_prod_select_eq():
    x = _rand(3 * 37, 4).reshape(3, 37)
    xj = jgf.from_u64(x)
    np.testing.assert_array_equal(_u(gf.sum_reduce(_t(x), -1)),
                                  jgf.to_u64(jgf.sum_reduce(xj, -1)))
    np.testing.assert_array_equal(_u(gf.sum_reduce(_t(x), 0)),
                                  jgf.to_u64(jgf.sum_reduce(xj, 0)))
    np.testing.assert_array_equal(_u(gf.prefix_prod(_t(x), -1)),
                                  jgf.to_u64(jgf.prefix_prod(xj, -1)))
    y = _rand(3 * 37, 5).reshape(3, 37)
    y[:, ::3] = x[:, ::3]
    eq = gf.eq(_t(x), _t(y))
    np.testing.assert_array_equal(eq.numpy(), x == y)
    np.testing.assert_array_equal(_u(gf.select(eq, _t(x), _t(y))),
                                  np.where(x == y, x, y))


def test_mul_plain_matches_pallas_mul_interpret():
    # K3's plain version against the Pallas kernel it replaces
    # (olavm_tpu/field/pallas_kernels.py:79), run in interpret mode
    a, b = _rand(1000, 6), _rand(1000, 7)
    ja, jb = jgf.from_u64(a), jgf.from_u64(b)
    lo, hi = _mul_call(ja.lo, ja.hi, jb.lo, jb.hi, interpret=True)
    want = jgf.to_u64(jgf.GF(lo, hi))
    np.testing.assert_array_equal(want, g.mul_arr(a, b))
    np.testing.assert_array_equal(_u(gf.mul_plain(_t(a), _t(b))), want)


def test_cuda_path_requires_cuda_tensors():
    # a CPU operand never reaches a kernel; mixed devices are refused
    a = gf.scalar(3, "cpu")
    assert gf.mul(a, a).device.type == "cpu"
    with pytest.raises(ValueError):
        gf.mul(a, torch.zeros((), dtype=torch.int64, device="meta"))


def _ext(seed, n):
    return _rand(2 * n, seed).reshape(n, 2)


def test_extension_ops_match_jax_gfe():
    a, b = _ext(8, 40), _ext(9, 40)
    ja, jb = jgfe.from_u64_pair(a), jgfe.from_u64_pair(b)
    ta, tb = gfe.from_u64_pair(a, "cpu"), gfe.from_u64_pair(b, "cpu")
    for op in ("add", "sub", "mul"):
        np.testing.assert_array_equal(
            gfe.to_u64_pair(getattr(gfe, op)(ta, tb)),
            jgfe.to_u64_pair(getattr(jgfe, op)(ja, jb)))
    base = _rand(40, 10)
    np.testing.assert_array_equal(
        gfe.to_u64_pair(gfe.mul_base(ta, _t(base))),
        jgfe.to_u64_pair(jgfe.mul_base(ja, jgf.from_u64(base))))
    np.testing.assert_array_equal(
        gfe.to_u64_pair(gfe.scale_add(ta, tb, _t(base))),
        jgfe.to_u64_pair(jgfe.scale_add(ja, jb, jgf.from_u64(base))))
    np.testing.assert_array_equal(gfe.to_u64_pair(gfe.inv(ta)),
                                  jgfe.to_u64_pair(jgfe.inv(ja)))
    np.testing.assert_array_equal(gfe.to_u64_pair(gfe.exp_const(ta, 11)),
                                  jgfe.to_u64_pair(jgfe.exp_const(ja, 11)))
    np.testing.assert_array_equal(gfe.to_u64_pair(gfe.sum_reduce(ta)),
                                  jgfe.to_u64_pair(jgfe.sum_reduce(ja)))


def test_extension_powers_match_host():
    z = (123456789, P - 5)
    pw = gfe.powers(gfe.from_u64_pair(np.array(z, dtype=np.uint64), "cpu"), 21)
    want = [ge.t(v) for v in ge.powers(np.array(z, dtype=np.uint64), 21)]
    assert [tuple(int(v) for v in row) for row in gfe.to_u64_pair(pw)] == want


def test_torch_ops_adapter():
    F = TorchOps("cpu")
    a = _rand(30, 11)
    c = F.constant(P - 1)
    assert c.dim() == 0 and int(_u(c)) == P - 1
    for k in (0, 1, 5, 2**40 + 1):
        np.testing.assert_array_equal(_u(F.scalar_mul(_t(a), k)),
                                      g.mul_arr(a, np.uint64(k % P)))
    np.testing.assert_array_equal(_u(F.add_many([_t(a)] * 3)),
                                  g.mul_arr(a, np.uint64(3)))
    np.testing.assert_array_equal(_u(F.indicator_eq_const(_t(a), int(a[4]))),
                                  (a == a[4]).astype(np.uint64))
