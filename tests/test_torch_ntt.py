"""The port's NTT layer (olavm_tpu_torch.ntt) on CPU tensors against the JAX
package's jnp ladder (olavm_tpu/ntt/ntt.py), its Pallas kernel K1 in
interpret mode (olavm_tpu/ntt/pallas_ntt.py), the host prover's NTT
(olavm_tpu/ntt/host.py) and a naive Horner evaluation. Bit-exact throughout."""

import jax
import numpy as np
import pytest

from olavm_tpu.field import gf as jgf
from olavm_tpu.field import goldilocks as g
from olavm_tpu.ntt import host as ntt_host
from olavm_tpu.ntt import ntt as jntt
from olavm_tpu.ntt import pallas_ntt
from olavm_tpu_torch import convert
from olavm_tpu_torch.ntt import ntt as tntt
import torch_threads  # noqa: F401  (torch's share of the cores)

P = g.P


def _vals(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def _t(x):
    return convert.from_u64(x, "cpu")


def _jit(fn):
    """A JAX transform over the (lo, hi) pair, jitted: eager dispatch of the
    butterfly ladder op by op is far slower on the CPU than one compile."""
    return jax.jit(lambda lo, hi: tuple(fn(jgf.GF(lo, hi))))


@pytest.mark.parametrize("n", [2, 64, 256])
def test_ntt_intt_match_jax(n):
    x = _vals((3, n), n)
    xj = jgf.from_u64(x)
    for port, ref in ((tntt.ntt, jntt.ntt), (tntt.intt, jntt.intt)):
        want = jgf.to_u64(jgf.GF(*_jit(ref)(xj.lo, xj.hi)))
        np.testing.assert_array_equal(convert.to_u64(port(_t(x))), want)


@pytest.mark.parametrize("n", [1, 2, 64, 256])
def test_coset_and_lde_match_host(n):
    # olavm_tpu.ntt.host is the host prover's NTT, held equal to the JAX
    # ladder by the package's own tests
    x = _vals((3, n), 10 + n)
    pairs = [
        (tntt.ntt(_t(x)), ntt_host.ntt(x)),
        (tntt.intt(_t(x)), ntt_host.intt(x)),
        (tntt.coset_fft(_t(x)), ntt_host.coset_fft(x)),
        (tntt.coset_ifft(_t(x)), ntt_host.coset_ifft(x)),
        (tntt.coset_lde(_t(x), 3), ntt_host.coset_lde(x, 3)),
        (tntt.lde(_t(x), 2), ntt_host.ntt(np.pad(x, ((0, 0), (0, 3 * n))))),
        (tntt.scale_by_powers(_t(x), 7), ntt_host.scale_by_powers(x, 7)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(convert.to_u64(got), want)


@pytest.mark.parametrize("n", [64, 256])
def test_plain_ladder_matches_pallas_ntt_interpret(n):
    # K1's plain version against the Pallas kernel it replaces; like K1 the
    # inverse transform leaves out 1/n
    x = _vals((2, n), 100 + n)
    for inverse in (False, True):
        want = jgf.to_u64(pallas_ntt.ntt_pallas(jgf.from_u64(x), inverse=inverse,
                                                interpret=True))
        got = convert.to_u64(tntt.ntt_plain(_t(x), inverse=inverse))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("logn", range(1, 15))
def test_plain_ladder_matches_host_at_every_size(logn):
    # the plain version K1 is held against on the card, forward and inverse
    # (without 1/n), at every size up to the kernel's largest one-pass tile
    from olavm_tpu_torch import kernels

    n = 1 << logn
    x = _vals((2, n), 200 + logn)
    before = kernels.LAUNCHES["ntt"]
    fwd = convert.to_u64(tntt.ntt_plain(_t(x), inverse=False))
    np.testing.assert_array_equal(fwd, ntt_host.ntt(x))
    inv = convert.to_u64(tntt.ntt_plain(_t(fwd), inverse=True))
    np.testing.assert_array_equal(inv, g.mul_arr(x, np.uint64(n)))
    np.testing.assert_array_equal(convert.to_u64(tntt.ntt(_t(x))), fwd)
    assert kernels.LAUNCHES["ntt"] == before  # a CPU tensor runs no kernel


def test_ntt_matches_naive_evaluation():
    # fft.rs:219-238: degree 200, coeffs i*1337 % 100, zero-padded to 256
    coeffs = [(i * 1337) % 100 for i in range(200)] + [0] * 56
    root = g.primitive_root_of_unity(8)
    want = []
    x = 1
    for _ in range(256):
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * x + c) % P
        want.append(acc)
        x = x * root % P
    vals = tntt.ntt(_t(np.array([coeffs], dtype=np.uint64)))
    assert [int(v) for v in convert.to_u64(vals)[0]] == want
    back = tntt.intt(vals)
    assert [int(v) for v in convert.to_u64(back)[0]] == coeffs


def test_bitrev_perm_and_twiddles():
    perm = tntt.bitrev_perm(16, "cpu").tolist()
    assert perm == [int(f"{i:04b}"[::-1], 2) for i in range(16)]
    tw = convert.to_u64(tntt.twiddles(5, False, "cpu"))
    root = g.primitive_root_of_unity(5)
    assert [int(v) for v in tw] == [pow(root, i, P) for i in range(16)]
    inv = convert.to_u64(tntt.twiddles(5, True, "cpu"))
    assert [int(v) for v in inv] == [pow(g.inv(root), i, P) for i in range(16)]
