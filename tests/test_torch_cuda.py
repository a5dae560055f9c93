"""The hand-written kernels (olavm_tpu_torch/csrc) on the card: each against
its plain PyTorch version on the same CUDA tensors, bit-exact, and the
ToySystem proof through the kernels equal to olavm_tpu's host proof.

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
from olavm_tpu_torch.ntt import ntt as tntt

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


def test_poseidon_kernel_matches_plain_and_numpy(dev):
    states = _rand((300, 12), 5)
    states[0] = 0
    out = tpos.permute(convert.from_u64(states.T.copy(), dev))
    assert torch.equal(out, tpos.permute_plain(convert.from_u64(states.T.copy(),
                                                                dev)))
    np.testing.assert_array_equal(convert.to_u64(out).T,
                                  jpos.permute_np(states))


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
    assert all(v > 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
