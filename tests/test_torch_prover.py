"""The whole slice on the CPU path: the port's prove_with_traces_device on
ToySystem at degree 64 serializes to the same bytes as olavm_tpu's host
prover (which tests/test_device_prover.py holds byte-equal to the JAX device
prover), olavm_tpu's verifier accepts the port's proof, and the port's
verifier accepts it and rejects a tampered copy.

The Poseidon Merkle configuration gets the same byte check, and the port's
carried host prover (stark/prover.py) gives olavm_tpu's bytes for the keccak
and blake3 configurations.

The CPU grind runs K2's plain version, so the default-suite cases use 8 PoW
bits; the standard 16-bit configuration runs in the slow tier."""

import numpy as np
import pytest

from olavm_tpu.stark import config as jconfig
from olavm_tpu.stark.prover import prove_with_traces
from olavm_tpu.stark.serialization import (
    deserialize_all_proof,
    serialize_all_proof,
)
from olavm_tpu.stark.verifier import verify_proof
from olavm_tpu_torch.stark import config as tconfig
from olavm_tpu_torch.stark import prover as tprover
from olavm_tpu_torch.stark import serialization as tser
from olavm_tpu_torch.stark import verifier as tverifier
from olavm_tpu_torch.stark.prover_device import prove_with_traces_device

from test_stark_framework import ToySystem, build_traces
import torch_threads  # noqa: F401  (torch's share of the cores)


def _configs(pow_bits, merkle_hasher="blake3"):
    return (jconfig.StarkConfig(fri_config=jconfig.FriConfig(
                proof_of_work_bits=pow_bits), merkle_hasher=merkle_hasher),
            tconfig.StarkConfig(fri_config=tconfig.FriConfig(
                proof_of_work_bits=pow_bits), merkle_hasher=merkle_hasher))


def _prove_both(pow_bits, degree=64):
    system = ToySystem()
    host_cfg, port_cfg = _configs(pow_bits)
    traces = build_traces(degree)
    host = prove_with_traces(system, host_cfg, traces)
    port = prove_with_traces_device(system, port_cfg, traces, device="cpu")
    return system, host_cfg, port_cfg, host, port


@pytest.fixture(scope="module")
def proofs():
    return _prove_both(8)


def test_proof_bytes_equal_host_prover(proofs):
    _, _, _, host, port = proofs
    data = tser.serialize_all_proof(port)
    assert data == serialize_all_proof(host)
    assert [p.opening_proof.pow_witness for p in port.stark_proofs] == [
        p.opening_proof.pow_witness for p in host.stark_proofs]


def test_reference_verifier_accepts_port_proof(proofs):
    system, host_cfg, _, _, port = proofs
    verify_proof(system, deserialize_all_proof(tser.serialize_all_proof(port)),
                 host_cfg)


def test_port_verifier_accepts_and_rejects(proofs):
    system, _, port_cfg, _, port = proofs
    tverifier.verify_proof(system, port, port_cfg)
    bad = tser.deserialize_all_proof(tser.serialize_all_proof(port))
    bad.stark_proofs[0].openings.local_values[0][0] ^= np.uint64(1)
    with pytest.raises((tverifier.VerificationError, ValueError)):
        tverifier.verify_proof(system, bad, port_cfg)


def test_default_device_is_the_card_and_is_never_replaced_by_the_cpu():
    import inspect

    import torch

    sig = inspect.signature(prove_with_traces_device)
    assert sig.parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prove_with_traces_device(ToySystem(), _configs(8)[1], build_traces(64))


@pytest.mark.slow
def test_standard_config_bytes_equal_host_prover():
    system, host_cfg, port_cfg, host, port = _prove_both(
        jconfig.FriConfig().proof_of_work_bits)
    data = tser.serialize_all_proof(port)
    assert data == serialize_all_proof(host)
    verify_proof(system, deserialize_all_proof(data), host_cfg)


def test_poseidon_config_bytes_equal_host_prover():
    system = ToySystem()
    host_cfg, port_cfg = _configs(8, "poseidon")
    traces = build_traces(64)
    host = prove_with_traces(system, host_cfg, traces)
    port = prove_with_traces_device(system, port_cfg, traces, device="cpu")
    data = tser.serialize_all_proof(port)
    assert data == serialize_all_proof(host)
    verify_proof(system, deserialize_all_proof(data), host_cfg)
    tverifier.verify_proof(system, port, port_cfg)


@pytest.mark.parametrize("merkle_hasher", ["keccak", "blake3"])
def test_carried_host_prover_bytes_equal_original(merkle_hasher):
    system = ToySystem()
    host_cfg, port_cfg = _configs(8, merkle_hasher)
    traces = build_traces(64)
    want = serialize_all_proof(prove_with_traces(system, host_cfg, traces))
    got = tprover.prove_with_traces(system, port_cfg, traces)
    assert tser.serialize_all_proof(got) == want
    tverifier.verify_proof(system, got, port_cfg)


def test_keccak_config_has_no_device_path():
    with pytest.raises(NotImplementedError, match="host prover"):
        prove_with_traces_device(ToySystem(), _configs(8, "keccak")[1],
                                 build_traces(64), device="cpu")
