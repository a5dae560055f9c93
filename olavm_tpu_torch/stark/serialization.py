"""Carried from olavm_tpu/stark/serialization.py: the card has no jax, so this copy imports
only jax-free modules; its code is unchanged.

Binary proof serialization, BYTE-COMPATIBLE with the reference
circuits/src/stark/serialization.rs (write_all_proof at :377).

Field-by-field layout, all little-endian (cited against serialization.rs):
  write_all_proof:          u32 #stark_proofs, then each write_proof,
                            then compress_challenges as write_field_vec
                            (u32 count + u64s); PublicValues are NOT
                            serialized (serialization.rs:391 comment) —
                            deserialize returns PublicValues() defaults,
                            exactly like the reference's read_all_proof.
  write_proof (:364):       trace cap, Z cap, quotient cap (write_merkle_cap
                            :125 = u32 count + 32-byte hashes), opening set,
                            fri proof.
  write_opening_set (:164): local/next/perm_ctl_zs/perm_ctl_zs_next as
                            field_ext_vec (u32 count + D=2 u64s each),
                            ctl_zs_last as field_vec, quotient_polys ext vec.
  write_fri_proof (:317):   cap vec (u32 count), query rounds (u32 count;
                            per round: initial proof = u32 #evals_proofs +
                            (field_vec, merkle_proof) pairs; u32 #steps +
                            (ext vec, merkle_proof)), final_poly ext vec,
                            pow_witness u64.
  write_merkle_proof (:195): u8 sibling count + 32-byte hashes.

Round-trip (serialize -> deserialize -> verify) is covered by
tests/test_serialization.py; a golden-bytes regression fixture guards the
layout.
"""

from __future__ import annotations

import struct

import numpy as np

from .fri import (
    FriInitialTreeProof,
    FriProof,
    FriQueryRound,
    FriQueryStep,
)
from .proof import AllProof, PublicValues, StarkOpeningSet, StarkProof


class Buffer:
    def __init__(self, data: bytes = b""):
        self.data = bytearray(data)
        self.pos = 0

    # ---- writing ----
    def write_u8(self, v: int):
        self.data += struct.pack("<B", v)

    def write_u32(self, v: int):
        self.data += struct.pack("<I", v)

    def write_u64(self, v: int):
        self.data += struct.pack("<Q", int(v))

    def write_field_vec(self, vals):
        arr = np.asarray(vals, dtype=np.uint64).reshape(-1)
        self.write_u32(arr.size)
        self.data += arr.tobytes()

    def write_ext(self, v):
        a = np.asarray(v, dtype=np.uint64).reshape(2)
        self.write_u64(int(a[0]))
        self.write_u64(int(a[1]))

    def write_ext_vec(self, vals):
        arr = np.asarray(vals, dtype=np.uint64).reshape(-1, 2)
        self.write_u32(arr.shape[0])
        self.data += arr.tobytes()

    def write_cap(self, cap):
        arr = np.asarray(cap, dtype=np.uint64).reshape(-1, 4)
        self.write_u32(arr.shape[0])
        self.data += arr.tobytes()

    def write_merkle_proof(self, proof):
        self.write_u8(len(proof))
        for sib in proof:
            a = np.asarray(sib, dtype=np.uint64).reshape(4)
            self.data += a.tobytes()

    # ---- reading ----
    def read_u8(self) -> int:
        (v,) = struct.unpack_from("<B", self.data, self.pos)
        self.pos += 1
        return v

    def read_u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.data, self.pos)
        self.pos += 4
        return v

    def read_u64(self) -> int:
        (v,) = struct.unpack_from("<Q", self.data, self.pos)
        self.pos += 8
        return v

    def _read_u64s(self, n) -> np.ndarray:
        out = np.frombuffer(self.data, dtype="<u8", count=n, offset=self.pos)
        self.pos += 8 * n
        return out.astype(np.uint64)

    def read_field_vec(self) -> np.ndarray:
        return self._read_u64s(self.read_u32())

    def read_ext(self) -> np.ndarray:
        return self._read_u64s(2)

    def read_ext_vec(self) -> np.ndarray:
        n = self.read_u32()
        return self._read_u64s(2 * n).reshape(n, 2)

    def read_cap(self) -> np.ndarray:
        n = self.read_u32()
        return self._read_u64s(4 * n).reshape(n, 4)

    def read_merkle_proof(self) -> list:
        n = self.read_u8()
        return [[int(x) for x in self._read_u64s(4)] for _ in range(n)]


def _write_openings(buf: Buffer, o: StarkOpeningSet):
    buf.write_ext_vec(o.local_values)
    buf.write_ext_vec(o.next_values)
    buf.write_ext_vec(o.permutation_ctl_zs)
    buf.write_ext_vec(o.permutation_ctl_zs_next)
    buf.write_field_vec(o.ctl_zs_last)
    buf.write_ext_vec(o.quotient_polys)


def _read_openings(buf: Buffer) -> StarkOpeningSet:
    return StarkOpeningSet(
        local_values=buf.read_ext_vec(),
        next_values=buf.read_ext_vec(),
        permutation_ctl_zs=buf.read_ext_vec(),
        permutation_ctl_zs_next=buf.read_ext_vec(),
        ctl_zs_last=buf.read_field_vec(),
        quotient_polys=buf.read_ext_vec(),
    )


def _write_fri_proof(buf: Buffer, fp: FriProof):
    buf.write_u32(len(fp.commit_phase_merkle_caps))
    for cap in fp.commit_phase_merkle_caps:
        buf.write_cap(cap)
    buf.write_u32(len(fp.query_round_proofs))
    for qr in fp.query_round_proofs:
        buf.write_u32(len(qr.initial_trees_proof.evals_proofs))
        for leaf, path in qr.initial_trees_proof.evals_proofs:
            buf.write_field_vec(leaf)
            buf.write_merkle_proof(path)
        buf.write_u32(len(qr.steps))
        for st in qr.steps:
            buf.write_ext_vec(st.evals)
            buf.write_merkle_proof(st.merkle_proof)
    buf.write_ext_vec(fp.final_poly)
    buf.write_u64(fp.pow_witness)


def _read_fri_proof(buf: Buffer) -> FriProof:
    caps = [buf.read_cap() for _ in range(buf.read_u32())]
    rounds = []
    for _ in range(buf.read_u32()):
        evals_proofs = []
        for _ in range(buf.read_u32()):
            leaf = [int(x) for x in buf.read_field_vec()]
            path = buf.read_merkle_proof()
            evals_proofs.append((leaf, path))
        steps = []
        for _ in range(buf.read_u32()):
            evals = buf.read_ext_vec()
            path = buf.read_merkle_proof()
            steps.append(FriQueryStep(evals, path))
        rounds.append(FriQueryRound(FriInitialTreeProof(evals_proofs), steps))
    final_poly = buf.read_ext_vec()
    pow_witness = buf.read_u64()
    return FriProof(caps, rounds, final_poly, pow_witness)


def _write_stark_proof(buf: Buffer, p: StarkProof):
    buf.write_cap(p.trace_cap)
    buf.write_cap(p.permutation_ctl_zs_cap)
    buf.write_cap(p.quotient_polys_cap)
    _write_openings(buf, p.openings)
    _write_fri_proof(buf, p.opening_proof)


def _read_stark_proof(buf: Buffer) -> StarkProof:
    return StarkProof(
        trace_cap=buf.read_cap(),
        permutation_ctl_zs_cap=buf.read_cap(),
        quotient_polys_cap=buf.read_cap(),
        openings=_read_openings(buf),
        opening_proof=_read_fri_proof(buf),
    )


def serialize_all_proof(proof: AllProof) -> bytes:
    """write_all_proof (serialization.rs:377-392): u32 proof count, proofs,
    compress challenges as a field vec. PublicValues are NOT serialized
    (the reference's writer omits them and its reader defaults them)."""
    buf = Buffer()
    buf.write_u32(len(proof.stark_proofs))
    for p in proof.stark_proofs:
        _write_stark_proof(buf, p)
    buf.write_field_vec(
        np.asarray(list(proof.compress_challenges), dtype=np.uint64)
    )
    return bytes(buf.data)


def deserialize_all_proof(data: bytes) -> AllProof:
    buf = Buffer(data)
    n = buf.read_u32()
    proofs = [_read_stark_proof(buf) for _ in range(n)]
    challenges = [int(c) for c in buf.read_field_vec()]
    assert buf.pos == len(buf.data), "trailing bytes in proof"
    return AllProof(proofs, challenges, PublicValues())
