"""Carried from olavm_tpu/hash/hashers.py: the card has no jax, so this copy imports
only jax-free modules; its code is unchanged.

Merkle hasher configs — the analogue of the reference's GenericConfig
hash choices (plonky2/src/plonk/config.rs:115-160): PoseidonGoldilocksConfig
(field-native, used for the SMT / recursion-friendly paths) and
Blake3GoldilocksConfig (byte hash, what the reference benches use,
circuits/src/stark/ola_stark.rs:684).

A digest is always a (4,)-u64 row ((n, 4) batched): Poseidon digests are 4
canonical field elements; Blake3 digests are the 32 output bytes viewed as
4 little-endian u64 words.

`digest_to_fields` is what the Fiat-Shamir challenger absorbs per digest:
Poseidon -> the 4 elements; Blake3 -> 7-byte chunks of the 32 bytes mapped
to 5 field elements (BytesHash::to_vec, plonky2/src/hash/hash_types.rs:142).
"""

from __future__ import annotations

import numpy as np

from . import poseidon as pos


class PoseidonHasher:
    kind = "poseidon"
    # a leaf of <= 4 field elements is its own zero-padded digest
    noop_max = 4

    @staticmethod
    def hash_leaves(leaves: np.ndarray) -> np.ndarray:
        native = pos._native()
        if native is not None:
            return native.hash_leaves(leaves)
        n, leaf_len = leaves.shape
        state = np.zeros((n, pos.WIDTH), dtype=np.uint64)
        for start in range(0, leaf_len, pos.RATE):
            chunk = min(pos.RATE, leaf_len - start)
            state[:, :chunk] = leaves[:, start : start + chunk]
            state = pos.permute_np(state)
        return state[:, :4]

    @staticmethod
    def compress(left: np.ndarray, right: np.ndarray) -> np.ndarray:
        native = pos._native()
        if native is not None:
            return native.compress_batch(
                np.ascontiguousarray(left), np.ascontiguousarray(right)
            )
        m = left.shape[0]
        state = np.zeros((m, pos.WIDTH), dtype=np.uint64)
        state[:, 0:4] = left
        state[:, 4:8] = right
        return pos.permute_np(state)[:, :4]

    @staticmethod
    def two_to_one(left, right) -> list[int]:
        return pos.two_to_one(left, right)

    @staticmethod
    def hash_no_pad(data) -> list[int]:
        return list(pos.hash_no_pad(data))

    @staticmethod
    def digest_to_fields(digest) -> list[int]:
        return [int(v) for v in digest]


class Blake3Hasher:
    kind = "blake3"
    noop_max = 4  # 4 u64 = 32 bytes = HASH_SIZE (Hasher::hash_or_noop)

    @staticmethod
    def hash_leaves(leaves: np.ndarray) -> np.ndarray:
        from ..native import blake3_native as b3

        return b3.hash_leaves(leaves)

    @staticmethod
    def compress(left: np.ndarray, right: np.ndarray) -> np.ndarray:
        from ..native import blake3_native as b3

        return b3.compress_batch(left, right)

    @staticmethod
    def two_to_one(left, right) -> list[int]:
        from ..native import blake3_native as b3

        buf = (np.asarray(left, dtype=np.uint64).tobytes()
               + np.asarray(right, dtype=np.uint64).tobytes())
        return list(np.frombuffer(b3.blake3_hash(buf), dtype="<u8"))

    @staticmethod
    def hash_no_pad(data) -> list[int]:
        from ..native import blake3_native as b3

        buf = np.asarray(list(data), dtype=np.uint64).tobytes()
        return list(np.frombuffer(b3.blake3_hash(buf), dtype="<u8"))

    @staticmethod
    def digest_to_fields(digest) -> list[int]:
        raw = np.asarray(digest, dtype=np.uint64).tobytes()
        out = []
        for i in range(0, 32, 7):
            chunk = raw[i : i + 7]
            out.append(int.from_bytes(chunk, "little"))
        return out


class KeccakHasher:
    """KeccakGoldilocksConfig analogue (plonk/config.rs:141-152). Digest =
    full 32-byte Keccak-256 viewed as 4 LE u64 words (the reference truncates
    to 25 bytes; kept at 32 here for the uniform cap layout — see
    hash/keccak.py)."""

    kind = "keccak"
    noop_max = 4

    @staticmethod
    def hash_leaves(leaves: np.ndarray) -> np.ndarray:
        from ..hash import keccak as kk

        n = leaves.shape[0]
        data = np.ascontiguousarray(
            leaves.astype("<u8")
        ).view(np.uint8).reshape(n, -1)
        return np.ascontiguousarray(
            kk.keccak256_batch(data)
        ).view("<u8").reshape(n, 4).astype(np.uint64)

    @staticmethod
    def compress(left: np.ndarray, right: np.ndarray) -> np.ndarray:
        from ..hash import keccak as kk

        m = left.shape[0]
        data = np.concatenate(
            [
                np.ascontiguousarray(left.astype("<u8"))
                .view(np.uint8).reshape(m, 32),
                np.ascontiguousarray(right.astype("<u8"))
                .view(np.uint8).reshape(m, 32),
            ],
            axis=1,
        )
        return np.ascontiguousarray(
            kk.keccak256_batch(data)
        ).view("<u8").reshape(m, 4).astype(np.uint64)

    @staticmethod
    def two_to_one(left, right) -> list[int]:
        out = KeccakHasher.compress(
            np.asarray(left, dtype=np.uint64).reshape(1, 4),
            np.asarray(right, dtype=np.uint64).reshape(1, 4),
        )
        return [int(v) for v in out[0]]

    @staticmethod
    def hash_no_pad(data) -> list[int]:
        from ..hash import keccak as kk

        buf = np.asarray(list(data), dtype="<u8").view(np.uint8)
        return [
            int(v)
            for v in np.frombuffer(
                kk.keccak256(buf.tobytes()), dtype="<u8"
            )
        ]

    @staticmethod
    def digest_to_fields(digest) -> list[int]:
        # BytesHash::to_vec — same 7-byte chunking as blake3
        return Blake3Hasher.digest_to_fields(digest)


POSEIDON = PoseidonHasher()
BLAKE3 = Blake3Hasher()
KECCAK = KeccakHasher()


def by_name(name: str):
    if name == "poseidon":
        return POSEIDON
    if name == "blake3":
        return BLAKE3
    if name == "keccak":
        return KECCAK
    raise KeyError(f"unknown hasher {name}")
