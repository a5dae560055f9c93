"""Host Merkle tree with cap, carried from olavm_tpu/merkle/tree.py without
its JAX device build: the vectorized numpy/native build, query paths and path
verification that the FRI code and the verifier use.

Leaf hashing follows plonky2's hash_or_noop semantics
(plonky2/src/hash/hash_types.rs + hashing.rs:16-23): a leaf of <= 4 field
elements is its own (zero-padded) digest; longer leaves get the hasher.
"""

from __future__ import annotations

import numpy as np


class MerkleTree:
    """Digest tree with cap. levels[0] = leaf digests ... levels[-1] = cap.

    Digests are kept as host uint64 arrays of shape (n, 4) per level so query
    proofs are cheap; the build itself runs on device.
    """

    def __init__(self, levels: list[np.ndarray], cap_height: int,
                 hasher=None):
        from ..hash.hashers import POSEIDON

        self.levels = levels
        self.cap_height = cap_height
        self.hasher = hasher or POSEIDON

    @property
    def cap(self) -> np.ndarray:
        return self.levels[-1]

    @staticmethod
    def build(
        leaves_u64: np.ndarray, cap_height: int = 0, backend: str = "auto",
        hasher=None,
    ) -> "MerkleTree":
        """leaves_u64: (n_leaves, leaf_len) uint64; n_leaves a power of two.

        backend: accepted for call compatibility; the build is always the
        vectorized numpy/native host build. hasher: hash.hashers.POSEIDON /
        BLAKE3.
        """
        from ..hash.hashers import POSEIDON

        hasher = hasher or POSEIDON
        n = leaves_u64.shape[0]
        log_n = n.bit_length() - 1
        assert 1 << log_n == n, "leaf count must be a power of two"
        assert cap_height <= log_n
        levels = _build_host(leaves_u64, log_n - cap_height, hasher)
        return MerkleTree(levels, cap_height, hasher)

    def prove(self, leaf_index: int) -> list[list[int]]:
        """Merkle path: sibling digests from leaf level up to (excl.) the cap."""
        out = []
        idx = leaf_index
        num_levels = len(self.levels) - 1  # exclude cap
        for lvl in range(num_levels):
            sib = idx ^ 1
            out.append([int(v) for v in self.levels[lvl][sib]])
            idx >>= 1
        return out

    @staticmethod
    def verify(
        leaf_data: list[int],
        leaf_index: int,
        cap: np.ndarray,
        proof: list[list[int]],
        hasher=None,
    ) -> bool:
        from ..hash.hashers import POSEIDON

        hasher = hasher or POSEIDON
        digest = _leaf_digest_host(leaf_data, hasher)
        idx = leaf_index
        for sib in proof:
            if idx & 1:
                digest = hasher.two_to_one(sib, digest)
            else:
                digest = hasher.two_to_one(digest, sib)
            idx >>= 1
        return [int(v) for v in cap[idx]] == [int(v) for v in digest]


def _build_host(leaves_u64: np.ndarray, num_compress: int, hasher
                ) -> list[np.ndarray]:
    """Vectorized numpy/native build (batched over all nodes per level)."""
    n, leaf_len = leaves_u64.shape
    if leaf_len <= hasher.noop_max:
        digs = np.zeros((n, 4), dtype=np.uint64)
        digs[:, :leaf_len] = leaves_u64
    else:
        digs = hasher.hash_leaves(leaves_u64)
    levels = [digs]
    for _ in range(num_compress):
        digs = hasher.compress(
            np.ascontiguousarray(digs[0::2]), np.ascontiguousarray(digs[1::2])
        )
        levels.append(digs)
    return levels


def _leaf_digest_host(leaf_data: list[int], hasher) -> list[int]:
    if len(leaf_data) <= hasher.noop_max:
        return list(leaf_data) + [0] * (4 - len(leaf_data))
    return hasher.hash_no_pad(leaf_data)
