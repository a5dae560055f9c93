"""Carried from olavm_tpu/stark/oracle.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

PolynomialBatch: batched polynomial commitment (IFFT -> coset LDE ->
bit-reversed Merkle leaves -> cap tree).

Mirrors the reference oracle (plonky2/plonky2/src/fri/oracle.rs:30-164).
Leaves are LDE rows in bit-reversed index order; `get_lde_values(i, step)`
indexes through the bit reversal, so FRI folding pairs x with -x.
"""

from __future__ import annotations

import numpy as np

from ..field import goldilocks as g
from ..merkle.tree import MerkleTree
from ..ntt import host as ntt
from ..utils.bits import bit_reversal_perm, log2_strict, reverse_bits


class PolynomialBatch:
    def __init__(self, polynomials: np.ndarray, leaves: np.ndarray,
                 merkle_tree: MerkleTree, degree_log: int, rate_bits: int):
        self.polynomials = polynomials  # (num_polys, degree) coefficients
        self.leaves = leaves  # (degree << rate_bits, num_polys), bit-reversed
        self.merkle_tree = merkle_tree
        self.degree_log = degree_log
        self.rate_bits = rate_bits

    @property
    def cap(self) -> np.ndarray:
        return self.merkle_tree.cap

    @staticmethod
    def from_values(values: np.ndarray, rate_bits: int, cap_height: int,
                    hasher=None) -> "PolynomialBatch":
        """values: (num_polys, degree) row-major trace columns."""
        coeffs = ntt.intt(np.asarray(values, dtype=np.uint64))
        return PolynomialBatch.from_coeffs(coeffs, rate_bits, cap_height, hasher)

    @staticmethod
    def from_coeffs(coeffs: np.ndarray, rate_bits: int, cap_height: int,
                    hasher=None) -> "PolynomialBatch":
        num_polys, degree = coeffs.shape
        lde = ntt.coset_lde(coeffs, rate_bits)  # (num_polys, degree<<rate)
        leaves = lde.T  # (size, num_polys)
        perm = bit_reversal_perm(leaves.shape[0])
        leaves = leaves[perm]
        tree = MerkleTree.build(leaves, cap_height, hasher=hasher)
        return PolynomialBatch(
            coeffs, leaves, tree, log2_strict(degree), rate_bits
        )

    def get_lde_values(self, index: int, step: int = 1) -> np.ndarray:
        idx = reverse_bits(index * step, self.degree_log + self.rate_bits)
        return self.leaves[idx]

    def get_lde_values_many(self, indices: np.ndarray, step: int = 1) -> np.ndarray:
        """Vectorized: (k,) indices -> (k, num_polys)."""
        bits = self.degree_log + self.rate_bits
        perm = bit_reversal_perm(1 << bits)
        return self.leaves[perm[np.asarray(indices) * step]]

    def leaf_and_proof(self, index: int):
        """Merkle leaf values + path for a (bit-reversed) leaf index."""
        return [int(v) for v in self.leaves[index]], self.merkle_tree.prove(index)
