"""Device polynomial commitment; counterpart of olavm_tpu/stark/oracle_device.py
(the reference PolynomialBatch, plonky2/plonky2/src/fri/oracle.rs:30-164).

The TPU package streams the LDE through column blocks because a 16 GB chip
cannot hold it. An 80 GB card can: the largest table of the 2^20-row run
needs 94 x 2^23 x 8 B = 6.3 GB. So a batch keeps its coefficients, its LDE
(natural order) and its digest levels resident, and FRI query leaves are
gathers from the LDE (the same field elements the TPU package recomputes by
direct evaluation).

Merkle leaves are the LDE columns in bit-reversed order (leaf digests are
computed in natural order, then permuted), matching the host tree and the
reference. The blake3 and Poseidon hashers run here (merkle/device.py);
keccak runs only in the host prover (stark/prover.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.bits import log2_strict

from ..field import gf
from ..field import gfe
from ..merkle import device as dmerkle
from ..ntt import ntt as dntt

# columns per coset-LDE pass: bounds the transient memory of a wide table
_BLOCK_COLS = 16


def build_tree_device(leaf_digs: torch.Tensor, cap_height: int,
                      hasher_kind: str = "blake3"):
    """Merkle levels over (8, N) leaf digests (already in leaf order).
    Returns (levels: [(8, N), (8, N/2), ...] below the cap, cap: host
    (2^cap_height, 4) u64)."""
    levels = [leaf_digs]
    cur = leaf_digs
    while cur.shape[1] > (1 << cap_height):
        cur = dmerkle.compress_level(cur, hasher_kind)
        levels.append(cur)
    cap = dmerkle.digests_to_u64(levels.pop())
    return levels, cap


def gather_paths_dev(levels, x_indices, num_path_levels: int) -> torch.Tensor:
    """Authentication paths for leaf indices -> (k, num_path_levels, 8) words.
    A tree whose leaves are its cap (degree-2 tables) has empty paths."""
    k = len(x_indices)
    if num_path_levels == 0:
        return torch.zeros((k, 0, 8), dtype=torch.int64)
    if len(levels) != num_path_levels:
        raise ValueError("tree must be built down to the cap")
    device = levels[0].device
    idx = torch.as_tensor(np.asarray(x_indices, dtype=np.int64), device=device)
    sibs = [levels[lvl][:, (idx >> lvl) ^ 1].T for lvl in range(num_path_levels)]
    return torch.stack(sibs, dim=1)


class DevicePolynomialBatch:
    """Commitment with device-resident coefficients, LDE and digest tree.

    coeffs: (C, n) in natural order; lde: (C, n << rate_bits) values on the
    coset g * H' in natural order; Merkle leaves are the LDE columns in
    bit-reversed order."""

    def __init__(self, coeffs: torch.Tensor, lde: torch.Tensor, levels,
                 cap: np.ndarray, rate_bits: int):
        self.coeffs = coeffs
        self.lde = lde
        self.levels = levels
        self.cap = cap
        self.degree_log = log2_strict(coeffs.shape[1])
        self.rate_bits = rate_bits

    @staticmethod
    def from_values(values: torch.Tensor, rate_bits: int, cap_height: int,
                    hasher_kind: str = "blake3") -> "DevicePolynomialBatch":
        return DevicePolynomialBatch.from_coeffs(
            dntt.intt(values), rate_bits, cap_height, hasher_kind)

    @staticmethod
    def from_coeffs(coeffs: torch.Tensor, rate_bits: int, cap_height: int,
                    hasher_kind: str = "blake3") -> "DevicePolynomialBatch":
        dmerkle.check_hasher(hasher_kind)
        C, n = coeffs.shape
        size = n << rate_bits
        lde = torch.empty((C, size), dtype=torch.int64, device=coeffs.device)
        for s in range(0, C, _BLOCK_COLS):
            lde[s:s + _BLOCK_COLS] = dntt.coset_lde(
                coeffs[s:s + _BLOCK_COLS], rate_bits)
        digs = dmerkle.leaf_digests(lde, hasher_kind)
        digs = digs[:, dntt.bitrev_perm(size, coeffs.device)]
        levels, cap = build_tree_device(digs, cap_height, hasher_kind)
        return DevicePolynomialBatch(coeffs, lde, levels, cap, rate_bits)

    @property
    def num_polys(self) -> int:
        return self.coeffs.shape[0]

    @property
    def lde_bits(self) -> int:
        return self.degree_log + self.rate_bits

    def free(self):
        """Release the device buffers once the table's proof is done."""
        self.coeffs = self.lde = self.levels = None

    def eval_at_ext(self, zeta_pows: gfe.GFE) -> np.ndarray:
        """Every polynomial at the extension point whose (n,) power table is
        given -> host (C, 2) u64."""
        c = self.coeffs
        re = gf.sum_reduce(gf.mul(c, zeta_pows.re[None, :]), -1)
        im = gf.sum_reduce(gf.mul(c, zeta_pows.im[None, :]), -1)
        return gfe.to_u64_pair(gfe.GFE(re, im))

    def query_leaves_dev(self, x_indices) -> torch.Tensor:
        """Leaf values for bit-reversed leaf indices -> device (k, C)."""
        perm = dntt.bitrev_perm(1 << self.lde_bits, self.lde.device)
        idx = torch.as_tensor(np.asarray(x_indices, dtype=np.int64),
                              device=self.lde.device)
        return self.lde[:, perm[idx]].T

    def query_leaves(self, x_indices) -> np.ndarray:
        """(k, C) host u64 leaf values."""
        return gf.to_u64(self.query_leaves_dev(x_indices))

    def prove_batch(self, x_indices) -> list[list[list[int]]]:
        """Merkle paths for a batch of leaf indices: [k][level][4]."""
        num_path_levels = self.lde_bits - log2_strict(len(self.cap))
        return dmerkle.paths_to_host(
            gather_paths_dev(self.levels, x_indices, num_path_levels))
