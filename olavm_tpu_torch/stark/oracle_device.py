"""Device polynomial commitment; counterpart of olavm_tpu/stark/oracle_device.py
(the reference PolynomialBatch, plonky2/plonky2/src/fri/oracle.rs:30-164).

A batch keeps only its coefficients and its Merkle digest levels on the
card; the x8 LDE is streamed, as in the TPU package. One card holds the LDE
of a 2^20-row proof (the largest table's is 94 x 2^23 x 8 B = 6.3 GB), but
not of a 2^22-row one: the trace LDEs alone are ~42.6 GB there, and the
proof must also hold its trees, its Z and quotient batches and the
quotient's transients. So `from_coeffs` runs one coset LDE (K1) per block of
16 columns and absorbs it into running per-leaf hash states
(merkle/device.py LeafStream), at most one block of LDE values existing at a
time; the quotient and the FRI read the coefficients (stark/prover_device.py);
FRI query leaves are recomputed by direct evaluation at the queried coset
points (K5, gf.eval_points: the same field elements the LDE would hold).

Merkle leaves are the LDE columns in bit-reversed order (leaf digests are
computed in natural order, then permuted), matching the host tree and the
reference. The blake3 and Poseidon hashers run here (merkle/device.py);
keccak runs only in the host prover (stark/prover.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import goldilocks as g
from ..utils.bits import log2_strict, reverse_bits

from ..field import gf
from ..field import gfe
from ..merkle import device as dmerkle
from ..ntt import ntt as dntt



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
    """Commitment with device-resident coefficients and digest tree (the LDE
    is streamed, never kept).

    coeffs: (C, n) in natural order; the Merkle leaves are the columns of
    the LDE on the coset g * H' (|H'| = n << rate_bits) in bit-reversed
    order."""

    def __init__(self, coeffs: torch.Tensor, levels, cap: np.ndarray,
                 rate_bits: int):
        self.coeffs = coeffs
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
        if C <= dmerkle.NOOP_MAX:
            # leaves of <= 4 elements are their own digests: the LDE values
            digs = dmerkle.leaf_digests(dntt.coset_lde(coeffs, rate_bits),
                                        hasher_kind)
        else:
            # one coset LDE per block of columns, absorbed: the transient
            # is one block (16 x 2^25 x 8 B = 4.3 GB at 2^22 rows)
            stream = dmerkle.LeafStream(C, size, hasher_kind)
            block = dmerkle.STREAM_BLOCK_COLS
            for s in range(0, C, block):
                stream.absorb(dntt.coset_lde(coeffs[s:s + block], rate_bits))
            digs = stream.finalize()
        digs = digs[:, dntt.bitrev_perm(size, coeffs.device)]
        levels, cap = build_tree_device(digs, cap_height, hasher_kind)
        return DevicePolynomialBatch(coeffs, levels, cap, rate_bits)

    @property
    def num_polys(self) -> int:
        return self.coeffs.shape[0]

    @property
    def lde_bits(self) -> int:
        return self.degree_log + self.rate_bits

    def free(self):
        """Release the device buffers once the table's proof is done."""
        self.coeffs = self.levels = None

    def eval_at_ext(self, pows: gfe.GFE) -> np.ndarray:
        """Every polynomial at the extension point whose (n,) power table is
        given -> host (C, 2) u64."""
        return self.eval_at_ext_rows(torch.stack([pows.re, pows.im]))[0]

    def eval_at_ext_rows(self, rows: torch.Tensor) -> list[np.ndarray]:
        """Every polynomial at several extension points at once (K5): rows
        (2m, n) holds the re and im rows of m power tables -> m host (C, 2)
        u64 arrays (a base polynomial at an extension point is two base dot
        products)."""
        out = gf.to_u64(gf.eval_points(self.coeffs, rows))
        return [np.ascontiguousarray(out[2 * i:2 * i + 2].T)
                for i in range(rows.shape[0] // 2)]

    def query_points(self, x_indices) -> list[int]:
        """Coset points g * w^j behind bit-reversed leaf indices x, j the
        reversal of x's bits (olavm_tpu/stark/oracle_device.py:513-520, which
        reads j from the whole permutation: seconds at 2^23 leaves)."""
        bits = self.lde_bits
        w = g.primitive_root_of_unity(bits)
        return [g.mul(g.MULTIPLICATIVE_GROUP_GENERATOR,
                      pow(w, reverse_bits(int(x), bits), g.P))
                for x in x_indices]

    def query_powers(self, x_indices) -> torch.Tensor:
        """(k, n) power tables of the query points (shared by every batch of
        a table: the same points, the same degree): the points copied to the
        card without waiting for it, one K13 launch."""
        points = gf.from_u64(self.query_points(x_indices), self.coeffs.device,
                             pinned=True)
        return gf.powers(points, self.coeffs.shape[1])

    def query_leaves_dev(self, x_indices, pows=None) -> torch.Tensor:
        """Leaf values for bit-reversed leaf indices -> device (k, C), by
        direct evaluation at the coset points (K5); `pows` is
        query_powers(x_indices) if already made."""
        if pows is None:
            pows = self.query_powers(x_indices)
        return gf.eval_points(self.coeffs, pows)

    def query_leaves(self, x_indices, pows=None) -> np.ndarray:
        """(k, C) host u64 leaf values."""
        return gf.to_u64(self.query_leaves_dev(x_indices, pows))

    def prove_batch(self, x_indices) -> list[list[list[int]]]:
        """Merkle paths for a batch of leaf indices: [k][level][4]."""
        num_path_levels = self.lde_bits - log2_strict(len(self.cap))
        return dmerkle.paths_to_host(
            gather_paths_dev(self.levels, x_indices, num_path_levels))
