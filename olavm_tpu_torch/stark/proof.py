"""Carried from olavm_tpu/stark/proof.py: the card has no jax, so this copy imports
only jax-free modules; its code is unchanged.

Proof objects (circuits/src/stark/proof.rs)."""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

import numpy as np

from .fri import FriProof


@dataclass
class StarkOpeningSet:
    local_values: np.ndarray  # (num_cols, 2)
    next_values: np.ndarray
    permutation_ctl_zs: np.ndarray  # (num_zs, 2)
    permutation_ctl_zs_next: np.ndarray
    ctl_zs_last: np.ndarray  # (num_ctl_zs,) base field
    quotient_polys: np.ndarray  # (num_quotient, 2)

    def to_fri_openings(self) -> list[np.ndarray]:
        """Batches of opened values in fri_instance order
        (proof.rs:235-268): [zeta batch, zeta*g batch, g^-1 batch]."""
        zeta_batch = np.concatenate(
            [self.local_values, self.permutation_ctl_zs, self.quotient_polys]
        )
        zeta_next_batch = np.concatenate(
            [self.next_values, self.permutation_ctl_zs_next]
        )
        last_batch = np.zeros((len(self.ctl_zs_last), 2), dtype=np.uint64)
        last_batch[:, 0] = self.ctl_zs_last
        return [zeta_batch, zeta_next_batch, last_batch]


@dataclass
class StarkProof:
    trace_cap: np.ndarray
    permutation_ctl_zs_cap: np.ndarray
    quotient_polys_cap: np.ndarray
    openings: StarkOpeningSet
    opening_proof: FriProof

    def recover_degree_bits(self, config) -> int:
        """From the FRI query-proof path lengths (proof.rs StarkProof)."""
        first = self.opening_proof.query_round_proofs[0]
        path_len = len(first.initial_trees_proof.evals_proofs[0][1])
        lde_bits = path_len + config.fri_config.cap_height
        return lde_bits - config.fri_config.rate_bits

    def num_ctl_zs(self) -> int:
        return len(self.openings.ctl_zs_last)


@dataclass
class PublicValues:
    pre_state_root: tuple = (0, 0, 0, 0)
    post_state_root: tuple = (0, 0, 0, 0)
    block_number: int = 0


@dataclass
class AllProof:
    stark_proofs: list[StarkProof]
    compress_challenges: list[int]
    public_values: PublicValues = dfield(default_factory=PublicValues)

    def degree_bits(self, config) -> list[int]:
        return [p.recover_degree_bits(config) for p in self.stark_proofs]
