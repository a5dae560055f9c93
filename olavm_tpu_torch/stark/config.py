"""STARK / FRI configuration, carried from olavm_tpu/stark/config.py without
its multi-chip MeshConfig (circuits/src/stark/config.rs, plonky2/src/fri/mod.rs,
reduction_strategies.rs)."""

from __future__ import annotations

from dataclasses import dataclass, field as dfield


@dataclass
class FriConfig:
    rate_bits: int = 3
    cap_height: int = 4
    proof_of_work_bits: int = 16
    arity_bits: int = 4
    final_poly_bits: int = 5
    num_query_rounds: int = 28

    def reduction_arity_bits(self, degree_bits: int) -> list[int]:
        """ConstantArityBits(arity_bits, final_poly_bits) schedule."""
        out = []
        db = degree_bits
        while db > self.final_poly_bits and (
            db + self.rate_bits - self.arity_bits >= self.cap_height
        ):
            out.append(self.arity_bits)
            db -= self.arity_bits
        return out


@dataclass
class StarkConfig:
    security_bits: int = 100
    num_challenges: int = 2
    fri_config: FriConfig = dfield(default_factory=FriConfig)
    # Merkle cap hasher: "blake3" (the reference bench/test config,
    # Blake3GoldilocksConfig), "poseidon" (PoseidonGoldilocksConfig) or
    # "keccak" (KeccakGoldilocksConfig, plonk/config.rs:141-160).
    # The Fiat-Shamir challenger is always the Poseidon duplex sponge.
    merkle_hasher: str = "blake3"

    @staticmethod
    def standard_fast_config() -> "StarkConfig":
        return StarkConfig()

    def hasher(self):
        from ..hash.hashers import by_name

        return by_name(self.merkle_hasher)
