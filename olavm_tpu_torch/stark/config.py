"""Carried from olavm_tpu/stark/config.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged but for MeshConfig's `backend` and
`device_type` (the torch.distributed backend and the devices the ranks prove
on) and build_mesh, which builds a torch DeviceMesh over them
(olavm_tpu_torch/parallel/sharded.py make_mesh).

STARK / FRI configuration (circuits/src/stark/config.rs,
plonky2/src/fri/mod.rs, reduction_strategies.rs)."""

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
class MeshConfig:
    """Device-mesh / sharding configuration for the multi-chip prover
    (SURVEY.md §5 "config system" TPU equivalent; the reference has only
    cargo features — `parallel`, `cuda` — in their place).

    The proving pipeline uses two logical axes:
      * ``col`` — trace columns are sharded through IFFT + coset-LDE (each
        column's NTT is independent, the rayon-per-polynomial analogue of
        plonky2/src/fri/oracle.rs:56-128);
      * ``row`` — LDE points / Merkle leaves / quotient coset points are
        sharded after the all-to-all transpose.
    A 1-D mesh folds both onto the same devices (col-parallel in phase 1,
    row-parallel in phase 2), which is the right layout within one ICI
    slice; a 2-D mesh maps ``row`` across hosts (DCN) and ``col`` within a
    host.
    """

    # devices to use; None = all of jax.devices()
    n_devices: int | None = None
    # mesh shape, e.g. (2, 4); None = as square as possible
    shape: tuple | None = None
    axis_names: tuple = ("col", "row")
    # shard the commit phase (IFFT/LDE/Merkle) across the mesh
    shard_commit: bool = True
    # shard quotient evaluation by row block
    shard_quotient: bool = True
    # torch.distributed backend of the ranks' process group; None = "nccl"
    # on the card, "gloo" on the CPU
    backend: str | None = None
    # the device every rank proves on: "cuda" (cuda:(local rank % cards))
    # or "cpu"
    device_type: str = "cuda"

    def build_mesh(self):
        from ..parallel.sharded import make_mesh

        return make_mesh(self.n_devices, self.shape, self.axis_names,
                         self.device_type)


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
    # multi-chip sharding; None = single-chip (host or device) prover
    mesh: MeshConfig | None = None

    @staticmethod
    def standard_fast_config() -> "StarkConfig":
        return StarkConfig()

    @staticmethod
    def sharded_config(n_devices: int | None = None) -> "StarkConfig":
        return StarkConfig(mesh=MeshConfig(n_devices=n_devices))

    def hasher(self):
        from ..hash.hashers import by_name

        return by_name(self.merkle_hasher)
