"""Host prover helpers the verifier needs, carried from
olavm_tpu/stark/prover.py without jax: only `fri_instance_for_stark`. The
prover itself is stark/prover_device.py."""

from __future__ import annotations

from ..field import extension as ge
from ..field import goldilocks as g

from .fri import FriBatchInfo, FriInstance


def fri_instance_for_stark(stark, zeta, gen: int, degree_bits: int,
                           num_ctl_zs: int, config) -> FriInstance:
    """circuits/src/stark/stark.rs:87-147."""
    num_perm = stark.num_permutation_batches(config)
    trace_info = [(0, i) for i in range(stark.COLUMNS)]
    perm_ctl_info = [(1, i) for i in range(num_perm + num_ctl_zs)]
    ctl_info = [(1, i) for i in range(num_perm, num_perm + num_ctl_zs)]
    quot_info = [(2, i) for i in range(stark.num_quotient_polys(config))]
    zeta_next = ge.scalar_mul(zeta, pow(gen, 1, g.P))
    g_inv = g.inv(g.primitive_root_of_unity(degree_bits))
    return FriInstance(
        batches=[
            FriBatchInfo(zeta, trace_info + perm_ctl_info + quot_info),
            FriBatchInfo(zeta_next, trace_info + perm_ctl_info),
            FriBatchInfo(ge.from_base(g_inv), ctl_info),
        ]
    )
