"""Carried from olavm_tpu/stark/verifier.py: the card has no jax, so this copy imports
only jax-free modules; its code is unchanged.

Multi-table STARK verifier (circuits/src/stark/verifier.rs,
get_challenges.rs): replay the transcript, verify each table's proof at zeta,
then check cross-table Z products."""

from __future__ import annotations

import numpy as np

from ..field import extension as ge
from ..field import goldilocks as g
from .challenger import Challenger
from ..stark.consumer import ConstraintConsumer
from ..stark.cross_table_lookup import (
    ctl_check_vars_from_proofs,
    eval_cross_table_lookup_checks,
    verify_cross_table_lookups,
)
from .fri import FriInstance, verify_fri_proof
from .ops import ExtOps
from .prover import fri_instance_for_stark
from .proof import AllProof, StarkProof
from ..stark.stark_base import (
    eval_permutation_checks,
    get_grand_product_challenge_set,
    get_n_grand_product_challenge_sets,
)


class VerificationError(Exception):
    pass


def get_proof_challenges(stark, proof: StarkProof, challenger: Challenger,
                         config, degree_bits: int):
    """Per-table challenge replay (get_challenges.rs)."""
    hasher = config.hasher()
    challenges = {}
    challenger.compact()
    if stark.uses_permutation_args():
        challenges["permutation"] = get_n_grand_product_challenge_sets(
            challenger, config.num_challenges, stark.permutation_batch_size()
        )
    else:
        challenges["permutation"] = None
    challenger.observe_cap(proof.permutation_ctl_zs_cap, hasher)
    challenges["alphas"] = challenger.get_n_challenges(config.num_challenges)
    challenger.observe_cap(proof.quotient_polys_cap, hasher)
    challenges["zeta"] = challenger.get_extension_challenge()
    for batch in proof.openings.to_fri_openings():
        challenger.observe_extension_elements(batch)
    # FRI challenges
    fri = {}
    fri["alpha"] = challenger.get_extension_challenge()
    betas = []
    for cap in proof.opening_proof.commit_phase_merkle_caps:
        challenger.observe_cap(cap, hasher)
        betas.append(challenger.get_extension_challenge())
    fri["betas"] = betas
    for c in proof.opening_proof.final_poly:
        challenger.observe_extension_element(c)
    fri["pow_hash"] = challenger.get_hash()
    n = 1 << (degree_bits + config.fri_config.rate_bits)
    fri["query_indices"] = [
        c % n for c in challenger.get_n_challenges(config.fri_config.num_query_rounds)
    ]
    challenges["fri"] = fri
    return challenges


def verify_proof(ola_stark, all_proof: AllProof, config) -> None:
    """Raises VerificationError on failure."""
    num_tables = len(ola_stark.starks)
    assert len(all_proof.stark_proofs) == num_tables

    degree_bits = [p.recover_degree_bits(config) for p in all_proof.stark_proofs]

    # replay shared transcript: trace caps -> CTL challenges
    challenger = Challenger()
    hasher = config.hasher()
    for p in all_proof.stark_proofs:
        challenger.observe_cap(p.trace_cap, hasher)
    ctl_challenges = get_grand_product_challenge_set(
        challenger, config.num_challenges
    )

    num_permutation_zs = [
        s.num_permutation_batches(config) if s.uses_permutation_args() else 0
        for s in ola_stark.starks
    ]
    ctl_vars_per_table = ctl_check_vars_from_proofs(
        all_proof.stark_proofs, ola_stark.cross_table_lookups, ctl_challenges,
        num_permutation_zs,
    )

    for idx, stark in enumerate(ola_stark.starks):
        proof = all_proof.stark_proofs[idx]
        challenges = get_proof_challenges(
            stark, proof, challenger, config, degree_bits[idx]
        )
        verify_stark_proof_with_challenges(
            stark, proof, challenges, ctl_vars_per_table[idx], config,
            degree_bits[idx],
        )

    verify_cross_table_lookups(
        ola_stark.cross_table_lookups,
        [list(p.openings.ctl_zs_last) for p in all_proof.stark_proofs],
        config,
    )


def verify_stark_proof_with_challenges(stark, proof: StarkProof, challenges,
                                       ctl_vars, config, degree_bits: int):
    """verifier.rs:220-330: constraint check at zeta + FRI verify."""
    openings = proof.openings
    zeta = challenges["zeta"]
    gen = g.primitive_root_of_unity(degree_bits)

    # l_first(zeta), l_last(zeta), z_last(zeta)
    # Z_H(zeta) = zeta^n - 1; l_first = Z_H / (n (zeta - 1));
    # l_last = Z_H / (n (zeta - g^-1))
    # eval_l_0_and_l_last (verifier.rs:381-388):
    # l_0 = Z_H(x) / (n (x - 1)); l_last = Z_H(x) / (n (g x - 1))
    z_pow_n = ge.exp_pow2(zeta, degree_bits)
    z_h_zeta = ge.sub(z_pow_n, ge.from_base(1))
    n_val = 1 << degree_bits
    one = ge.from_base(1)
    l_first = ge.mul(
        z_h_zeta, ge.inv(ge.scalar_mul(ge.sub(zeta, one), n_val))
    )
    l_last = ge.mul(
        z_h_zeta,
        ge.inv(ge.scalar_mul(ge.sub(ge.scalar_mul(zeta, gen), one), n_val)),
    )
    g_last = g.inv(gen)
    z_last_eval = ge.sub(zeta, ge.from_base(g_last))

    alphas_ext = [ge.from_base(a) for a in challenges["alphas"]]
    consumer = ConstraintConsumer(ExtOps, alphas_ext, z_last_eval, l_first, l_last)
    local = [openings.local_values[i] for i in range(stark.COLUMNS)]
    nxt = [openings.next_values[i] for i in range(stark.COLUMNS)]
    stark.eval_packed(local, nxt, consumer)

    num_perm = (
        stark.num_permutation_batches(config) if stark.uses_permutation_args() else 0
    )
    if stark.uses_permutation_args():
        eval_permutation_checks(
            stark, config, local, nxt,
            [openings.permutation_ctl_zs[i] for i in range(num_perm)],
            [openings.permutation_ctl_zs_next[i] for i in range(num_perm)],
            challenges["permutation"], consumer,
        )
    # attach opened CTL z values
    for i, v in enumerate(ctl_vars):
        v.local_z = openings.permutation_ctl_zs[num_perm + i]
        v.next_z = openings.permutation_ctl_zs_next[num_perm + i]
    eval_cross_table_lookup_checks(local, nxt, ctl_vars, consumer)

    accs = consumer.accumulators()
    # check quotient: sum_i acc_i ?= Z_H(zeta) * sum_j quotient_chunk_open
    # reference: for each challenge i, acc_i == Z_H(zeta) *
    #   reduce_with_powers(quotient chunks for challenge i, zeta^n)
    qdf = stark.quotient_degree_factor()
    for i in range(config.num_challenges):
        chunks = [
            openings.quotient_polys[i * qdf + j] for j in range(qdf)
        ]
        acc_q = ge.from_base(0)
        for c in reversed(chunks):
            acc_q = ge.add(ge.mul(acc_q, z_pow_n), np.asarray(c, dtype=np.uint64))
        lhs = accs[i]
        rhs = ge.mul(z_h_zeta, acc_q)
        if not np.array_equal(np.asarray(lhs), np.asarray(rhs)):
            raise VerificationError(
                f"constraint check failed at zeta (challenge {i})"
            )

    instance = fri_instance_for_stark(
        stark, zeta, gen, degree_bits, len(ctl_vars), config
    )
    verify_fri_proof(
        instance,
        openings.to_fri_openings(),
        challenges["fri"],
        [proof.trace_cap, proof.permutation_ctl_zs_cap, proof.quotient_polys_cap],
        proof.opening_proof,
        degree_bits,
        config.fri_config,
        [
            stark.COLUMNS,
            num_perm + len(ctl_vars),
            stark.num_quotient_polys(config),
        ],
        hasher=config.hasher(),
    )
