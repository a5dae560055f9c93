"""Carried from olavm_tpu/stark/fri.py: the card has no jax, so this copy imports
only jax-free modules; its code is unchanged.

FRI low-degree test: commit phase (arity folding), PoW grinding, query
rounds, and verification.

Mirrors the reference exactly (plonky2/plonky2/src/fri/prover.rs,
fri/verifier.rs, fri/oracle.rs:167-243): the final polynomial batches
openings with alpha and divides by (X - z) per batch; commit-phase trees hash
bit-reversed chunked values; queries index the bit-reversed LDE domain.
The PoW witness picks the LOWEST valid nonce (the reference's
par_iter().find_any() accepts any valid nonce; lowest verifies identically
and is deterministic).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..field import extension as ge
from ..field import goldilocks as g
from ..hash import poseidon as pos
from ..merkle.tree import MerkleTree
from ..utils.bits import bit_reversal_perm, reverse_bits
from ..stark.polynomial import ext_coset_fft, ext_poly_eval


@dataclass
class FriQueryStep:
    evals: np.ndarray  # (arity, 2) extension values
    merkle_proof: list


@dataclass
class FriInitialTreeProof:
    evals_proofs: list  # per oracle: (leaf_values list, merkle_proof)


@dataclass
class FriQueryRound:
    initial_trees_proof: FriInitialTreeProof
    steps: list[FriQueryStep]


@dataclass
class FriProof:
    commit_phase_merkle_caps: list[np.ndarray]
    query_round_proofs: list[FriQueryRound]
    final_poly: np.ndarray  # (k, 2) extension coeffs
    pow_witness: int


@dataclass
class FriBatchInfo:
    point: np.ndarray  # extension point (2,)
    polynomials: list[tuple[int, int]]  # (oracle_index, polynomial_index)


@dataclass
class FriInstance:
    batches: list[FriBatchInfo]


def flatten_ext(chunk) -> list[int]:
    """(arity, 2) ext values -> flat base list [re0, im0, re1, im1, ...]."""
    return [int(v) for pair in np.asarray(chunk) for v in pair]


def fri_proof(initial_oracles, final_poly_coeffs: np.ndarray,
              lde_values: np.ndarray, challenger, config,
              degree_bits: int, hasher=None) -> FriProof:
    """initial_oracles: PolynomialBatch list. final_poly_coeffs: (n, 2)
    padded to LDE size; lde_values: (n, 2) evaluations over the coset."""
    n = lde_values.shape[0]
    assert final_poly_coeffs.shape[0] == n
    arity_schedule = config.reduction_arity_bits(degree_bits)

    # ----- commit phase (fri/prover.rs:72-121) -----
    trees: list[MerkleTree] = []
    tree_leaves: list[np.ndarray] = []
    coeffs = final_poly_coeffs
    values = lde_values
    shift = g.MULTIPLICATIVE_GROUP_GENERATOR
    for arity_bits in arity_schedule:
        arity = 1 << arity_bits
        perm = bit_reversal_perm(values.shape[0])
        values = values[perm]
        leaves = np.ascontiguousarray(values.reshape(-1, arity * 2))
        tree = MerkleTree.build(leaves, config.cap_height, hasher=hasher)
        challenger.observe_cap(tree.cap, hasher)
        trees.append(tree)
        tree_leaves.append(leaves)

        beta = challenger.get_extension_challenge()
        chunks = coeffs.reshape(-1, arity, 2)
        acc = np.zeros((chunks.shape[0], 2), dtype=np.uint64)
        for i in range(arity - 1, -1, -1):
            acc = ge.add(ge.mul(acc, np.broadcast_to(beta, acc.shape)), chunks[:, i])
        coeffs = acc
        shift = pow(shift, arity, g.P)
        values = ext_coset_fft(coeffs, shift)

    final_coeffs = coeffs[: coeffs.shape[0] >> config.rate_bits]
    for c in final_coeffs:
        challenger.observe_extension_element(c)

    # ----- PoW phase -----
    current_hash = challenger.get_hash()
    pow_witness = fri_proof_of_work(current_hash, config)

    # ----- query phase -----
    query_indices = [
        c % n for c in challenger.get_n_challenges(config.num_query_rounds)
    ]
    query_rounds = []
    for x_index in query_indices:
        initial = FriInitialTreeProof(
            [list(oracle.leaf_and_proof(x_index)) for oracle in initial_oracles]
        )
        steps = []
        xi = x_index
        for i, arity_bits in enumerate(arity_schedule):
            arity = 1 << arity_bits
            coset_index = xi >> arity_bits
            evals = tree_leaves[i][coset_index].reshape(arity, 2)
            steps.append(FriQueryStep(evals, trees[i].prove(coset_index)))
            xi = coset_index
        query_rounds.append(FriQueryRound(initial, steps))

    return FriProof(
        commit_phase_merkle_caps=[t.cap for t in trees],
        query_round_proofs=query_rounds,
        final_poly=final_coeffs,
        pow_witness=pow_witness,
    )


def fri_proof_of_work(current_hash: list[int], config) -> int:
    """Lowest nonce whose Poseidon response has >= pow_bits leading zeros
    (fri/prover.rs:126-148; Goldilocks order has exactly 64 bits)."""
    threshold = np.uint64(1 << (64 - config.proof_of_work_bits))
    nonce = 0
    batch = 8192
    while True:
        states = np.zeros((batch, 12), dtype=np.uint64)
        states[:, 0:4] = np.array(current_hash, dtype=np.uint64)
        states[:, 4] = np.arange(nonce, nonce + batch, dtype=np.uint64)
        out = pos.permute_np(states)[:, 0]
        hits = np.nonzero(out < threshold)[0]
        if len(hits):
            return nonce + int(hits[0])
        nonce += batch


def pow_response(current_hash: list[int], witness: int) -> int:
    state = np.zeros(12, dtype=np.uint64)
    state[0:4] = np.array(current_hash, dtype=np.uint64)
    state[4] = witness
    return int(pos.permute_np(state)[0])


# ---------------------------------------------------------------------------
# Verification (fri/verifier.rs)
# ---------------------------------------------------------------------------


def _reduce_with_alpha(values, alpha):
    """sum_i values[i] * alpha^i over extension values (int-tuple path)."""
    al = ge.t(alpha)
    acc = (0, 0)
    for v in reversed(list(values)):
        acc = ge.t_add(ge.t_mul(acc, al), ge.t(v))
    return acc


def fri_combine_initial(instance: FriInstance, initial_proof: FriInitialTreeProof,
                        alpha, subgroup_x: int, reduced_openings):
    """fri/verifier.rs:124-166 (int-tuple path)."""
    al = ge.t(alpha)
    x = (int(subgroup_x), 0)
    sum_ = (0, 0)
    for batch, reduced_opening in zip(instance.batches, reduced_openings):
        evals = [
            (int(initial_proof.evals_proofs[oi][0][pi]), 0)
            for (oi, pi) in batch.polynomials
        ]
        reduced_evals = _reduce_with_alpha(evals, al)
        numerator = ge.t_sub(reduced_evals, ge.t(reduced_opening))
        denominator = ge.t_sub(x, ge.t(batch.point))
        sum_ = ge.t_mul(ge.t_exp(al, len(evals)), sum_)
        sum_ = ge.t_add(sum_, ge.t_mul(numerator, ge.t_inv(denominator)))
    return ge.t_mul(sum_, x)


def compute_evaluation(x: int, x_index_within_coset: int, arity_bits: int,
                       evals: np.ndarray, beta):
    """P'(x^arity) from {P(x g^i)} via interpolation (fri/verifier.rs:20-46)."""
    arity = 1 << arity_bits
    g_a = g.primitive_root_of_unity(arity_bits)
    perm = bit_reversal_perm(arity)
    evs = [ge.t(e) for e in np.asarray(evals)[perm]]
    rev_x = reverse_bits(x_index_within_coset, arity_bits)
    coset_start = g.mul(x, pow(g_a, arity - rev_x, g.P))
    xs = [g.mul(coset_start, pow(g_a, i, g.P)) for i in range(arity)]
    bt = ge.t(beta)
    # Lagrange interpolation at beta (O(arity^2), arity <= 16)
    result = (0, 0)
    for i in range(arity):
        num = (1, 0)
        den = 1
        for j in range(arity):
            if i == j:
                continue
            num = ge.t_mul(num, ge.t_sub(bt, (xs[j], 0)))
            den = g.mul(den, g.sub(xs[i], xs[j]))
        result = ge.t_add(result, ge.t_mul(evs[i], ge.t_scalar(num, g.inv(den))))
    return ge.t_arr(result)


def verify_fri_proof(instance: FriInstance, openings_batches, fri_challenges,
                     initial_caps, proof: FriProof, degree_bits: int, config,
                     oracle_num_polys: list[int], hasher=None):
    """openings_batches: list per batch of opened ext values (matching
    instance.batches order). fri_challenges: dict with alpha, betas,
    pow_response, query_indices."""
    alpha = fri_challenges["alpha"]
    betas = fri_challenges["betas"]
    query_indices = fri_challenges["query_indices"]
    arity_schedule = config.reduction_arity_bits(degree_bits)

    if pow_response(fri_challenges["pow_hash"], proof.pow_witness) >= (
        1 << (64 - config.proof_of_work_bits)
    ):
        raise ValueError("invalid FRI proof-of-work witness")
    if len(proof.query_round_proofs) != config.num_query_rounds:
        raise ValueError("wrong number of FRI query rounds")
    expected_final_len = 1 << (degree_bits - sum(arity_schedule))
    if proof.final_poly.shape[0] != expected_final_len:
        raise ValueError("wrong FRI final polynomial length")

    reduced_openings = [
        _reduce_with_alpha(batch, alpha) for batch in openings_batches
    ]

    log_n = degree_bits + config.rate_bits
    for x_index, round_proof in zip(query_indices, proof.query_round_proofs):
        for o, (leaf, path) in enumerate(round_proof.initial_trees_proof.evals_proofs):
            if len(leaf) != oracle_num_polys[o]:
                raise ValueError(f"wrong FRI leaf width for oracle {o}")
            if not MerkleTree.verify(leaf, x_index, initial_caps[o], path,
                                     hasher=hasher):
                raise ValueError(f"FRI initial tree proof invalid (oracle {o})")

        subgroup_x = g.mul(
            g.MULTIPLICATIVE_GROUP_GENERATOR,
            pow(g.primitive_root_of_unity(log_n), reverse_bits(x_index, log_n), g.P),
        )
        old_eval = fri_combine_initial(
            instance, round_proof.initial_trees_proof, alpha, subgroup_x,
            reduced_openings,
        )

        xi = x_index
        for i, arity_bits in enumerate(arity_schedule):
            arity = 1 << arity_bits
            evals = round_proof.steps[i].evals
            coset_index = xi >> arity_bits
            within = xi & (arity - 1)
            if ge.t(old_eval) != ge.t(evals[within]):
                raise ValueError("FRI consistency check failed")
            old_eval = compute_evaluation(
                subgroup_x, within, arity_bits, evals, betas[i]
            )
            if not MerkleTree.verify(
                flatten_ext(evals), coset_index,
                proof.commit_phase_merkle_caps[i],
                round_proof.steps[i].merkle_proof,
                hasher=hasher,
            ):
                raise ValueError("FRI commit-phase Merkle proof invalid")
            subgroup_x = pow(subgroup_x, arity, g.P)
            xi = coset_index

        final_eval = ext_poly_eval(proof.final_poly, ge.from_base(subgroup_x))
        if ge.t(old_eval) != ge.t(final_eval):
            raise ValueError("FRI final polynomial mismatch")
