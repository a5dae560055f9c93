"""Carried from olavm_tpu/stark/prover.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged. This is the numpy prover on the
host (`ola-torch prove -b host`, and the one prover of the Keccak Merkle
configuration); the card's prover is stark/prover_device.py, which never
calls it.

Multi-table STARK prover (circuits/src/stark/prover.rs).

Flow: commit all trace tables -> observe caps -> CTL challenges + Z data ->
per table (in fixed order): compact challenger, permutation challenges/Zs,
Z commitment, alphas, quotient on the coset, quotient commitment, zeta,
openings, FRI opening proof.
"""

from __future__ import annotations

import logging

import numpy as np

from ..field import extension as ge
from ..field import goldilocks as g
from ..ntt import host as ntt
from ..utils.timing import TimingTree
from .challenger import Challenger
from .config import StarkConfig
from .consumer import ConstraintConsumer
from .cross_table_lookup import (
    cross_table_lookup_data,
    eval_cross_table_lookup_checks,
)
from .fri import FriBatchInfo, FriInstance, fri_proof
from .ops import BaseOps
from .oracle import PolynomialBatch
from .polynomial import (
    ZeroPolyOnCoset,
    divide_by_linear,
    eval_base_many,
    eval_ext_many,
    ext_coset_fft,
    lagrange_selector_on_coset,
)
from .proof import AllProof, PublicValues, StarkOpeningSet, StarkProof
from .stark_base import (
    compute_permutation_z_polys,
    eval_permutation_checks,
    get_n_grand_product_challenge_sets,
)
from ..utils.bits import log2_strict

logger = logging.getLogger(__name__)


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


def prove_with_traces(ola_stark, config: StarkConfig,
                      trace_poly_values: list[np.ndarray],
                      public_values: PublicValues | None = None,
                      timing: TimingTree | None = None,
                      debug_check: bool = False) -> AllProof:
    """trace_poly_values: per table, (num_cols, degree) uint64 arrays."""
    timing = timing or TimingTree()
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height

    hasher = config.hasher()
    with timing.scope("compute trace commitments"):
        trace_commitments = [
            PolynomialBatch.from_values(t, rate_bits, cap_height, hasher)
            for t in trace_poly_values
        ]

    challenger = Challenger()
    for c in trace_commitments:
        challenger.observe_cap(c.cap, hasher)

    with timing.scope("cross_table_lookup_data"):
        ctl_data_per_table = cross_table_lookup_data(
            config, trace_poly_values, ola_stark.cross_table_lookups, challenger
        )

    stark_proofs = []
    for idx, stark in enumerate(ola_stark.starks):
        with timing.scope(f"prove table {idx}"):
            proof = prove_single_table(
                stark, config, trace_poly_values[idx], trace_commitments[idx],
                ctl_data_per_table[idx], challenger, timing,
                debug_check=debug_check, table_name=str(idx),
            )
        stark_proofs.append(proof)

    return AllProof(
        stark_proofs=stark_proofs,
        compress_challenges=ola_stark.compress_challenges(),
        public_values=public_values or PublicValues(),
    )


def prove_single_table(stark, config, trace_values, trace_commitment,
                       ctl_data, challenger, timing, debug_check: bool = False,
                       table_name: str = "?") -> StarkProof:
    degree = trace_values.shape[1]
    degree_bits = log2_strict(degree)
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    hasher = config.hasher()
    total_arities = sum(config.fri_config.reduction_arity_bits(degree_bits))
    assert total_arities <= degree_bits + rate_bits - cap_height, (
        "FRI total reduction arity too large"
    )

    challenger.compact()

    # Permutation arguments
    permutation_challenges = None
    permutation_zs = []
    if stark.uses_permutation_args():
        permutation_challenges = get_n_grand_product_challenge_sets(
            challenger, config.num_challenges, stark.permutation_batch_size()
        )
        with timing.scope("permutation Z polys"):
            permutation_zs = compute_permutation_z_polys(
                stark, config, trace_values, permutation_challenges
            )
    num_permutation_zs = len(permutation_zs)

    z_polys = list(permutation_zs) + ctl_data.z_polys()
    assert z_polys, "No CTL?"

    with timing.scope("Z commitment"):
        permutation_ctl_zs_commitment = PolynomialBatch.from_values(
            np.stack(z_polys), rate_bits, cap_height, hasher
        )
    challenger.observe_cap(permutation_ctl_zs_commitment.cap, hasher)

    alphas = challenger.get_n_challenges(config.num_challenges)

    if debug_check:
        check_constraints(
            stark, trace_values, z_polys, permutation_challenges, ctl_data,
            num_permutation_zs, config, table_name,
        )

    with timing.scope("compute quotient polys"):
        quotient_chunks = compute_quotient_polys(
            stark, config, trace_commitment, permutation_ctl_zs_commitment,
            permutation_challenges, ctl_data, alphas, degree_bits,
            num_permutation_zs,
        )

    with timing.scope("quotient commitment"):
        quotient_commitment = PolynomialBatch.from_coeffs(
            quotient_chunks, rate_bits, cap_height, hasher
        )
    challenger.observe_cap(quotient_commitment.cap, hasher)

    zeta = challenger.get_extension_challenge()
    if ge.is_one(ge.exp_pow2(zeta, degree_bits)):
        raise ValueError("opening point is in the subgroup")
    gen = g.primitive_root_of_unity(degree_bits)

    with timing.scope("openings"):
        zeta_next = ge.scalar_mul(zeta, gen)
        local_values = eval_ext_many(trace_commitment.polynomials, zeta)
        next_values = eval_ext_many(trace_commitment.polynomials, zeta_next)
        perm_ctl_zs = eval_ext_many(
            permutation_ctl_zs_commitment.polynomials, zeta
        )
        perm_ctl_zs_next = eval_ext_many(
            permutation_ctl_zs_commitment.polynomials, zeta_next
        )
        ctl_zs_last = eval_base_many(
            permutation_ctl_zs_commitment.polynomials[num_permutation_zs:],
            g.inv(gen),
        )
        quotient_polys_open = eval_ext_many(quotient_commitment.polynomials, zeta)
        openings = StarkOpeningSet(
            local_values, next_values, perm_ctl_zs, perm_ctl_zs_next,
            ctl_zs_last, quotient_polys_open,
        )

    for batch in openings.to_fri_openings():
        challenger.observe_extension_elements(batch)

    instance = fri_instance_for_stark(
        stark, zeta, gen, degree_bits, len(ctl_data), config
    )

    with timing.scope("FRI opening proof"):
        opening_proof = prove_openings(
            instance,
            [trace_commitment, permutation_ctl_zs_commitment, quotient_commitment],
            challenger, config, degree_bits, hasher,
        )

    return StarkProof(
        trace_cap=trace_commitment.cap,
        permutation_ctl_zs_cap=permutation_ctl_zs_commitment.cap,
        quotient_polys_cap=quotient_commitment.cap,
        openings=openings,
        opening_proof=opening_proof,
    )


def prove_openings(instance: FriInstance, oracles, challenger, config,
                   degree_bits: int, hasher=None):
    """PolynomialBatch::prove_openings (fri/oracle.rs:167-243)."""
    alpha = challenger.get_extension_challenge()
    final_poly = None  # (n, 2)
    for batch in instance.batches:
        polys = [oracles[oi].polynomials[pi] for (oi, pi) in batch.polynomials]
        # composition = sum alpha^i * poly_i (base coeffs, ext result)
        max_len = max(p.shape[0] for p in polys)
        comp = np.zeros((max_len, 2), dtype=np.uint64)
        apow = ge.from_base(1)
        for p in polys:
            term0 = g.mul_arr(p, apow[0])
            term1 = g.mul_arr(p, apow[1])
            comp[: p.shape[0], 0] = g.add_arr(comp[: p.shape[0], 0], term0)
            comp[: p.shape[0], 1] = g.add_arr(comp[: p.shape[0], 1], term1)
            apow = ge.mul(apow, alpha)
        quotient, _fz = divide_by_linear(comp, np.asarray(batch.point, np.uint64))
        if final_poly is None:
            final_poly = np.zeros_like(quotient)
        if final_poly.shape[0] < quotient.shape[0]:
            grown = np.zeros_like(quotient)
            grown[: final_poly.shape[0]] = final_poly
            final_poly = grown
        # final_poly = final_poly * alpha^len + quotient
        shift = ge.exp_u64(alpha, len(polys))
        final_poly = ge.add(
            ge.mul(final_poly, np.broadcast_to(shift, final_poly.shape)),
            quotient if quotient.shape == final_poly.shape else _pad(quotient, final_poly.shape[0]),
        )
    # multiply by X (degree bump, see plonky2 PR #436)
    final_poly = np.concatenate(
        [np.zeros((1, 2), dtype=np.uint64), final_poly], axis=0
    )
    # pad to LDE size and evaluate over the coset
    n = 1 << (degree_bits + config.fri_config.rate_bits)
    padded = np.zeros((n, 2), dtype=np.uint64)
    padded[: final_poly.shape[0]] = final_poly
    lde_values = ext_coset_fft(padded, g.MULTIPLICATIVE_GROUP_GENERATOR)
    return fri_proof(
        oracles, padded, lde_values, challenger, config.fri_config,
        degree_bits, hasher,
    )


def _pad(arr: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n, 2), dtype=np.uint64)
    out[: arr.shape[0]] = arr
    return out


def check_constraints(stark, trace_values: np.ndarray, z_polys: list,
                      permutation_challenges, ctl_data, num_permutation_zs,
                      config, table_name: str = "?"):
    """Debug check: re-evaluate all constraints on the subgroup H itself and
    report the first failing row (reference prover.rs:711-819, cfg(test)).
    Uses alpha=[1] with separate accumulators per constraint via a probing
    consumer."""
    from .cross_table_lookup import CtlCheckVars

    degree = trace_values.shape[1]
    local = list(trace_values)
    nxt = list(np.roll(trace_values, -1, axis=1))
    zs = np.stack(z_polys) if z_polys else np.zeros((0, degree), dtype=np.uint64)
    zs_next = np.roll(zs, -1, axis=1)

    lagrange_first = np.zeros(degree, dtype=np.uint64)
    lagrange_first[0] = 1
    lagrange_last = np.zeros(degree, dtype=np.uint64)
    lagrange_last[-1] = 1
    # z_last as 0 on last row, nonzero elsewhere: use x - g^{n-1} over H
    gen = g.primitive_root_of_unity(log2_strict(degree))
    xs = g.powers(gen, degree)
    z_last = g.sub_arr(xs, np.uint64(g.inv(gen)))

    failures = []

    class ProbeConsumer(ConstraintConsumer):
        def __init__(self):
            super().__init__(BaseOps, [np.uint64(1)], z_last, lagrange_first,
                             lagrange_last)
            self.index = 0

        def constraint(self, c):
            bad = np.nonzero(np.asarray(c) != 0)[0]
            if len(bad):
                failures.append((self.index, int(bad[0]), int(c[bad[0]])))
            self.index += 1

    consumer = ProbeConsumer()
    stark.eval_packed(local, nxt, consumer)
    if permutation_challenges is not None:
        eval_permutation_checks(
            stark, config, local, nxt, list(zs[:num_permutation_zs]),
            list(zs_next[:num_permutation_zs]), permutation_challenges, consumer,
        )
    ctl_vars = [
        CtlCheckVars(zs[num_permutation_zs + i], zs_next[num_permutation_zs + i],
                     zc.challenge, zc.columns, zc.filter_column)
        for i, zc in enumerate(ctl_data.zs_columns)
    ]
    eval_cross_table_lookup_checks(local, nxt, ctl_vars, consumer)
    if failures:
        idx, row, val = failures[0]
        raise ValueError(
            f"table {table_name}: constraint #{idx} fails at row {row} "
            f"(value {val}); {len(failures)} constraints failing in total"
        )


def compute_quotient_polys(stark, config, trace_commitment,
                           permutation_ctl_zs_commitment,
                           permutation_challenges, ctl_data, alphas,
                           degree_bits, num_permutation_zs) -> np.ndarray:
    """Vectorized over ALL coset points at once (prover.rs:571-705):
    the per-point packed loop becomes whole-array numpy ops."""
    from .cross_table_lookup import CtlCheckVars

    degree = 1 << degree_bits
    qdb = (stark.quotient_degree_factor()).bit_length() - 1
    if (1 << qdb) < stark.quotient_degree_factor():
        qdb += 1
    rate_bits = config.fri_config.rate_bits
    assert qdb <= rate_bits
    step = 1 << (rate_bits - qdb)
    next_step = 1 << qdb
    size = degree << qdb

    lagrange_first = lagrange_selector_on_coset(degree, 0, qdb)
    lagrange_last = lagrange_selector_on_coset(degree, degree - 1, qdb)
    z_h = ZeroPolyOnCoset(degree_bits, qdb)

    indices = np.arange(size)
    next_indices = (indices + next_step) % size
    trace_local = trace_commitment.get_lde_values_many(indices, step).T
    trace_next = trace_commitment.get_lde_values_many(next_indices, step).T
    zs_local_all = permutation_ctl_zs_commitment.get_lde_values_many(indices, step).T
    zs_next_all = permutation_ctl_zs_commitment.get_lde_values_many(next_indices, step).T

    # coset points
    gen_big = g.primitive_root_of_unity(degree_bits + qdb)
    x = g.mul_arr(
        np.uint64(g.MULTIPLICATIVE_GROUP_GENERATOR), g.powers(gen_big, size)
    )
    last = g.inv(g.primitive_root_of_unity(degree_bits))
    z_last = g.sub_arr(x, np.uint64(last))

    alphas_b = [np.uint64(a) for a in alphas]
    consumer = ConstraintConsumer(
        BaseOps, alphas_b, z_last, lagrange_first, lagrange_last
    )
    local = list(trace_local)
    nxt = list(trace_next)
    stark.eval_packed(local, nxt, consumer)
    if permutation_challenges is not None:
        eval_permutation_checks(
            stark, config, local, nxt,
            list(zs_local_all[:num_permutation_zs]),
            list(zs_next_all[:num_permutation_zs]),
            permutation_challenges, consumer,
        )
    ctl_vars = [
        CtlCheckVars(
            zs_local_all[num_permutation_zs + i],
            zs_next_all[num_permutation_zs + i],
            zc.challenge, zc.columns, zc.filter_column,
        )
        for i, zc in enumerate(ctl_data.zs_columns)
    ]
    eval_cross_table_lookup_checks(local, nxt, ctl_vars, consumer)

    denom_inv = z_h.eval_inverse_all(size)
    quotient_values = [
        g.mul_arr(acc, denom_inv) for acc in consumer.accumulators()
    ]

    # interpolate each quotient poly on the coset, then split into
    # degree-n chunks (prover.rs:463-478)
    chunks = []
    for qv in quotient_values:
        coeffs = ntt.coset_ifft(qv)
        # trim_to_len(degree * quotient_degree_factor): upper coeffs must be 0
        limit = degree * stark.quotient_degree_factor()
        if np.any(coeffs[limit:] != 0):
            raise ValueError(
                "quotient not divisible by Z_H — constraint violated"
            )
        for start in range(0, limit, degree):
            chunks.append(coeffs[start : start + degree])
    return np.stack(chunks)
