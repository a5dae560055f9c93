"""Carried from olavm_tpu/stark/stark_base.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

Base Stark interface (circuits/src/stark/stark.rs) + permutation helpers
(circuits/src/stark/permutation.rs)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..field import goldilocks as g


@dataclass
class PermutationPair:
    column_pairs: list[tuple[int, int]]

    @staticmethod
    def singletons(lhs: int, rhs: int) -> "PermutationPair":
        return PermutationPair([(lhs, rhs)])


class Stark:
    """A single table's STARK. Subclasses define columns + constraints."""

    COLUMNS: int = 0

    def eval_packed(self, local, nxt, consumer):
        """local/nxt: sequence of per-column values; consumer accumulates."""
        raise NotImplementedError

    def constraint_degree(self) -> int:
        return 3

    def quotient_degree_factor(self) -> int:
        return max(1, self.constraint_degree() - 1)

    def num_quotient_polys(self, config) -> int:
        return self.quotient_degree_factor() * config.num_challenges

    def permutation_pairs(self) -> list[PermutationPair]:
        return []

    def uses_permutation_args(self) -> bool:
        return bool(self.permutation_pairs())

    def permutation_batch_size(self) -> int:
        return self.quotient_degree_factor()

    def num_permutation_instances(self, config) -> int:
        return len(self.permutation_pairs()) * config.num_challenges

    def num_permutation_batches(self, config) -> int:
        bs = self.permutation_batch_size()
        n = self.num_permutation_instances(config)
        return (n + bs - 1) // bs


@dataclass(frozen=True)
class GrandProductChallenge:
    beta: int
    gamma: int

    def combine(self, terms: list) -> "object":
        """sum_i terms[i] * beta^i + gamma for host scalar ints."""
        acc = 0
        for t in reversed(terms):
            acc = (acc * self.beta + int(t)) % g.P
        return (acc + self.gamma) % g.P

    def combine_vec(self, term_arrays: list[np.ndarray]) -> np.ndarray:
        """Vectorized combine over numpy u64 arrays."""
        acc = np.zeros_like(np.asarray(term_arrays[0], dtype=np.uint64))
        for t in reversed(term_arrays):
            acc = g.add_arr(g.mul_arr(acc, np.uint64(self.beta)), t)
        return g.add_arr(acc, np.uint64(self.gamma))

    def combine_ops(self, F, terms: list):
        """Combine in an ops-adapter representation (Base or Ext)."""
        acc = F.constant(0)
        for t in reversed(terms):
            acc = F.add(F.scalar_mul(acc, self.beta), t)
        return F.add(acc, F.constant(self.gamma))


def get_grand_product_challenge(challenger) -> GrandProductChallenge:
    beta = challenger.get_challenge()
    gamma = challenger.get_challenge()
    return GrandProductChallenge(beta, gamma)


def get_grand_product_challenge_set(challenger, num_challenges) -> list:
    return [get_grand_product_challenge(challenger) for _ in range(num_challenges)]


def get_n_grand_product_challenge_sets(challenger, num_challenges, num_sets):
    return [
        get_grand_product_challenge_set(challenger, num_challenges)
        for _ in range(num_sets)
    ]


def get_permutation_batches(permutation_pairs, challenge_sets, num_challenges,
                            batch_size):
    """Cartesian product of pairs x challenges, chunked (permutation.rs:268-289).

    Returns list of batches; each batch is a list of (pair, challenge)."""
    flat = [
        (pair, chal)
        for pair in permutation_pairs
        for chal in range(num_challenges)
    ]
    batches = []
    for start in range(0, len(flat), batch_size):
        chunk = flat[start : start + batch_size]
        batches.append(
            [
                (pair, challenge_sets[i][chal])
                for i, (pair, chal) in enumerate(chunk)
            ]
        )
    return batches


def compute_permutation_z_polys(stark, config, trace_values, challenge_sets):
    """trace_values: (num_cols, degree). Returns list of (degree,) arrays."""
    pairs = stark.permutation_pairs()
    batches = get_permutation_batches(
        pairs, challenge_sets, config.num_challenges, stark.permutation_batch_size()
    )
    out = []
    degree = trace_values.shape[1]
    for instances in batches:
        num = np.full(degree, 1, dtype=np.uint64)
        den = np.full(degree, 1, dtype=np.uint64)
        for pair, chal in instances:
            lhs = np.full(degree, chal.gamma % g.P, dtype=np.uint64)
            rhs = lhs.copy()
            weight = 1
            for (i, j) in pair.column_pairs:
                lhs = g.add_arr(lhs, g.mul_arr(trace_values[i], np.uint64(weight)))
                rhs = g.add_arr(rhs, g.mul_arr(trace_values[j], np.uint64(weight)))
                weight = g.mul(weight, chal.beta)
            num = g.mul_arr(num, lhs)
            den = g.mul_arr(den, rhs)
        quotients = g.mul_arr(num, g.batch_inv(den))
        # Z = [1, q0, q0 q1, ...] (exclusive prefix product)
        z = np.empty(degree, dtype=np.uint64)
        z[0] = 1
        if degree > 1:
            z[1:] = g.prefix_prod_mod(quotients)[:-1]
        out.append(z)
    return out


def eval_permutation_checks(stark, config, local, nxt, local_zs, next_zs,
                            challenge_sets, consumer):
    """permutation.rs:302-360."""
    F = consumer.F
    for z in local_zs:
        consumer.constraint_first_row(F.sub(z, F.constant(1)))
    pairs = stark.permutation_pairs()
    batches = get_permutation_batches(
        pairs, challenge_sets, config.num_challenges, stark.permutation_batch_size()
    )
    for i, instances in enumerate(batches):
        red_lhs = []
        red_rhs = []
        for pair, chal in instances:
            lhs_terms = [local[a] for (a, _) in pair.column_pairs]
            rhs_terms = [local[b] for (_, b) in pair.column_pairs]
            red_lhs.append(chal.combine_ops(F, lhs_terms))
            red_rhs.append(chal.combine_ops(F, rhs_terms))
        prod_lhs = red_lhs[0]
        for t in red_lhs[1:]:
            prod_lhs = F.mul(prod_lhs, t)
        prod_rhs = red_rhs[0]
        for t in red_rhs[1:]:
            prod_rhs = F.mul(prod_rhs, t)
        consumer.constraint(
            F.sub(F.mul(next_zs[i], prod_rhs), F.mul(local_zs[i], prod_lhs))
        )
