"""Carried from olavm_tpu/stark/consumer.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

ConstraintConsumer (circuits/src/stark/constraint_consumer.rs:10-78):
accumulates constraints scaled by powers of alpha, with first/last/transition
row selectors. Works with either BaseOps (vectorized) or ExtOps values.

The alpha combination is mathematically the reference's Horner recurrence
acc = acc*alpha + c, but evaluated LAZILY in groups of 16 with a log-depth
power table: the naive per-constraint Horner builds a ~130-deep chained-mul
graph for the CPU table, and XLA compile time explodes superlinearly past
~30 chained muls (measured round 4: depth 30 = 2.4s, depth 40 = >400s).
Exact field arithmetic — the result is bit-identical to the reference's
sequential Horner."""

from __future__ import annotations

_GROUP = 16


def _alpha_powers(F, alpha, n: int):
    """[alpha^0 .. alpha^n], each built at mul-depth <= log2(n)+1."""
    pw = [F.constant(1), alpha]
    while len(pw) <= n:
        i = len(pw)
        pw.append(F.mul(pw[i // 2], pw[i - i // 2]))
    return pw[: n + 1]


def _tree_sum(F, terms):
    while len(terms) > 1:
        nxt = [F.add(terms[i], terms[i + 1])
               for i in range(0, len(terms) - 1, 2)]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


class ConstraintConsumer:
    def __init__(self, F, alphas, z_last, lagrange_first, lagrange_last):
        """alphas: list of values in the SAME representation as constraints
        (base arrays broadcastable, or ext elements)."""
        self.F = F
        self.alphas = alphas
        self.accs = [F.constant(0) for _ in alphas]
        self._pending: list = []
        self.z_last = z_last
        self.lagrange_first = lagrange_first
        self.lagrange_last = lagrange_last

    def _flush(self):
        if not self._pending:
            return
        F = self.F
        cs = self._pending
        self._pending = []
        k = len(cs)
        for i, alpha in enumerate(self.alphas):
            pw = _alpha_powers(F, alpha, k)
            group = _tree_sum(
                F, [F.mul(c, pw[k - 1 - j]) for j, c in enumerate(cs)])
            # acc = acc * alpha^k + sum_j c_j alpha^{k-1-j}
            self.accs[i] = F.add(F.mul(self.accs[i], pw[k]), group)

    def constraint(self, c):
        self._pending.append(c)
        if len(self._pending) >= _GROUP:
            self._flush()

    def constraint_transition(self, c):
        self.constraint(self.F.mul(c, self.z_last))

    def constraint_first_row(self, c):
        self.constraint(self.F.mul(c, self.lagrange_first))

    def constraint_last_row(self, c):
        self.constraint(self.F.mul(c, self.lagrange_last))

    def accumulators(self):
        self._flush()
        return self.accs
