"""Carried from olavm_tpu/stark/cross_table_lookup.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

Cross-table lookups (circuits/src/stark/cross_table_lookup.rs).

A Column is a linear combination of table columns + constant; a
CrossTableLookup binds looking tables to one looked table via grand-product
Z polynomials sharing challenges.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import Optional

import numpy as np

from ..field import goldilocks as g
from .stark_base import GrandProductChallenge, get_grand_product_challenge_set


@dataclass
class Column:
    linear_combination: list[tuple[int, int]]  # (col, coeff)
    constant: int = 0

    @staticmethod
    def single(c: int) -> "Column":
        return Column([(c, 1)])

    @staticmethod
    def singles(cs) -> list["Column"]:
        return [Column.single(c) for c in cs]

    @staticmethod
    def constant_col(k: int) -> "Column":
        return Column([], k % g.P)

    @staticmethod
    def zero() -> "Column":
        return Column.constant_col(0)

    @staticmethod
    def one() -> "Column":
        return Column.constant_col(1)

    @staticmethod
    def linear_combination_with_constant(pairs, constant=0) -> "Column":
        return Column([(c, k % g.P) for c, k in pairs], constant % g.P)

    @staticmethod
    def le_bits(cs) -> "Column":
        return Column([(c, 1 << i) for i, c in enumerate(cs)])

    def eval_table(self, trace: np.ndarray) -> np.ndarray:
        """trace: (num_cols, degree) -> (degree,) evaluation (vectorized)."""
        degree = trace.shape[1]
        acc = np.full(degree, self.constant % g.P, dtype=np.uint64)
        for c, k in self.linear_combination:
            acc = g.add_arr(acc, g.mul_arr(trace[c], np.uint64(k % g.P)))
        return acc

    def eval_ops(self, F, values):
        """values: per-column list in ops representation."""
        acc = F.constant(self.constant)
        for c, k in self.linear_combination:
            acc = F.add(acc, F.scalar_mul(values[c], k))
        return acc


@dataclass
class TableWithColumns:
    table: int  # Table index
    columns: list[Column]
    filter_column: Optional[Column]


@dataclass
class CrossTableLookup:
    looking_tables: list[TableWithColumns]
    looked_table: TableWithColumns


@dataclass
class CtlZData:
    z: np.ndarray  # (degree,)
    challenge: GrandProductChallenge
    columns: list[Column]
    filter_column: Optional[Column]


@dataclass
class CtlData:
    zs_columns: list[CtlZData] = dfield(default_factory=list)

    def __len__(self):
        return len(self.zs_columns)

    def z_polys(self) -> list[np.ndarray]:
        return [zc.z for zc in self.zs_columns]


def partial_products(trace: np.ndarray, columns: list[Column],
                     filter_column: Optional[Column],
                     challenge: GrandProductChallenge) -> np.ndarray:
    """Inclusive prefix product of filtered combined rows (ctl.rs:284-311)."""
    degree = trace.shape[1]
    if filter_column is not None:
        filt = filter_column.eval_table(trace)
        bad = (filt != 0) & (filt != 1)
        if bad.any():
            raise ValueError("non-binary CTL filter")
    else:
        filt = np.ones(degree, dtype=np.uint64)
    evals = [col.eval_table(trace) for col in columns]
    combined = challenge.combine_vec(evals)
    terms = np.where(filt == 1, combined, np.uint64(1))
    return g.prefix_prod_mod(terms)


def cross_table_lookup_data(config, trace_poly_values: list[np.ndarray],
                            cross_table_lookups: list[CrossTableLookup],
                            challenger) -> list[CtlData]:
    """ctl.rs:224-282. Consumes CTL challenges from the challenger."""
    challenges = get_grand_product_challenge_set(challenger, config.num_challenges)
    num_tables = len(trace_poly_values)
    ctl_data_per_table = [CtlData() for _ in range(num_tables)]
    for ctl in cross_table_lookups:
        for challenge in challenges:
            zs_looking = [
                partial_products(
                    trace_poly_values[t.table], t.columns, t.filter_column, challenge
                )
                for t in ctl.looking_tables
            ]
            z_looked = partial_products(
                trace_poly_values[ctl.looked_table.table],
                ctl.looked_table.columns,
                ctl.looked_table.filter_column,
                challenge,
            )
            prod_looking = 1
            for z in zs_looking:
                prod_looking = g.mul(prod_looking, int(z[-1]))
            if prod_looking != int(z_looked[-1]):
                idx = cross_table_lookups.index(ctl)
                raise AssertionError(
                    f"CTL #{idx} product mismatch (trace inconsistency):\n"
                    + debug_ctl_mismatch(trace_poly_values, ctl)
                )
            for t, z in zip(ctl.looking_tables, zs_looking):
                ctl_data_per_table[t.table].zs_columns.append(
                    CtlZData(z, challenge, t.columns, t.filter_column)
                )
            ctl_data_per_table[ctl.looked_table.table].zs_columns.append(
                CtlZData(
                    z_looked, challenge, ctl.looked_table.columns,
                    ctl.looked_table.filter_column,
                )
            )
    return ctl_data_per_table


@dataclass
class CtlCheckVars:
    local_z: object
    next_z: object
    challenges: GrandProductChallenge
    columns: list[Column]
    filter_column: Optional[Column]


def ctl_check_vars_from_proofs(proofs, cross_table_lookups, ctl_challenges,
                               num_permutation_zs: list[int]) -> list[list[CtlCheckVars]]:
    """ctl.rs:330-377: distribute opened Z values back to per-table vars."""
    num_tables = len(proofs)
    iters = []
    for p, num_perms in zip(proofs, num_permutation_zs):
        zs = p.openings.permutation_ctl_zs[num_perms:]
        zs_next = p.openings.permutation_ctl_zs_next[num_perms:]
        iters.append(iter(list(zip(zs, zs_next))))
    out = [[] for _ in range(num_tables)]
    for ctl in cross_table_lookups:
        for challenge in ctl_challenges:
            for t in ctl.looking_tables:
                z, zn = next(iters[t.table])
                out[t.table].append(
                    CtlCheckVars(z, zn, challenge, t.columns, t.filter_column)
                )
            lt = ctl.looked_table
            z, zn = next(iters[lt.table])
            out[lt.table].append(
                CtlCheckVars(z, zn, challenge, lt.columns, lt.filter_column)
            )
    return out


def eval_cross_table_lookup_checks(local, nxt, ctl_vars: list[CtlCheckVars],
                                   consumer):
    """ctl.rs:380-422."""
    F = consumer.F
    for v in ctl_vars:
        def combine(vals):
            evals = [c.eval_ops(F, vals) for c in v.columns]
            return v.challenges.combine_ops(F, evals)

        def filt(vals):
            if v.filter_column is not None:
                return v.filter_column.eval_ops(F, vals)
            return F.constant(1)

        def select(f, x):
            return F.add(F.sub(F.mul(f, x), f), F.constant(1))

        local_filter = filt(local)
        next_filter = filt(nxt)
        consumer.constraint_first_row(
            F.sub(v.local_z, select(local_filter, combine(local)))
        )
        consumer.constraint_transition(
            F.sub(v.next_z, F.mul(v.local_z, select(next_filter, combine(nxt))))
        )


def verify_cross_table_lookups(cross_table_lookups, ctl_zs_lasts: list[list[int]],
                               config):
    """ctl.rs:551-585: final Z-product equality across tables."""
    iters = [iter(v) for v in ctl_zs_lasts]
    for ctl in cross_table_lookups:
        for _ in range(config.num_challenges):
            prod = 1
            for t in ctl.looking_tables:
                prod = g.mul(prod, int(next(iters[t.table])))
            looked = int(next(iters[ctl.looked_table.table]))
            if prod != looked:
                raise ValueError("cross-table lookup verification failed")
    for it in iters:
        assert next(it, None) is None


def ctl_rows(trace: np.ndarray, twc: TableWithColumns) -> list[tuple]:
    """Filtered (filter==1) rows of a CTL view as value tuples — the
    reference's ctl_test printers (circuits/src/generation/ctl_test/)."""
    degree = trace.shape[1]
    if twc.filter_column is not None:
        filt = twc.filter_column.eval_table(trace)
    else:
        filt = np.ones(degree, dtype=np.uint64)
    evals = [col.eval_table(trace) for col in twc.columns]
    out = []
    for r in range(degree):
        if int(filt[r]) == 1:
            out.append(tuple(int(e[r]) for e in evals))
    return out


def debug_ctl_mismatch(trace_poly_values, ctl: CrossTableLookup,
                       max_print: int = 8) -> str:
    """Multiset-diff the looking vs looked rows of one CTL."""
    from collections import Counter

    looking = Counter()
    for t in ctl.looking_tables:
        looking.update(ctl_rows(trace_poly_values[t.table], t))
    looked = Counter(
        ctl_rows(trace_poly_values[ctl.looked_table.table], ctl.looked_table)
    )
    only_looking = looking - looked
    only_looked = looked - looking
    lines = [
        f"  looking rows: {sum(looking.values())}, looked rows: "
        f"{sum(looked.values())}",
    ]
    for name, c in (("only-in-looking", only_looking),
                    ("only-in-looked", only_looked)):
        for row, cnt in list(c.items())[:max_print]:
            lines.append(f"  {name} x{cnt}: {row}")
        extra = len(c) - max_print
        if extra > 0:
            lines.append(f"  {name}: ... {extra} more distinct rows")
    return "\n".join(lines)
