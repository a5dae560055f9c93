"""Grand products on the device: CTL Z polynomials and permutation-argument Z
polynomials; counterpart of olavm_tpu/stark/ctl_device.py
(circuits/src/stark/cross_table_lookup.rs:224-311, permutation.rs:103-160).

The reference's row-by-row cumulative product is the log-depth scan
gf.prefix_prod, filters are selects, and the denominators of the
permutation argument are inverted element-wise. Challenges stay host ints
and enter the products as 0-dim tensors. The scan stays plain torch in this
version (its products launch K3 on the card); a scan kernel is later work.
"""

from __future__ import annotations

import torch

from ..field import goldilocks as g
from ..stark.cross_table_lookup import Column, CtlData, CtlZData
from ..stark.stark_base import (
    get_grand_product_challenge_set,
    get_permutation_batches,
)

from ..field import gf
from .ops import TorchOps


def _column_eval(col: Column, trace: torch.Tensor, F: TorchOps) -> torch.Tensor:
    """Column linear combination over a (C, N) table -> (N,)."""
    acc = gf.full((trace.shape[1],), col.constant % g.P, trace.device)
    for c, k in col.linear_combination:
        acc = gf.add(acc, F.scalar_mul(trace[c], k))
    return acc


def ctl_z_device(trace: torch.Tensor, columns: list[Column], filter_column,
                 challenge) -> torch.Tensor:
    """Inclusive prefix product of the filtered combined rows; challenge is
    the host GrandProductChallenge."""
    F = TorchOps(trace.device)
    n = trace.shape[1]
    one = gf.ones((n,), trace.device)
    evals = [_column_eval(col, trace, F) for col in columns]
    combined = challenge.combine_ops(F, evals)
    if filter_column is not None:
        filt = _column_eval(filter_column, trace, F)
        combined = gf.select(gf.eq(filt, one), combined.expand(n), one)
    return gf.prefix_prod(combined.expand(n))


def ctl_data_device(config, values_dev: list[torch.Tensor],
                    cross_table_lookups, challenger) -> list[CtlData]:
    """Device cross_table_lookup_data: per-table CtlData whose z arrays are
    device tensors. Draws the CTL challenges exactly like the host path
    (cross_table_lookup.rs:224-282) and checks looking/looked products."""
    challenges = get_grand_product_challenge_set(
        challenger, config.num_challenges)
    ctl_data_per_table = [CtlData() for _ in values_dev]

    pending = []  # (challenge, table view, z) in append order
    for ctl in cross_table_lookups:
        for challenge in challenges:
            for t in list(ctl.looking_tables) + [ctl.looked_table]:
                z = ctl_z_device(values_dev[t.table], t.columns,
                                 t.filter_column, challenge)
                pending.append((challenge, t, z))

    z_last = gf.to_u64(torch.stack([z[-1] for (_, _, z) in pending]))

    i = 0
    for ctl_idx, ctl in enumerate(cross_table_lookups):
        for _ in challenges:
            k = len(ctl.looking_tables) + 1
            group, zl = pending[i:i + k], z_last[i:i + k]
            i += k
            prod_looking = 1
            for v in zl[:-1]:
                prod_looking = g.mul(prod_looking, int(v))
            if prod_looking != int(zl[-1]):
                raise AssertionError(
                    f"CTL #{ctl_idx} product mismatch (trace inconsistency)")
            for chal, t, z in group:
                ctl_data_per_table[t.table].zs_columns.append(
                    CtlZData(z, chal, t.columns, t.filter_column))
    return ctl_data_per_table


def permutation_z_polys_device(stark, config, trace: torch.Tensor,
                               challenge_sets) -> list[torch.Tensor]:
    """Per permutation batch, Z = exclusive prefix product of num/den over
    rows (permutation.rs:103)."""
    pairs = stark.permutation_pairs()
    if not pairs:
        return []
    batches = get_permutation_batches(
        pairs, challenge_sets, config.num_challenges,
        stark.permutation_batch_size())
    n = trace.shape[1]
    device = trace.device
    out = []
    for instances in batches:
        num = gf.ones((n,), device)
        den = gf.ones((n,), device)
        for pair, chal in instances:
            beta = gf.scalar(chal.beta, device)
            lhs = gf.full((n,), chal.gamma, device)
            rhs = lhs
            w = gf.scalar(1, device)
            for a, b in pair.column_pairs:
                lhs = gf.add(lhs, gf.mul(trace[a], w))
                rhs = gf.add(rhs, gf.mul(trace[b], w))
                w = gf.mul(w, beta)
            num = gf.mul(num, lhs)
            den = gf.mul(den, rhs)
        zfull = gf.prefix_prod(gf.mul(num, gf.inv(den)))
        out.append(torch.cat([gf.ones((1,), device), zfull[:-1]]))
    return out
