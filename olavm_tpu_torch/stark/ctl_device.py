"""Grand products on the device: CTL Z polynomials and permutation-argument Z
polynomials; counterpart of olavm_tpu/stark/ctl_device.py
(circuits/src/stark/cross_table_lookup.rs:224-311, permutation.rs:103-160).

A CTL Z's rows are combined by K11 (stark/ctl_kernels.py, csrc/ctl.cu:
every column's linear combination, their sum by powers of beta plus gamma,
and the filter, in one pass), the reference's row-by-row cumulative product
is gf.prefix_prod (on the card one launch of K8, csrc/scan.cu; the
permutation Z's exclusive form in the same launch), and the denominators of
the permutation argument are inverted element-wise by gf.inv (K7,
csrc/gf_inv.cu). Each Z is one program
(utils/jitcache.py): a CUDA graph on the card, keyed by the view's column
structure and the trace's shape, replayed for every later view of that
structure. The challenges enter a program as a device bank, an input that
is filled before each replay, and are read through DevChallenge: no
challenge is a host value inside a program (a capture would bake it into a
fill or a kernel argument, and a replay would compute with an earlier
prove's challenge).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..field import goldilocks as g
from ..stark.consumer import _alpha_powers, _tree_sum
from ..stark.cross_table_lookup import Column, CtlData, CtlZData
from ..stark.stark_base import (
    get_grand_product_challenge_set,
    get_permutation_batches,
)
from ..utils import jitcache

from ..field import gf
from . import ctl_kernels
from .ctl_kernels import column_sig


@dataclass(frozen=True)
class DevChallenge:
    """A GrandProductChallenge whose beta and gamma are 0-dim device tensors
    (views of a challenge bank); olavm_tpu/stark/ctl_device.py:25-47.

    combine_ops computes sum_i terms[i] * beta^i + gamma as the host
    challenge's Horner does, but through a log-depth power table of beta and
    a tree sum: exact field arithmetic, so the same values, and every
    product takes beta as a tensor (GrandProductChallenge.combine_ops
    passes it to F.scalar_mul as a host int, which TorchOps turns into a
    fill, or into no product at all for 0 and 1)."""

    beta: torch.Tensor
    gamma: torch.Tensor

    def combine_ops(self, F, terms: list):
        if not terms:
            return self.gamma
        pw = _alpha_powers(F, self.beta, len(terms) - 1)
        scaled = [t if i == 0 else F.mul(t, pw[i])
                  for i, t in enumerate(terms)]
        return F.add(_tree_sum(F, scaled), self.gamma)


def ctl_z_device(trace: torch.Tensor, columns: list[Column], filter_column,
                 beta_gamma: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix product of the filtered combined rows; beta_gamma is
    the (2,) device bank [beta, gamma]: on the card one K11 launch (the row
    combination, stark/ctl_kernels.py) and one K8 launch."""
    return gf.prefix_prod(ctl_kernels.ctl_combine(trace, columns,
                                                  filter_column, beta_gamma))


def _ctl_z_program(trace: torch.Tensor, columns, filter_column):
    """The CTL Z program of one view structure on traces of this shape
    (olavm_tpu/stark/ctl_device.py:102,130): views with the same columns
    and filter share it."""
    key = ("ctlz", tuple(column_sig(c) for c in columns),
           column_sig(filter_column), tuple(trace.shape))
    return jitcache.cached_jit(
        key, lambda t, bg: ctl_z_device(t, columns, filter_column, bg))


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
            bg = gf.from_u64([challenge.beta, challenge.gamma],
                             values_dev[0].device)
            for t in list(ctl.looking_tables) + [ctl.looked_table]:
                trace = values_dev[t.table]
                z = _ctl_z_program(trace, t.columns, t.filter_column)(trace, bg)
                pending.append((challenge, t, z))

    # the host read of every Z's last value stays outside the programs
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


def permutation_bank(challenge_sets) -> tuple[list[int], dict]:
    """The distinct permutation challenges as a flat [beta, gamma, ...]
    list, and each challenge's (by identity) offset into it
    (olavm_tpu/stark/ctl_device.py:206-218)."""
    values, offset = [], {}
    for cs in challenge_sets:
        for c in cs:
            if id(c) not in offset:
                offset[id(c)] = len(values)
                values.extend([c.beta, c.gamma])
    return values, offset


def permutation_meta(stark, config, challenge_sets, offset: dict) -> tuple:
    """Per permutation batch, ((column pairs, bank offset), ...): what a
    program needs of the batches, with the challenges as bank offsets."""
    batches = get_permutation_batches(
        stark.permutation_pairs(), challenge_sets, config.num_challenges,
        stark.permutation_batch_size())
    return tuple(tuple((tuple(pair.column_pairs), offset[id(chal)])
                       for pair, chal in instances) for instances in batches)


def permutation_z(trace: torch.Tensor, bank: torch.Tensor, instances
                  ) -> torch.Tensor:
    """Z of one permutation batch, the exclusive prefix product of num/den
    over rows (permutation.rs:103), with each instance's beta and gamma read
    from `bank` at its offset."""
    n = trace.shape[1]
    device = trace.device
    num = gf.ones((n,), device)
    den = gf.ones((n,), device)
    for column_pairs, off in instances:
        beta, gamma = bank[off], bank[off + 1]
        lhs = rhs = gamma
        w = gf.ones((), device)
        for a, b in column_pairs:
            lhs = gf.add(lhs, gf.mul(trace[a], w))
            rhs = gf.add(rhs, gf.mul(trace[b], w))
            w = gf.mul(w, beta)
        num = gf.mul(num, lhs)
        den = gf.mul(den, rhs)
    return gf.prefix_prod(gf.mul(num, gf.inv(den)), exclusive=True)


def permutation_z_polys_device(stark, config, trace: torch.Tensor,
                               challenge_sets) -> list[torch.Tensor]:
    """Per permutation batch, Z = exclusive prefix product of num/den over
    rows (permutation.rs:103); one program per batch, keyed as
    olavm_tpu/stark/ctl_device.py:232 keys it, reading the challenges from
    a bank."""
    if not stark.permutation_pairs():
        return []
    values, offset = permutation_bank(challenge_sets)
    meta = permutation_meta(stark, config, challenge_sets, offset)
    bank = gf.from_u64(values, trace.device)
    out = []
    for bidx, instances in enumerate(meta):
        key = ("permz", type(stark).__module__, type(stark).__qualname__,
               tuple(trace.shape), bidx, instances)
        prog = jitcache.cached_jit(
            key, lambda t, b, m=instances: permutation_z(t, b, m))
        out.append(prog(trace, bank))
    return out
