"""Grand products on the device: CTL Z polynomials and permutation-argument Z
polynomials; counterpart of olavm_tpu/stark/ctl_device.py
(circuits/src/stark/cross_table_lookup.rs:224-311, permutation.rs:103-160).

A CTL Z's rows are combined by K11 (stark/ctl_kernels.py, csrc/ctl.cu:
every column's linear combination, their sum by powers of beta plus gamma,
and the filter, in one pass), the reference's row-by-row cumulative product
is gf.prefix_prod (on the card K8, csrc/scan.cu; the permutation Z's
exclusive form in the same kernel), and the denominators of the
permutation argument are inverted element-wise by gf.inv (K7,
csrc/gf_inv.cu). A table's grand products go through few programs
(utils/jitcache.py; a CUDA graph on the card), each of which the trace is
copied into once: the CTL Zs of a table in groups (ctl_groups; one for
every table at N=94000 but CpuStark, whose 78 Zs make three), each group
K11 into the rows of one (Z, n) array and one K8 launch over it; all the
permutation batches of a table in one, one K7 and one K8 launch over its
(batches, n) rows. The challenges enter a program as a device bank, an
input that is filled before each replay: no challenge is a host value
inside a program (a capture would bake it into a fill or a kernel
argument, and a replay would compute with an earlier prove's challenge).
A program is keyed by its views' column structures (with each view's
challenge index) or its batches' column pairs, and the trace's shape.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..field import goldilocks as g
from ..stark.consumer import _alpha_powers, _tree_sum
from ..stark.cross_table_lookup import CtlData, CtlZData
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


# a CTL group's (Z, n) array holds at most this many words (256 MB): a
# table's Zs go through one program, or through several where they would
# be larger, so that the group's output and its program's output buffer
# stay small beside the trace each program copies in
CTL_GROUP_WORDS = 1 << 25


def ctl_table_zs(trace: torch.Tensor, bank: torch.Tensor, views
                 ) -> tuple[torch.Tensor, ...]:
    """The CTL Zs of views of one table's (C, n) trace, each view (columns,
    filter column, challenge index) with its challenge's (beta, gamma) at
    bank[2 index:2 index + 2], as the rows of one (len(views), n) array: on
    the card one K11 launch a view, each into its row, then one K8 launch
    over the rows in place. Each Z is an output of its own, so that a
    program's replay hands out a copy of each Z (one copy of a group's size,
    held until the table is proved, can leave the caching allocator too
    fragmented for N=376000's largest commit on an 80 GB card)."""
    zs = torch.empty((len(views), trace.shape[1]), dtype=torch.int64,
                     device=trace.device)
    for row, (columns, filter_column, c) in zip(zs, views):
        ctl_kernels.ctl_combine(trace, columns, filter_column,
                                bank[2 * c:2 * c + 2], out=row)
    return tuple(gf.prefix_prod(zs, out=zs))


def _ctl_program(trace: torch.Tensor, views):
    """The program of one group of a table's CTL Zs on traces of this shape
    (olavm_tpu/stark/ctl_device.py:102,130 keys one per view structure):
    keyed by the views' column structures and challenge indices."""
    key = ("ctlz", tuple(trace.shape),
           tuple((tuple(column_sig(c) for c in columns),
                  column_sig(filter_column), ci)
                 for columns, filter_column, ci in views))
    return jitcache.cached_jit(key, lambda t, b: ctl_table_zs(t, b, views))


def ctl_groups(members: list, n: int) -> list[list]:
    """A table's Zs (`members`, in order) cut into groups of consecutive
    members, as few as keep a group's (Z, n) array within CTL_GROUP_WORDS,
    as even as they can be."""
    most = max(1, CTL_GROUP_WORDS // max(n, 1))
    k = -(-len(members) // most)
    cuts = [len(members) * i // k for i in range(k + 1)]
    return [members[lo:hi] for lo, hi in zip(cuts, cuts[1:])]


def ctl_data_device(config, values_dev: list[torch.Tensor],
                    cross_table_lookups, challenger) -> list[CtlData]:
    """Device cross_table_lookup_data: per-table CtlData whose z arrays are
    device tensors (rows of each table's group arrays). Draws the CTL
    challenges exactly like the host path (cross_table_lookup.rs:224-282),
    runs one program per group of a table's Zs (ctl_groups: the trace
    copied into a program once a group, not once a Z) and checks looking
    and looked products."""
    challenges = get_grand_product_challenge_set(
        challenger, config.num_challenges)
    ctl_data_per_table = [CtlData() for _ in values_dev]
    bank = gf.from_u64([v for c in challenges for v in (c.beta, c.gamma)],
                       values_dev[0].device)

    pending = []  # (challenge, table view, challenge index) in append order
    by_table: dict = {}  # table -> its members' places in pending
    for ctl in cross_table_lookups:
        for ci, challenge in enumerate(challenges):
            for t in list(ctl.looking_tables) + [ctl.looked_table]:
                by_table.setdefault(t.table, []).append(len(pending))
                pending.append((challenge, t, ci))

    zs: list = [None] * len(pending)
    for table, members in by_table.items():
        trace = values_dev[table]
        for group in ctl_groups(members, trace.shape[1]):
            views = tuple((pending[i][1].columns, pending[i][1].filter_column,
                           pending[i][2]) for i in group)
            for i, z in zip(group, _ctl_program(trace, views)(trace, bank)):
                zs[i] = z

    # the host read of every Z's last value stays outside the programs: one
    # read of them all
    z_last = [int(v) for v in gf.to_u64(torch.stack([z[-1] for z in zs]))]

    i = 0
    for ctl_idx, ctl in enumerate(cross_table_lookups):
        for _ in challenges:
            k = len(ctl.looking_tables) + 1
            group, zl = range(i, i + k), z_last[i:i + k]
            i += k
            prod_looking = 1
            for v in zl[:-1]:
                prod_looking = g.mul(prod_looking, v)
            if prod_looking != zl[-1]:
                raise AssertionError(
                    f"CTL #{ctl_idx} product mismatch (trace inconsistency)")
            for j in group:
                chal, t, _ = pending[j]
                ctl_data_per_table[t.table].zs_columns.append(
                    CtlZData(zs[j], chal, t.columns, t.filter_column))
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


def permutation_zs(trace: torch.Tensor, bank: torch.Tensor, meta
                   ) -> torch.Tensor:
    """(batches, n): each permutation batch's Z, the exclusive prefix
    product of num/den over rows (permutation.rs:103), with each instance's
    beta and gamma read from `bank` at its offset. Each batch's num and den
    chains are copied into their rows of two (batches, n) arrays; then one
    K7 launch over the denominators, one K3 and one exclusive K8 launch
    over the rows, in place. The caller takes each row as an output of its
    own (as ctl_table_zs does)."""
    n = trace.shape[1]
    device = trace.device
    num = torch.empty((len(meta), n), dtype=torch.int64, device=device)
    den = torch.empty_like(num)
    for row, instances in enumerate(meta):
        acc_num = gf.ones((n,), device)
        acc_den = gf.ones((n,), device)
        for column_pairs, off in instances:
            beta, gamma = bank[off], bank[off + 1]
            lhs = rhs = gamma
            w = gf.ones((), device)
            for a, b in column_pairs:
                lhs = gf.add(lhs, gf.mul(trace[a], w))
                rhs = gf.add(rhs, gf.mul(trace[b], w))
                w = gf.mul(w, beta)
            acc_num = gf.mul(acc_num, lhs)
            acc_den = gf.mul(acc_den, rhs)
        num[row] = acc_num
        den[row] = acc_den
    ratio = gf.mul(num, gf.inv(den))
    return gf.prefix_prod(ratio, exclusive=True, out=ratio)


def permutation_z_polys_device(stark, config, trace: torch.Tensor,
                               challenge_sets) -> list[torch.Tensor]:
    """Per permutation batch, Z = exclusive prefix product of num/den over
    rows (permutation.rs:103); one program for all of a table's batches
    (olavm_tpu/stark/ctl_device.py:232 keys one a batch), reading the
    challenges from a bank."""
    if not stark.permutation_pairs():
        return []
    values, offset = permutation_bank(challenge_sets)
    meta = permutation_meta(stark, config, challenge_sets, offset)
    bank = gf.from_u64(values, trace.device)
    key = ("permz", type(stark).__module__, type(stark).__qualname__,
           tuple(trace.shape), meta)
    prog = jitcache.cached_jit(
        key, lambda t, b: tuple(permutation_zs(t, b, meta)))
    return list(prog(trace, bank))
