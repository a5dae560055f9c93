"""The row combination of a CTL Z, K11 (csrc/ctl.cu), with its plain version.

For one view of a cross-table lookup (its columns, each a linear
combination of trace columns plus a constant, and an optional filter
column) and the (2,) device bank [beta, gamma], each row j of the trace
gives

  v_j = sum_i col_i[j] beta^i + gamma   where the filter's value is 1,
  1                                    elsewhere (and v_j without a filter),

the input of the Z's grand product (gf.prefix_prod, K8); the counterpart of
olavm_tpu/stark/ctl_device.py:51-81.

On a CUDA tensor `ctl_combine` launches K11 or raises, naming the kernel
and the view; on a CPU tensor it runs `ctl_combine_plain`, the chain K11
replaced on the plain field ops (gf.*_plain). `ctl_combine_ops` is that
chain on the dispatching ops (TorchOps: on the card a K3, add, fill and
select launch each), the yardstick both are held to.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels
from ..field import gf
from ..field import goldilocks as g
from .consumer import _alpha_powers, _tree_sum
from .ops import TorchOps

# csrc/ctl.cu's limits of a view
MAX_SLOTS = 32
MAX_COLUMNS = 32
MAX_TERMS = 64
USE_VALUE, USE_FILTER = 1, 2


class _View(ctypes.Structure):
    _fields_ = [("slots", ctypes.c_int32), ("columns", ctypes.c_int32),
                ("terms", ctypes.c_int32), ("filtered", ctypes.c_int32),
                ("row", ctypes.c_int32 * MAX_SLOTS),
                ("use", ctypes.c_int32 * MAX_SLOTS),
                ("term_slot", ctypes.c_int32 * MAX_TERMS),
                ("term_column", ctypes.c_int32 * MAX_TERMS),
                ("term_k", ctypes.c_uint64 * MAX_TERMS),
                ("constant", ctypes.c_uint64 * MAX_COLUMNS),
                ("filter_k", ctypes.c_uint64 * MAX_SLOTS),
                ("filter_constant", ctypes.c_uint64)]


def column_sig(col):
    """A Column's structure, as a program key holds it."""
    if col is None:
        return None
    return tuple(col.linear_combination), col.constant


def view_name(columns, filter_column) -> str:
    """A view as its columns' terms and constants and its filter's."""
    return (f"columns {[column_sig(c) for c in columns]}, filter "
            f"{column_sig(filter_column)}")


@functools.lru_cache(maxsize=None)
def _view(columns_sig: tuple, filter_sig) -> _View:
    """K11's view parameter of a view's structure (column_sig of each
    column and of the filter): its distinct trace rows as slots, each
    column's terms on them with coefficients mod p, the constants mod p and
    the filter's coefficient a slot. Raises where the view exceeds
    csrc/ctl.cu's limits."""
    rows: list = []

    def slot(c):
        if c not in rows:
            rows.append(c)
        return rows.index(c)

    terms = [(slot(c), i, k % g.P) for i, (lc, _) in enumerate(columns_sig)
             for c, k in lc]
    fk: dict = {}
    if filter_sig is not None:
        for c, k in filter_sig[0]:
            s = slot(c)
            fk[s] = (fk.get(s, 0) + k) % g.P
    if (len(rows) > MAX_SLOTS or len(columns_sig) > MAX_COLUMNS
            or len(terms) > MAX_TERMS):
        raise ValueError(
            f"ctl_combine: the view ({len(rows)} distinct trace columns, "
            f"{len(columns_sig)} columns, {len(terms)} terms) exceeds "
            f"csrc/ctl.cu's {MAX_SLOTS}, {MAX_COLUMNS} and {MAX_TERMS}")
    v = _View()
    v.slots, v.columns, v.terms = len(rows), len(columns_sig), len(terms)
    v.filtered = int(filter_sig is not None)
    v.row[:len(rows)] = rows
    use = [0] * len(rows)
    for s, _, _ in terms:
        use[s] |= USE_VALUE
    for s in fk:
        use[s] |= USE_FILTER
    v.use[:len(rows)] = use
    if terms:
        v.term_slot[:len(terms)] = [s for s, _, _ in terms]
        v.term_column[:len(terms)] = [i for _, i, _ in terms]
        v.term_k[:len(terms)] = [k for _, _, k in terms]
    if columns_sig:
        v.constant[:len(columns_sig)] = [c % g.P for _, c in columns_sig]
    for s, k in fk.items():
        v.filter_k[s] = k
    v.filter_constant = filter_sig[1] % g.P if filter_sig is not None else 0
    return v


def view_params(columns, filter_column) -> _View:
    """K11's parameter of a view; raises, naming the view, where it exceeds
    csrc/ctl.cu's limits."""
    try:
        return _view(tuple(column_sig(c) for c in columns),
                     column_sig(filter_column))
    except ValueError as e:
        raise ValueError(f"{e}: {view_name(columns, filter_column)}") from None


# ---------------------------------------------------------------------------
# K11 and the chain it replaced
# ---------------------------------------------------------------------------


def ctl_combine(trace: torch.Tensor, columns, filter_column,
                beta_gamma: torch.Tensor,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """(n,): each row's sum_i col_i beta^i + gamma where the filter is 1, 1
    elsewhere, of a (C, n) trace and the (2,) bank [beta, gamma], written
    into `out` (an (n,) row, of a table's (Z, n) array, say) or a new
    tensor. K11 on CUDA tensors, ctl_combine_plain on CPU tensors."""
    n = trace.shape[-1]
    if out is not None and tuple(out.shape) != (n,):
        raise ValueError(f"ctl_combine: out {tuple(out.shape)} for a trace "
                         f"of {n} rows")
    if beta_gamma.device.type != "cuda":
        got = ctl_combine_plain(trace, columns, filter_column, beta_gamma)
        return got if out is None else out.copy_(got)
    trace, bank = trace.contiguous(), beta_gamma.contiguous()
    kernels.require_cuda_int64(trace, bank)
    v = view_params(columns, filter_column)
    if trace.dim() != 2 or bank.shape != (2,):
        raise ValueError(f"ctl_combine: trace {tuple(trace.shape)} and bank "
                         f"{tuple(bank.shape)}, not (C, n) and (2,)")
    if v.slots and max(v.row[:v.slots]) >= trace.shape[0]:
        raise ValueError(f"ctl_combine: the view reads past the trace's "
                         f"{trace.shape[0]} columns: "
                         f"{view_name(columns, filter_column)}")
    if out is None:
        out = torch.empty((n,), dtype=torch.int64, device=trace.device)
    kernels.require_cuda_int64(trace, out)
    kernels.check(kernels.lib("ctl").gl_ctl_combine(
        ctypes.addressof(v), trace.data_ptr(), bank.data_ptr(),
        out.data_ptr(), n, kernels.stream_ptr(trace)),
        f"ctl_combine ({view_name(columns, filter_column)})")
    kernels.count("ctl_combine")
    return out


class _PlainOps:
    """The field ops of the chain on the plain versions (TorchOps' rules
    for a host constant: 0 and 1 take no product)."""

    add = staticmethod(gf.add_plain)
    mul = staticmethod(gf.mul_plain)

    def __init__(self, device):
        self.device = device

    def constant(self, c: int):
        return gf.scalar(c, self.device)

    def scalar_mul(self, a, c: int):
        c = int(c) % g.P
        if c == 0:
            return torch.zeros_like(a)
        if c == 1:
            return a
        return gf.mul_plain(a, gf.scalar(c, a.device))


def _chain(F, trace, columns, filter_column, beta_gamma) -> torch.Tensor:
    """The row combination as the port ran it before K11: each column's
    linear combination (a fill, then a product by its coefficient and a sum
    a term), a power table of beta, a product a column, a tree sum, the add
    of gamma, and the filter's eq and select."""
    n = trace.shape[1]

    def column(col):
        acc = gf.full((n,), col.constant % g.P, trace.device)
        for c, k in col.linear_combination:
            acc = F.add(acc, F.scalar_mul(trace[c], k))
        return acc

    evals = [column(col) for col in columns]
    beta, gamma = beta_gamma[0], beta_gamma[1]
    if evals:
        pw = _alpha_powers(F, beta, len(evals) - 1)
        combined = F.add(_tree_sum(F, [t if i == 0 else F.mul(t, pw[i])
                                       for i, t in enumerate(evals)]), gamma)
    else:
        combined = gamma.expand(n)
    if filter_column is not None:
        one = gf.ones((n,), trace.device)
        combined = gf.select(gf.eq(column(filter_column), one), combined, one)
    return combined.expand(n).contiguous()


def ctl_combine_plain(trace: torch.Tensor, columns, filter_column,
                      beta_gamma: torch.Tensor) -> torch.Tensor:
    """Plain version of K11: the chain it replaced on the plain field ops."""
    return _chain(_PlainOps(trace.device), trace, columns, filter_column,
                  beta_gamma)


def ctl_combine_ops(trace: torch.Tensor, columns, filter_column,
                    beta_gamma: torch.Tensor) -> torch.Tensor:
    """The chain K11 replaced, op by op through TorchOps (on the card a K3,
    add, fill and select launch each): the yardstick."""
    return _chain(TorchOps(trace.device), trace, columns, filter_column,
                  beta_gamma)
