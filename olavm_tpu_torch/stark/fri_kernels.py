"""The FRI composition's two passes, K9 and K10, and the FRI fold, K12
(csrc/fri.cu), with their plain versions.

prove_openings_device forms, over the LDE coset,
F(x) = x * sum_b alpha^{suffix_b} (C_b(x) - y_b) / (x - z_b), with C_b the
alpha-combination of batch b's polynomials (prover_device.composition_bank
gives the static plan and the bank of challenge-derived values). It runs:

  fri_combine   (K9)  each batch's C_b on the coefficients, times shift^j,
                      zero-padded: the (B, 2, size) input of the coset LDE
  ntt           (K1)  one batched forward transform: every C_b on the coset
  fri_quotient  (K10) F(x_i) at every point x_i = shift * w^i of the coset

fri_fold (K12) folds the coefficients of a FRI round by arity, out[k] =
sum_i c[k arity + i] beta^i in the extension, in one launch.

On a CUDA tensor each wrapper launches its kernel or raises, naming the
kernel and the plan; on a CPU tensor it runs its plain version, which
repeats the kernel's arithmetic on the plain field ops (gf.*_plain) and runs
on any device. prover_device.fri_composition_ops and fri_fold_ops, the
earlier op-by-op chains, are the yardsticks they are held to.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels
from ..field import gf
from ..field import goldilocks as g
from ..field import gfe
from ..field.gfe import GFE, W
from ..ntt import ntt as dntt
from ..utils.bits import log2_strict

# csrc/fri.cu's limits of a plan, its K9 segment table and the bank words
# K9 holds in shared memory
MAX_ORACLES = 4
MAX_BATCHES = 4
MAX_SEGMENTS = 64
COMBINE_BANK = 1024
SHIFT = g.MULTIPLICATIVE_GROUP_GENERATOR


class _Segment(ctypes.Structure):
    _fields_ = [("oracle", ctypes.c_int32), ("first", ctypes.c_int32),
                ("count", ctypes.c_int32),
                ("re", ctypes.c_int32 * MAX_BATCHES),
                ("im", ctypes.c_int32 * MAX_BATCHES)]


class _CombinePlan(ctypes.Structure):
    _fields_ = [("oracles", ctypes.c_void_p * MAX_ORACLES),
                ("segments", ctypes.c_int32),
                ("nested", ctypes.c_int32),
                ("seg", _Segment * MAX_SEGMENTS)]


def nested(segs: tuple) -> bool:
    """Whether every segment that batch 1 reads, batch 0 reads with the same
    bank words (K9 then adds batch 1's sums into batch 0's once)."""
    return any(re[1] >= 0 for _, _, _, re, _ in segs) and all(
        re[0] == re[1] and im[0] == im[1]
        for _, _, _, re, im in segs if len(re) > 1 and re[1] >= 0)


class _QuotientPlan(ctypes.Structure):
    _fields_ = [("point", ctypes.c_int32 * MAX_BATCHES)]


@functools.lru_cache(maxsize=None)
def segments(plan: tuple) -> tuple:
    """K9's segment table of a composition plan: runs of consecutive rows of
    one oracle, each with, per batch, the bank offsets of its first row's
    alpha power (re, im; -1 where the batch does not read the rows), so that
    every row is read once for all the batches that use it. A batch that
    lists a row twice gets a segment of its own for the second listing."""
    by_oracle: dict = {}
    for b, (runs, _) in enumerate(plan):
        for oi, p0, k, roff in runs:
            by_oracle.setdefault(oi, []).append((b, p0, k, roff))
    out = []
    for oi in sorted(by_oracle):
        runs = by_oracle[oi]
        cuts = sorted({p for _, p0, k, _ in runs for p in (p0, p0 + k)})
        for lo, hi in zip(cuts, cuts[1:]):
            cover = [r for r in runs if r[1] <= lo and hi <= r[1] + r[2]]
            while cover:
                re, im, rest = [-1] * len(plan), [-1] * len(plan), []
                for b, p0, k, roff in cover:
                    if re[b] >= 0:
                        rest.append((b, p0, k, roff))
                        continue
                    re[b] = roff + lo - p0
                    im[b] = roff + k + lo - p0
                out.append((oi, lo, hi - lo, tuple(re), tuple(im)))
                cover = rest
    return tuple(out)


def _check_plan(plan: tuple, n_oracles: int) -> None:
    if not 1 <= len(plan) <= MAX_BATCHES or n_oracles > MAX_ORACLES:
        raise ValueError(f"FRI composition of {len(plan)} batches over "
                         f"{n_oracles} oracles: csrc/fri.cu takes 1 to "
                         f"{MAX_BATCHES} batches and {MAX_ORACLES} oracles")


def combine_params(coeffs, plan: tuple) -> _CombinePlan:
    """K9's plan parameter: the oracles' base pointers, the plan's segments
    and whether batch 1's rows nest in batch 0's."""
    _check_plan(plan, len(coeffs))
    segs = segments(plan)
    if len(segs) > MAX_SEGMENTS:
        raise ValueError(f"fri_combine: the plan {plan} has {len(segs)} "
                         f"segments, csrc/fri.cu takes {MAX_SEGMENTS}")
    p = _CombinePlan()
    for i, c in enumerate(coeffs):
        p.oracles[i] = c.data_ptr()
    p.segments = len(segs)
    p.nested = int(len(plan) > 1 and nested(segs))
    for s, (oi, first, count, re, im) in zip(p.seg, segs):
        s.oracle, s.first, s.count = oi, first, count
        s.re[:len(re)], s.im[:len(im)] = re, im
    return p


# ---------------------------------------------------------------------------
# K9: the alpha-combination, written as the coset LDE's input
# ---------------------------------------------------------------------------


def fri_combine(oracle_coeffs, bank: torch.Tensor, plan: tuple,
                rate_bits: int) -> torch.Tensor:
    """(B, 2, n << rate_bits): out[b][part][j] = shift^j * sum over batch
    b's rows r of alpha_{b,r}[part] * coeffs_r[j] for j < n, 0 above; the
    oracles' (C, n) coefficients, the composition bank and plan
    (prover_device.composition_bank). K9 on CUDA tensors, fri_combine_plain
    on CPU tensors."""
    if bank.device.type != "cuda":
        return fri_combine_plain(oracle_coeffs, bank, plan, rate_bits)
    coeffs = [c.contiguous() for c in oracle_coeffs]
    kernels.require_cuda_int64(bank, *coeffs)
    n = coeffs[0].shape[1]
    if any(c.dim() != 2 or c.shape[1] != n for c in coeffs):
        raise ValueError(f"fri_combine: oracles "
                         f"{[tuple(c.shape) for c in coeffs]}, not (C, {n})")
    p = combine_params(coeffs, plan)
    if bank.numel() > COMBINE_BANK:
        raise ValueError(f"fri_combine: a bank of {bank.numel()} words, "
                         f"csrc/fri.cu holds {COMBINE_BANK} (plan {plan})")
    size = n << rate_bits
    out = torch.empty((len(plan), 2, size), dtype=torch.int64,
                      device=bank.device)
    kernels.check(kernels.lib("fri").gl_fri_combine(
        ctypes.addressof(p), len(plan), bank.data_ptr(), bank.numel(),
        out.data_ptr(), n, size, SHIFT, kernels.stream_ptr(bank)),
        f"fri_combine (plan {plan})")
    kernels.count("fri_combine")
    return out


def fri_combine_plain(oracle_coeffs, bank: torch.Tensor, plan: tuple,
                      rate_bits: int) -> torch.Tensor:
    """Plain version of K9: per batch, each run's rows times their alpha
    powers and summed (re and im), the runs summed, times shift^j, padded."""
    device = bank.device
    n = oracle_coeffs[0].shape[1]
    out = gf.zeros((len(plan), 2, n << rate_bits), device)
    pows = gf.powers_plain(gf.scalar(SHIFT, device), n)
    for b, (runs, _) in enumerate(plan):
        acc = [gf.zeros((n,), device), gf.zeros((n,), device)]
        for oi, p0, k, roff in runs:
            rows = oracle_coeffs[oi][p0:p0 + k]
            for part in range(2):
                alphas = bank[roff + part * k:roff + (part + 1) * k]
                acc[part] = gf.add_plain(acc[part], gf.sum_rows_plain(
                    gf.mul_plain(rows, alphas[:, None])))
        for part in range(2):
            out[b, part, :n] = gf.mul_plain(acc[part], pows)
    return out


# ---------------------------------------------------------------------------
# K10: the quotient pass over the LDE
# ---------------------------------------------------------------------------


def fri_quotient(values: torch.Tensor, bank: torch.Tensor, plan: tuple
                 ) -> torch.Tensor:
    """(2, size): F * x at each point x_i = shift * w^i of the coset, F the
    sum over the plan's batches, in order, of F <- F * alpha^{len_b} +
    (v_b - y_b) / (x - z_b), from each batch's (B, 2, size) LDE values and
    the bank. K10 on CUDA tensors, fri_quotient_plain on CPU tensors."""
    if bank.device.type != "cuda":
        return fri_quotient_plain(values, bank, plan)
    _check_plan(plan, 0)
    values = values.contiguous()
    kernels.require_cuda_int64(values, bank)
    size = values.shape[-1]
    if tuple(values.shape) != (len(plan), 2, size):
        raise ValueError(f"fri_quotient: values {tuple(values.shape)}, not "
                         f"({len(plan)}, 2, size)")
    if size < 2:
        raise ValueError(f"fri_quotient: a coset of {size} points; "
                         f"csrc/fri.cu takes 2 or more")
    out = torch.empty((2, size), dtype=torch.int64, device=values.device)
    p = _QuotientPlan()
    p.point[:len(plan)] = [off for _, off in plan]
    # the coset's points from K1's twiddles of its size: w^j, j < size / 2
    # (w^{size/2} = -1 gives the other half)
    tw = dntt.twiddles(log2_strict(size), False, values.device)
    kernels.check(kernels.lib("fri").gl_fri_quotient(
        ctypes.addressof(p), len(plan), values.data_ptr(), bank.data_ptr(),
        tw.data_ptr(), out.data_ptr(), size, SHIFT, g.P - 1,
        kernels.stream_ptr(values)), f"fri_quotient (plan {plan})")
    kernels.count("fri_quotient")
    return out


def fri_quotient_plain(values: torch.Tensor, bank: torch.Tensor, plan: tuple
                       ) -> torch.Tensor:
    """Plain version of K10 on the coset of the values' size."""
    size = values.shape[-1]
    return quotient_plain(values, bank, [off for _, off in plan], SHIFT,
                          g.primitive_root_of_unity(log2_strict(size)))


def quotient_plain(values: torch.Tensor, bank: torch.Tensor, points,
                   shift: int, omega: int) -> torch.Tensor:
    """K10's arithmetic at x_i = shift * omega^i for any omega and size:
    1/(x - z) as (x - z_re + z_im phi) / N, the norm N = (x - z_re)^2 -
    7 z_im^2 inverted by gf.inv_plain (0 for 0), the quotient's numerator
    times the conjugate, then F * alpha^len + q; the bump F * x last."""
    device = values.device
    size = values.shape[-1]
    x = gf.mul_plain(gf.powers_plain(gf.scalar(omega, device), size),
                     gf.scalar(shift, device))
    seven = gf.scalar(W, device)
    f0 = f1 = None
    for b, off in enumerate(points):
        zr, zi, y0, y1, c0, c1 = (bank[off + k] for k in range(6))
        zi7 = gf.mul_plain(zi, seven)
        a = gf.sub_plain(x, zr)
        ninv = gf.inv_plain(gf.sub_plain(gf.mul_plain(a, a),
                                         gf.mul_plain(zi7, zi)))
        n0 = gf.sub_plain(values[b, 0], y0)
        n1 = gf.sub_plain(values[b, 1], y1)
        q0 = gf.mul_plain(gf.add_plain(gf.mul_plain(n0, a),
                                       gf.mul_plain(n1, zi7)), ninv)
        q1 = gf.mul_plain(gf.add_plain(gf.mul_plain(n0, zi),
                                       gf.mul_plain(n1, a)), ninv)
        if f0 is None:
            f0, f1 = q0, q1
            continue
        c17 = gf.mul_plain(c1, seven)
        f0, f1 = (gf.add_plain(gf.add_plain(gf.mul_plain(f0, c0),
                                            gf.mul_plain(f1, c17)), q0),
                  gf.add_plain(gf.add_plain(gf.mul_plain(f0, c1),
                                            gf.mul_plain(f1, c0)), q1))
    return torch.stack([gf.mul_plain(f0, x), gf.mul_plain(f1, x)])


# ---------------------------------------------------------------------------
# K12: the FRI fold
# ---------------------------------------------------------------------------

FOLD_ARITIES = (2, 4, 8, 16)


def fri_fold(re: torch.Tensor, im: torch.Tensor, bpows: torch.Tensor
             ) -> torch.Tensor:
    """(2, m / arity): the re and im parts of sum_i c[k * arity + i] beta^i
    for the (m,) re and im parts of the coefficients and the (2, arity)
    re and im parts of beta's powers (beta^0 = 1 not read). K12 on CUDA
    tensors, fri_fold_plain on CPU tensors."""
    if bpows.device.type != "cuda":
        return fri_fold_plain(re, im, bpows)
    arity = bpows.shape[1]
    re, im, bpows = re.contiguous(), im.contiguous(), bpows.contiguous()
    kernels.require_cuda_int64(re, im, bpows)
    if (arity not in FOLD_ARITIES or bpows.shape != (2, arity)
            or re.dim() != 1 or re.shape != im.shape
            or re.shape[0] % arity):
        raise ValueError(f"fri_fold: coefficients {tuple(re.shape)} and "
                         f"{tuple(im.shape)}, powers {tuple(bpows.shape)}: "
                         f"csrc/fri.cu folds (m,) vectors by an arity of "
                         f"{FOLD_ARITIES}")
    if re.data_ptr() % 16 or im.data_ptr() % 16:
        raise ValueError("fri_fold: csrc/fri.cu reads the coefficients with "
                         "16-byte loads; a slice must start 16-byte aligned")
    m = re.shape[0] // arity
    out = torch.empty((2, m), dtype=torch.int64, device=re.device)
    kernels.check(kernels.lib("fri").gl_fri_fold(
        re.data_ptr(), im.data_ptr(), bpows.data_ptr(), out.data_ptr(), m,
        arity, kernels.stream_ptr(re)), f"fri_fold (arity {arity}, {m} rows)")
    kernels.count("fri_fold")
    return out


def _ext_add_plain(a: GFE, b: GFE) -> GFE:
    return GFE(gf.add_plain(a.re, b.re), gf.add_plain(a.im, b.im))


def _fold_chain(mul, add, re, im, bpows) -> torch.Tensor:
    """The fold as the port ran it before K12: arity - 1 extension products
    and sums over strided columns."""
    arity = bpows.shape[1]
    re = re.reshape(-1, arity)
    im = im.reshape(-1, arity)
    acc = GFE(re[:, 0], im[:, 0])
    for i in range(1, arity):
        acc = add(acc, mul(GFE(re[:, i], im[:, i]),
                           GFE(bpows[0, i], bpows[1, i])))
    return torch.stack([acc.re, acc.im])


def fri_fold_plain(re: torch.Tensor, im: torch.Tensor, bpows: torch.Tensor
                   ) -> torch.Tensor:
    """Plain version of K12: the chain it replaced on the plain field ops."""
    return _fold_chain(gfe.mul_plain, _ext_add_plain, re, im, bpows)


def fri_fold_ops(re: torch.Tensor, im: torch.Tensor, bpows: torch.Tensor
                 ) -> torch.Tensor:
    """The chain K12 replaced, op by op through gfe (on the card 165 K3, add
    and sub launches at arity 16, with their fills and copies): the
    yardstick."""
    return _fold_chain(gfe.mul, gfe.add, re, im, bpows)
