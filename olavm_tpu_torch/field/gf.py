"""Goldilocks arithmetic on torch tensors; counterpart of olavm_tpu/field/gf.py.

A Goldilocks array is ONE int64 tensor holding the bit patterns of canonical
uint64 values (< p); values >= 2^63 read as negative int64. The TPU package's
(lo, hi) u32 pair exists only because the TPU has no 64-bit multiply.

On a CUDA tensor, `mul`, `add` and `sub` launch the hand-written kernels of
csrc/gf_mul.cu (K3 and its add/sub siblings), `inv` launches K7
(csrc/gf_inv.cu), `prefix_prod` K8 (csrc/scan.cu), `powers` (a power
table) K13 (csrc/powers.cu), `scale_powers` (x times a base's powers, the
coset scaling) gl_scale_powers (csrc/quotient.cu), and `eval_points` (every
polynomial at every point of a power table) K5, csrc/eval.cu. On
a CPU tensor they run the plain versions beside them (`mul_plain`, ...), which use only int64 torch
ops: torch has no add, shift or compare for uint64, so the plain versions
work on 32-bit limbs held in int64, mask after every `>>` (it sign-extends
on int64) and never form a product above 2^49, so nothing overflows. The
plain versions run on any device; they are what the kernels are held
against.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..field import goldilocks as g

from .. import kernels

P = g.P
M32 = 0xFFFFFFFF
M16 = 0xFFFF


# ---------------------------------------------------------------------------
# host <-> device
# ---------------------------------------------------------------------------


def from_u64(x, device, pinned: bool = False) -> torch.Tensor:
    """numpy uint64 (or int list) -> int64 tensor on `device`. With
    `pinned`, a copy to a card goes through page-locked memory and does not
    wait for the stream (a pageable copy does).

    Precondition: values are canonical (< p); they are copied, not reduced
    (as olavm_tpu/field/gf.py:47-52)."""
    a = np.ascontiguousarray(np.asarray(x, dtype=np.uint64))
    t = torch.from_numpy(a.view(np.int64).copy())
    if pinned and torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 array (same bits)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def _i64(value: int) -> int:
    """Canonical field value -> its int64 bit pattern."""
    value = int(value) % P
    return value - (1 << 64) if value >= 1 << 63 else value


def full(shape, value: int, device) -> torch.Tensor:
    return torch.full(shape, _i64(value), dtype=torch.int64, device=device)


def zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int64, device=device)


def ones(shape, device) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.int64, device=device)


def scalar(value: int, device) -> torch.Tensor:
    """0-dim field constant."""
    return full((), value, device)


# ---------------------------------------------------------------------------
# plain versions (int64 limbs; any device)
# ---------------------------------------------------------------------------


def _split(a):
    return a & M32, (a >> 32) & M32


def _join(lo, hi):
    return (hi << 32) | lo


def _canon(lo, hi):
    """Subtract p once if hi*2^32 + lo >= p (lo, hi < 2^32)."""
    ge = (hi == M32) & (lo >= 1)
    return torch.where(ge, lo - 1, lo), torch.where(ge, torch.zeros_like(hi), hi)


def add_plain(a, b):
    al, ah = _split(a)
    bl, bh = _split(b)
    lo = al + bl
    hi = ah + bh + (lo >> 32)
    lo = lo & M32
    carry = hi >> 32
    hi = hi & M32
    # 2^64 == EPSILON: fold the carry; a, b < p keeps this below p
    lo = lo + carry * M32
    hi = hi + (lo >> 32)
    lo = lo & M32
    return _join(*_canon(lo, hi))


def sub_plain(a, b):
    al, ah = _split(a)
    bl, bh = _split(b)
    lo = al - bl
    hi = ah - bh + (lo >> 32)  # arithmetic shift: borrow of -1
    lo = lo & M32
    borrow = (hi < 0).to(torch.int64)
    hi = hi & M32
    # a - b + 2^64 on borrow; a - b + p = that - EPSILON (never below 0)
    lo = lo - borrow * M32
    hi = hi + (lo >> 32)
    lo = lo & M32
    return _join(lo, hi)


def _mul32(x, y):
    """x * y for x, y < 2^32 as (lo32, hi32), partial products < 2^49."""
    t0 = x * (y & M16)
    t1 = x * (y >> 16)
    lo = t0 + ((t1 & M16) << 16)
    hi = (t1 >> 16) + (lo >> 32)
    return lo & M32, hi


def _reduce128(l0, l1, l2, l3):
    """(l3:l2:l1:l0) mod p with 2^64 == EPSILON, 2^96 == -1 (the reduction of
    olavm_tpu/field/gf.py:169): x_lo - l3 + l2 * EPSILON, then normalise."""
    lo = l0 - l3 - l2
    hi = l1 + l2 + (lo >> 32)
    lo = lo & M32
    # value in [-2^32, 2^65): add p if negative ...
    neg = (hi < 0).to(torch.int64)
    lo = lo + neg
    hi = hi + neg * M32 + (lo >> 32)
    lo = lo & M32
    # ... fold 2^64 into EPSILON if it reached 2^64 (then it is < p) ...
    carry = hi >> 32
    hi = hi & M32
    lo = lo + carry * M32
    hi = hi + (lo >> 32)
    lo = lo & M32
    # ... and subtract p once if it is still >= p
    return _join(*_canon(lo, hi))


def mul_plain(a, b):
    al, ah = _split(a)
    bl, bh = _split(b)
    ll_lo, ll_hi = _mul32(al, bl)
    lh_lo, lh_hi = _mul32(al, bh)
    hl_lo, hl_hi = _mul32(ah, bl)
    hh_lo, hh_hi = _mul32(ah, bh)
    s1 = ll_hi + lh_lo + hl_lo
    s2 = lh_hi + hl_hi + hh_lo + (s1 >> 32)
    l3 = hh_hi + (s2 >> 32)
    return _reduce128(ll_lo, s1 & M32, s2 & M32, l3)


# ---------------------------------------------------------------------------
# kernel wrappers: CPU tensors take the plain version, CUDA tensors the kernel
# ---------------------------------------------------------------------------

_BINOPS = {"gf_mul": "gl_mul", "gf_add": "gl_add", "gf_sub": "gl_sub"}


def _binop_cuda(name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch one element-wise kernel. A one-element operand is read with
    stride 0; other shape mismatches are broadcast into a contiguous copy."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if a.numel() == 1 and b.numel() != 1:
        sa, sb = 0, 1
        b = b.expand(shape).contiguous()
        a = a.contiguous()
    elif b.numel() == 1:
        sa, sb = 1, 0
        a = a.expand(shape).contiguous()
        b = b.contiguous()
    else:
        sa = sb = 1
        a = a.expand(shape).contiguous()
        b = b.expand(shape).contiguous()
    kernels.require_cuda_int64(a, b)
    out = torch.empty(shape, dtype=torch.int64, device=a.device)
    n = out.numel()
    if n == 0:
        return out
    fn = getattr(kernels.lib("gf_mul"), _BINOPS[name])
    kernels.check(fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, sa, sb,
                     kernels.stream_ptr(out)), name)
    kernels.count(name)
    return out


def _on_cuda(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    return a.device.type == "cuda"


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _on_cuda(a, b):
        return _binop_cuda("gf_mul", a, b)
    return mul_plain(a, b)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _on_cuda(a, b):
        return _binop_cuda("gf_add", a, b)
    return add_plain(a, b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _on_cuda(a, b):
        return _binop_cuda("gf_sub", a, b)
    return sub_plain(a, b)


# ---------------------------------------------------------------------------
# derived ops
# ---------------------------------------------------------------------------


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(scalar(0, a.device), a)


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def mul_u32(a: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by a small host constant (k < 2^32)."""
    return mul(a, scalar(k, a.device))


def exp_const(a: torch.Tensor, e: int) -> torch.Tensor:
    """a ** e for a host-known integer exponent (square-and-multiply)."""
    result = None
    base = a
    while e > 0:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    if result is None:
        return torch.ones_like(a)
    return result


def inv(a: torch.Tensor) -> torch.Tensor:
    """Element-wise a^(p-2) (0 maps to 0): K7 (csrc/gf_inv.cu, batch
    inversion, one launch) on a CUDA tensor, inv_plain on a CPU tensor."""
    if a.device.type != "cuda":
        return inv_plain(a)
    a = a.contiguous()
    kernels.require_cuda_int64(a)
    out = torch.empty_like(a)
    if a.numel():
        kernels.check(kernels.lib("gf_inv").gl_inv(
            a.data_ptr(), out.data_ptr(), a.numel(), kernels.stream_ptr(a)),
            "gf_inv")
        kernels.count("gf_inv")
    return out


def inv_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: a^(p-2) by square and multiply on mul_plain (63
    squarings and 62 products; 0 maps to 0)."""
    result, base, e = None, a, P - 2
    while e:
        if e & 1:
            result = base if result is None else mul_plain(result, base)
        e >>= 1
        if e:
            base = mul_plain(base, base)
    return result


def powers(base, n: int, device=None) -> torch.Tensor:
    """[1, b, b^2, ..., b^{n-1}]: K13 (csrc/powers.cu, one launch) on the
    card, powers_plain elsewhere. `base` is a 0-dim tensor (read on the
    device: a program can take it from an input), a (k,) tensor (a (k, n)
    table, one row a base) or a host int (made a 0-dim tensor on
    `device`)."""
    if not isinstance(base, torch.Tensor):
        base = scalar(base, device)
    if base.device.type != "cuda":
        return powers_plain(base, n)
    if base.dim() > 1:
        raise ValueError(f"powers: bases {tuple(base.shape)}, not () or (k,)")
    bases = base.reshape(-1).contiguous()
    kernels.require_cuda_int64(bases)
    out = torch.empty((*base.shape, n), dtype=torch.int64, device=base.device)
    if n and bases.numel():
        kernels.check(kernels.lib("powers").gl_powers(
            bases.data_ptr(), out.data_ptr(), bases.numel(), n,
            kernels.stream_ptr(out)), f"powers ({bases.numel()} x {n})")
        kernels.count("powers")
    return out


def powers_plain(base: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of K13: [1, b, ..., b^{n-1}] along a new last axis for
    every b of `base` (a 0-dim or (k,) tensor), by log-doubling on the plain
    product: the block [0, m) times b^m gives [m, 2m)."""
    out = torch.ones((*base.shape, 1), dtype=torch.int64, device=base.device)
    bm, length = base[..., None], 1
    while length < n:
        step = min(length, n - length)
        out = torch.cat([out, mul_plain(out[..., :step], bm)], dim=-1)
        length += step
        if length < n:
            bm = mul_plain(bm, bm)
    return out[..., :n]


def scale_powers(x: torch.Tensor, base, factor: int = 1) -> torch.Tensor:
    """x[c, i] * factor * base^i over a (C, n) array: gl_scale_powers
    (csrc/quotient.cu, one launch) on a CUDA tensor, scale_powers_plain on
    a CPU one. `base` is a one-element tensor (read on the device, so a
    program can take it from an input) or a host int (by value), `factor`
    a host constant (static in a program)."""
    if x.device.type != "cuda":
        return scale_powers_plain(x, base, factor)
    if x.dim() != 2:
        raise ValueError(f"scale_powers: {tuple(x.shape)}, not (C, n)")
    x = x.contiguous()
    if isinstance(base, torch.Tensor):
        base = base.reshape(1).contiguous()
        kernels.require_cuda_int64(x, base)
        ptr, value = base.data_ptr(), 0
    else:
        kernels.require_cuda_int64(x)
        ptr, value = None, int(base) % P
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    kernels.check(kernels.lib("quotient").gl_scale_powers(
        x.data_ptr(), out.data_ptr(), ptr, value, factor % P, x.shape[0],
        x.shape[1], kernels.stream_ptr(x)), "scale_powers")
    kernels.count("scale_powers")
    return out


def scale_powers_plain(x: torch.Tensor, base, factor: int = 1
                       ) -> torch.Tensor:
    """Plain version of gl_scale_powers: the power table by log-doubling
    (powers_plain), times the factor, times x."""
    if not isinstance(base, torch.Tensor):
        base = scalar(base, x.device)
    pows = powers_plain(base.reshape(()), x.shape[-1])
    return mul_plain(x, mul_plain(pows, scalar(factor, x.device)))


def sum_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """Modular sum over the leading axis, as a tree of pairwise adds (few
    torch calls: a plain version's time is their count)."""
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        pairs = add_plain(x[:half], x[half:2 * half])
        x = torch.cat([pairs, x[2 * half:]]) if x.shape[0] % 2 else pairs
    return x[0]


def sum_reduce(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Modular sum along a dimension (log-depth pairwise halving)."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        x = add(x[..., 0::2], x[..., 1::2])
    return x[..., 0]


def power_rows(bases, n: int, device) -> torch.Tensor:
    """(k, n) table [1, x, ..., x^{n-1}] of each host-known base x, by
    log-doubling: the row block [0, m) times x^m gives [m, 2m), each x^m
    copied from the host (ntt.twiddles' first build of a size; powers
    makes every other table on the card)."""
    xs = [int(x) % P for x in bases]
    out = ones((len(xs), 1), device)
    length = 1
    while length < n:
        step = min(length, n - length)
        shift = from_u64([pow(x, length, P) for x in xs], device)[:, None]
        out = torch.cat([out, mul(out[:, :step], shift)], dim=1)
        length += step
    return out[:, :n]


# K5's register tile and staging (csrc/eval_tile.cuh, held equal by
# tests/test_torch_eval.py): RC columns x RT points per thread, sub-tiles
# of TERMS terms in rows of STRIDE words, STAGES deep, at most MAX_THREADS
# threads and 32 points per block
EVAL_RC, EVAL_RT = 2, 4
EVAL_TERMS, EVAL_STRIDE, EVAL_STAGES = 64, 66, 2
EVAL_MAX_THREADS = 512
EVAL_MAX_POINTS = 32


@dataclass(frozen=True)
class EvalPlan:
    """One launch of K5: blocks of `cols` columns x `points` points x
    `chunk_len` terms on a grid of (chunks, column groups, point groups),
    (cols / RC) * (points / RT) * slices threads each."""
    cols: int
    points: int
    slices: int
    chunk_len: int
    grid: tuple
    threads: int
    smem_bytes: int


def eval_plan(C: int, n: int, k: int, sms: int, resident) -> EvalPlan:
    """K5's launch for (C, n) coefficients at k points on a card of `sms`
    SMs: the fewest column and point groups whose tiles fit a block (more
    column groups where n has fewer sub-tiles than the card has SMs), term
    slices while a block has threads to spare (k <= 4), and chunks of whole
    sub-tiles, as many as one wave holds: `resident(threads, smem_bytes)`
    blocks on every SM (the card's occupancy of K5, `_eval_resident`)."""
    subtiles = -(-n // EVAL_TERMS)
    tp = -(-k // (-(-k // EVAL_MAX_POINTS) * EVAL_RT))
    col_tiles = -(-C // EVAL_RC)
    groups = max(-(-col_tiles * tp // EVAL_MAX_THREADS),
                 min(col_tiles, -(-sms // subtiles)))
    tc = -(-col_tiles // groups)
    slices = 1
    while (2 * slices <= min(32, EVAL_TERMS // 2)
           and 2 * slices * tc * tp <= EVAL_MAX_THREADS):
        slices *= 2
    cols, points, threads = tc * EVAL_RC, tp * EVAL_RT, tc * tp * slices
    # the row table (rounded to 16 bytes) and the staged sub-tiles
    smem = 8 * ((cols + points + 1) // 2 * 2
                + EVAL_STAGES * (cols + points) * EVAL_STRIDE)
    col_groups, point_groups = -(-C // cols), -(-k // points)
    blocks = max(1, resident(threads, smem) * sms // (col_groups * point_groups))
    chunk_len = -(-subtiles // min(blocks, subtiles)) * EVAL_TERMS
    return EvalPlan(cols, points, slices, chunk_len,
                    (-(-n // chunk_len), col_groups, point_groups), threads,
                    smem)


@functools.lru_cache(maxsize=None)
def eval_plan_on(device, C: int, n: int, k: int) -> EvalPlan:
    """eval_plan for the card `device`."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return eval_plan(C, n, k, sms, _eval_resident)


def _eval_resident(threads: int, smem_bytes: int) -> int:
    """Blocks of K5 of this size that one SM of the card holds at once."""
    blocks = ctypes.c_int()
    kernels.check(kernels.lib("eval").gl_eval_occupancy(
        threads, smem_bytes, ctypes.byref(blocks)), "eval_points occupancy")
    return blocks.value


def eval_points(coeffs: torch.Tensor, pows: torch.Tensor) -> torch.Tensor:
    """Dot products of the rows of (C, n) coefficients with the rows of (k,
    n) power tables -> (k, C): every polynomial at every point. K5
    (csrc/eval.cu, one launch for any k) on CUDA tensors, the plain version
    on CPU tensors."""
    (C, n), k = coeffs.shape, pows.shape[0]
    if pows.shape[1] != n:
        raise ValueError(f"coefficients {tuple(coeffs.shape)} against powers "
                         f"{tuple(pows.shape)}")
    if not _on_cuda(coeffs, pows):
        return eval_points_plain(coeffs, pows)
    coeffs, pows = coeffs.contiguous(), pows.contiguous()
    kernels.require_cuda_int64(coeffs, pows)
    out = torch.empty((k, C), dtype=torch.int64, device=coeffs.device)
    if C == 0 or k == 0:
        return out
    plan = eval_plan_on(coeffs.device, C, n, k)
    # the chunks' partial sums (one chunk writes `out` itself)
    part = out if plan.grid[0] == 1 else torch.empty(
        (plan.grid[0], k, C), dtype=torch.int64, device=coeffs.device)
    kernels.check(kernels.lib("eval").gl_eval_points(
        coeffs.data_ptr(), pows.data_ptr(), part.data_ptr(), out.data_ptr(),
        n, C, k, plan.cols, plan.points, plan.slices, plan.chunk_len,
        kernels.stream_ptr(coeffs)), "eval_points")
    kernels.count("eval_points")
    return out


def eval_points_plain(coeffs: torch.Tensor, pows: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: per point, the product array and a pairwise sum."""
    return torch.stack([_sum_plain(mul_plain(coeffs, row[None, :]))
                        for row in pows])


def _sum_plain(x: torch.Tensor) -> torch.Tensor:
    """sum_reduce over the last axis with the plain add."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        x = add_plain(x[..., 0::2], x[..., 1::2])
    return x[..., 0]


def prefix_prod(x: torch.Tensor, dim: int = -1, exclusive: bool = False,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """Modular prefix product along `dim`: inclusive, or with `exclusive`
    [1, x_0, x_0 x_1, ...] (the last product dropped), written into `out`
    (x's shape; `out` may be x itself: a scan in place) or a new tensor.
    K8 (csrc/scan.cu, one launch over every row and one fill of its
    scratch's counter and flags) on a CUDA tensor, prefix_prod_plain on a
    CPU tensor."""
    if out is not None and out.shape != x.shape:
        raise ValueError(f"prefix_prod: out {tuple(out.shape)} for x "
                         f"{tuple(x.shape)}")
    if x.device.type != "cuda":
        y = prefix_prod_plain(x, dim, exclusive)
        return y if out is None else out.copy_(y)
    y = x.movedim(dim, -1).contiguous()
    kernels.require_cuda_int64(y)
    if out is None:
        dst = torch.empty_like(y)
    else:
        dst = out.movedim(dim, -1)
        kernels.require_cuda_int64(dst)
    n = y.shape[-1]
    rows = y.numel() // n if n else 0
    if rows:
        lib = kernels.lib("scan")
        # the tiles' counter and flags zeroed in the stream (a program's
        # capture records the fill); their products and prefixes are
        # written before their flags
        state = torch.empty(lib.gl_prefix_prod_state_words(rows, n),
                            dtype=torch.int64, device=y.device)
        state[:lib.gl_prefix_prod_zeroed_words(rows, n)].zero_()
        kernels.check(lib.gl_prefix_prod(
            y.data_ptr(), dst.data_ptr(), state.data_ptr(), state.numel(),
            rows, n, int(exclusive), kernels.stream_ptr(y)), "prefix_prod")
        kernels.count("prefix_prod")
    return dst.movedim(-1, dim) if out is None else out


def prefix_prod_plain(x: torch.Tensor, dim: int = -1,
                      exclusive: bool = False) -> torch.Tensor:
    """Plain version of K8: log depth (Hillis-Steele scan on mul_plain, as
    olavm_tpu/field/gf.py:317); the exclusive form shifts the inclusive
    one a place and puts 1 first."""
    y = x.movedim(dim, -1)
    n = y.shape[-1]
    d = 1
    while d < n:
        shifted = torch.cat([torch.ones_like(y[..., :d]), y[..., :-d]], dim=-1)
        y = mul_plain(y, shifted)
        d <<= 1
    if exclusive:
        y = torch.cat([torch.ones_like(y[..., :1]), y[..., :-1]], dim=-1)
    return y.movedim(-1, dim)


def select(pred: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(pred, a, b)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a == b
