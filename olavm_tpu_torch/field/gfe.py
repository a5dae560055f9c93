"""Quadratic extension GF(p^2) on torch tensors; counterpart of
olavm_tpu/field/gfe.py. An element is (re, im) = re + im*phi with phi^2 = 7
(plonky2 goldilocks_extensions.rs, W = 7); both parts are gf arrays."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import gf
from .. import kernels

W = 7


class GFE(NamedTuple):
    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self):
        return self.re.shape

    def __getitem__(self, idx):
        return GFE(self.re[idx], self.im[idx])


def from_base(a: torch.Tensor) -> GFE:
    return GFE(a, torch.zeros_like(a))


def from_u64_pair(pair, device) -> GFE:
    """Host (..., 2) u64 array -> GFE on `device`."""
    arr = np.asarray(pair, dtype=np.uint64)
    return GFE(gf.from_u64(arr[..., 0], device), gf.from_u64(arr[..., 1], device))


def to_u64_pair(x: GFE) -> np.ndarray:
    return np.stack([gf.to_u64(x.re), gf.to_u64(x.im)], axis=-1)


def zeros(shape, device) -> GFE:
    return GFE(gf.zeros(shape, device), gf.zeros(shape, device))


def ones(shape, device) -> GFE:
    return GFE(gf.ones(shape, device), gf.zeros(shape, device))


def add(a: GFE, b: GFE) -> GFE:
    return GFE(gf.add(a.re, b.re), gf.add(a.im, b.im))


def sub(a: GFE, b: GFE) -> GFE:
    return GFE(gf.sub(a.re, b.re), gf.sub(a.im, b.im))


def mul(a: GFE, b: GFE) -> GFE:
    t0 = gf.mul(a.re, b.re)
    t1 = gf.mul(a.im, b.im)
    t2 = gf.mul(gf.add(a.re, a.im), gf.add(b.re, b.im))
    re = gf.add(t0, gf.mul_u32(t1, W))
    im = gf.sub(t2, gf.add(t0, t1))
    return GFE(re, im)


def mul_base(a: GFE, b: torch.Tensor) -> GFE:
    return GFE(gf.mul(a.re, b), gf.mul(a.im, b))


def scale_add(acc: GFE, alpha: GFE, c: torch.Tensor) -> GFE:
    """acc * alpha + c (base c)."""
    return add(mul(acc, alpha), from_base(c))


def exp_const(a: GFE, e: int) -> GFE:
    result = None
    base = a
    while e > 0:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = mul(base, base)
    if result is None:
        return GFE(torch.ones_like(a.re), torch.zeros_like(a.im))
    return result


def powers(base: GFE, n: int) -> GFE:
    """[1, b, ..., b^{n-1}] of a 0-dim GFE b: the rows of powers_stacked."""
    out = powers_stacked(base, n)
    return GFE(out[0], out[1])


def powers_stacked(base: GFE, n: int) -> torch.Tensor:
    """(2, n) re and im of [1, b, ..., b^{n-1}] for a 0-dim GFE b read on
    the device (a program can take it from an input): K13's extension
    instantiation (csrc/powers.cu, one launch) on CUDA tensors, powers_plain
    on CPU tensors."""
    if not gf._on_cuda(base.re, base.im):
        out = powers_plain(base, n)
        return torch.stack([out.re, out.im])
    re, im = base.re.reshape(1), base.im.reshape(1)
    kernels.require_cuda_int64(re, im)
    out = torch.empty((2, n), dtype=torch.int64, device=re.device)
    if n:
        kernels.check(kernels.lib("powers").gl_ext_powers(
            re.data_ptr(), im.data_ptr(), out.data_ptr(), n,
            kernels.stream_ptr(out)), f"ext_powers ({n})")
        kernels.count("ext_powers")
    return out


def powers_plain(base: GFE, n: int) -> GFE:
    """Plain version of K13's extension instantiation: log-doubling on the
    plain ops (the block [0, m) times b^m gives [m, 2m), b^m squared)."""
    device = base.re.device
    out = GFE(torch.ones((1,), dtype=torch.int64, device=device),
              torch.zeros((1,), dtype=torch.int64, device=device))
    bm, length = base, 1
    while length < n:
        step = min(length, n - length)
        nxt = mul_plain(out[:step], bm)
        out = GFE(torch.cat([out.re, nxt.re]), torch.cat([out.im, nxt.im]))
        length += step
        if length < n:
            bm = mul_plain(bm, bm)
    return out[:n]


def mul_plain(a: GFE, b: GFE) -> GFE:
    """mul on the plain ops (Karatsuba's three products)."""
    t0 = gf.mul_plain(a.re, b.re)
    t1 = gf.mul_plain(a.im, b.im)
    t2 = gf.mul_plain(gf.add_plain(a.re, a.im), gf.add_plain(b.re, b.im))
    return GFE(gf.add_plain(t0, gf.mul_plain(t1, gf.scalar(W, t1.device))),
               gf.sub_plain(t2, gf.add_plain(t0, t1)))


def inv(a: GFE) -> GFE:
    """Norm trick: (a0 - a1*phi) / (a0^2 - 7*a1^2) (0 maps to 0): K7's
    extension entry (csrc/gf_inv.cu, one launch) on CUDA tensors, inv_plain
    on CPU tensors."""
    if not gf._on_cuda(a.re, a.im):
        return inv_plain(a)
    re, im = a.re.contiguous(), a.im.contiguous()
    if re.shape != im.shape:
        raise ValueError(f"parts of shapes {tuple(re.shape)} and "
                         f"{tuple(im.shape)}")
    kernels.require_cuda_int64(re, im)
    out = GFE(torch.empty_like(re), torch.empty_like(im))
    if re.numel():
        kernels.check(kernels.lib("gf_inv").gl_ext_inv(
            re.data_ptr(), im.data_ptr(), out.re.data_ptr(),
            out.im.data_ptr(), re.numel(), kernels.stream_ptr(re)),
            "gf_ext_inv")
        kernels.count("gf_ext_inv")
    return out


def inv_plain(a: GFE) -> GFE:
    """Plain version of K7's extension entry: the norm, its inverse by
    gf.inv_plain, then the conjugate's parts times it, on the plain ops."""
    norm = gf.sub_plain(gf.mul_plain(a.re, a.re),
                        gf.mul_plain(gf.mul_plain(a.im, a.im),
                                     gf.scalar(W, a.im.device)))
    ninv = gf.inv_plain(norm)
    neg_im = gf.sub_plain(gf.scalar(0, a.im.device), a.im)
    return GFE(gf.mul_plain(a.re, ninv), gf.mul_plain(neg_im, ninv))


def sum_reduce(x: GFE, dim: int = -1) -> GFE:
    return GFE(gf.sum_reduce(x.re, dim), gf.sum_reduce(x.im, dim))
