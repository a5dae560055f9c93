"""Batched Goldilocks NTT on torch tensors; counterpart of olavm_tpu/ntt/ntt.py
and olavm_tpu/ntt/pallas_ntt.py.

Conventions match the reference polynomial layer: `ntt` maps coefficients to
values p(w^i) in natural order along the last axis; `intt` inverts it and
applies 1/n after the transform; `coset_lde` evaluates on shift * H' with
|H'| = n << rate_bits. The coset scalings and the 1/n are one pass of
gf.scale_powers each (gl_scale_powers on the card), with no power table.

On a CUDA tensor every transform with n >= 2 launches K1 (csrc/ntt.cu): one
to three passes that each run several radix-2 stages in shared memory, the
bit reversal folded into the first pass's load. On a CPU tensor the plain
version runs: the radix-2 ladder of olavm_tpu/ntt/ntt.py:89-136 with the
plain field ops.
"""

from __future__ import annotations

import torch

from ..field import goldilocks as g
from ..utils.bits import log2_strict

from .. import kernels
from ..field import gf

# (device, log_n, inverse) -> (n/2,) powers of the (inverse) root of unity
_TWIDDLES: dict = {}
# (device, n) -> bit-reversal index tensor
_PERMS: dict = {}


def twiddles(log_n: int, inverse: bool, device) -> torch.Tensor:
    """Powers w^0 .. w^{n/2-1} of the order-n root (or its inverse), built
    once per size and device by log-doubling (gf.power_rows)."""
    key = (str(device), log_n, inverse)
    if key not in _TWIDDLES:
        root = g.primitive_root_of_unity(log_n)
        if inverse:
            root = g.inv(root)
        _TWIDDLES[key] = gf.power_rows([root], 1 << (log_n - 1), device)[0]
    return _TWIDDLES[key]


def ntt_plain(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Radix-2 DIT ladder over the last axis, plain field ops, no 1/n."""
    n = x.shape[-1]
    log_n = log2_strict(n)
    if n == 1:
        return x
    tw = twiddles(log_n, inverse, x.device)
    x = x.index_select(-1, bitrev_perm(n, x.device))
    batch = x.shape[:-1]
    for s in range(1, log_n + 1):
        half = 1 << (s - 1)
        xv = x.reshape(*batch, n >> s, 2, half)
        u = xv[..., 0, :]
        v = gf.mul_plain(xv[..., 1, :], tw[:: 1 << (log_n - s)][:half])
        x = torch.stack([gf.add_plain(u, v), gf.sub_plain(u, v)],
                        dim=-2).reshape(*batch, n)
    return x


def _ntt_cuda(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    n = x.shape[-1]
    log_n = log2_strict(n)
    x = x.contiguous()
    tw = twiddles(log_n, inverse, x.device)
    kernels.require_cuda_int64(x, tw)
    # a fresh output: the kernel's first pass must not write what it reads
    out = torch.empty_like(x)
    batch = x.numel() // n
    if batch == 0:
        return out
    rc = kernels.lib("ntt").gl_ntt(x.data_ptr(), out.data_ptr(), tw.data_ptr(),
                                   batch, log_n, kernels.stream_ptr(x))
    kernels.check(rc, "ntt")
    kernels.count("ntt")
    return out


def _transform(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    if x.shape[-1] == 1:
        return x
    if x.device.type == "cuda":
        return _ntt_cuda(x, inverse)
    return ntt_plain(x, inverse)


def ntt(x: torch.Tensor) -> torch.Tensor:
    """Coefficients -> values p(g^i), natural order, along the last axis."""
    return _transform(x, inverse=False)


def intt(x: torch.Tensor) -> torch.Tensor:
    """Values p(g^i) -> coefficients."""
    n = x.shape[-1]
    log2_strict(n)
    if n == 1:
        return x
    return scale_by_powers(_transform(x, inverse=True), 1, g.inv(n))


def intt_unscaled(x: torch.Tensor) -> torch.Tensor:
    """n * intt(x): the inverse transform without its 1/n, which the caller
    folds into a later product."""
    log2_strict(x.shape[-1])
    return _transform(x, inverse=True)


def scale_by_powers(x: torch.Tensor, base, factor: int = 1) -> torch.Tensor:
    """x[..., j] * factor * base^j along the last axis: one gl_scale_powers
    over the rows (gf.scale_powers; no power table). `base` is a host int
    (by value) or a one-element device tensor."""
    n = x.shape[-1]
    return gf.scale_powers(x.reshape(-1, n), base, factor).reshape(x.shape)


def coset_fft(coeffs: torch.Tensor,
              shift=g.MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    """Evaluate polynomials on shift*H, |H| = len(coeffs)."""
    return ntt(scale_by_powers(coeffs, shift))


def coset_ifft(values: torch.Tensor,
               shift: int = g.MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    """Inverse of coset_fft (host-known shift): the unscaled inverse
    transform, then one pass of shift^-j / n."""
    return scale_by_powers(intt_unscaled(values), g.inv(shift),
                           g.inv(values.shape[-1]))


def _pad_last(x: torch.Tensor, size: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, size - x.shape[-1]))


def lde(coeffs: torch.Tensor, rate_bits: int) -> torch.Tensor:
    """Pad coefficients by 2^rate_bits and evaluate over the larger subgroup."""
    return ntt(_pad_last(coeffs, coeffs.shape[-1] << rate_bits))


def coset_lde(coeffs: torch.Tensor, rate_bits: int,
              shift=g.MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    """Evaluations of the degree-<n polynomials on shift*H',
    |H'| = n << rate_bits: the n coefficients scaled by shift^j, then
    padded (the zeros need no scaling)."""
    scaled = scale_by_powers(coeffs, shift)
    return ntt(_pad_last(scaled, coeffs.shape[-1] << rate_bits))


def bitrev_perm(n: int, device) -> torch.Tensor:
    """Index tensor r with r[i] = reverse_bits(i, log2(n)), built on the
    device (utils.bits.bit_reversal_perm's loop, which takes seconds on the
    host at 2^23 and more) and cached."""
    key = (str(device), n)
    if key not in _PERMS:
        x = torch.arange(n, dtype=torch.int64, device=device)
        out = torch.zeros_like(x)
        for _ in range(log2_strict(n)):
            out = (out << 1) | (x & 1)
            x >>= 1
        _PERMS[key] = out
    return _PERMS[key]
