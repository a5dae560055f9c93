"""Carry Goldilocks arrays between the JAX package and the port.

The prover's "weights" are its traces, caps and constants: host uint64
arrays that both packages read. These functions move them into and out of
the port's layout (one int64 tensor of bit patterns) so that the tests can
feed both packages the same values and compare what they return.

`from_jax_gf` takes an `olavm_tpu.field.gf.GF` (a (lo, hi) pair of uint32
arrays) by duck typing, so this module never imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from .field import gf


def from_u64(x: np.ndarray, device) -> torch.Tensor:
    """Canonical host uint64 values -> port tensor on `device`."""
    return gf.from_u64(x, device)


def to_u64(t: torch.Tensor) -> np.ndarray:
    """Port tensor -> host uint64 array with the same values."""
    return gf.to_u64(t)


def from_jax_gf(x, device) -> torch.Tensor:
    """(lo, hi) u32 limb pair of the JAX package -> port tensor on `device`."""
    lo = np.asarray(x.lo, dtype=np.uint64)
    hi = np.asarray(x.hi, dtype=np.uint64)
    return from_u64(lo | (hi << np.uint64(32)), device)
