"""Field-op adapters so each table's constraint code runs in three modes;
counterpart of olavm_tpu/stark/ops.py (whose GfOps, the jnp device ops, is
not carried).

- BaseOps: host quotient evaluation for the host prover (stark/prover.py)
  over numpy uint64 arrays (carried unchanged);
- TorchOps: quotient evaluation op by op over int64 tensors (field/gf.py):
  every product on a CUDA tensor launches K3. The device prover records the
  same code through constraint_tape.TapeOps and runs it as K6; TorchOps
  runs prover_device.quotient_class_ops, the yardstick K6 is held to;
- ExtOps: verifier evaluation at zeta over (2,) extension elements (carried
  unchanged).
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import extension as ge
from ..field import goldilocks as g

from ..field import gf


class BaseOps:
    is_ext = False

    @staticmethod
    def add(a, b):
        return g.add_arr(a, b)

    @staticmethod
    def sub(a, b):
        return g.sub_arr(a, b)

    @staticmethod
    def mul(a, b):
        return g.mul_arr(a, b)

    @staticmethod
    def neg(a):
        return g.neg_arr(a)

    @staticmethod
    def constant(c: int):
        return np.uint64(c % g.P)

    @staticmethod
    def scalar_mul(a, c: int):
        return g.mul_arr(a, np.uint64(c % g.P))

    @staticmethod
    def add_many(terms):
        acc = terms[0]
        for t in terms[1:]:
            acc = g.add_arr(acc, t)
        return acc

    @staticmethod
    def indicator_eq_const(a, c: int):
        """Elementwise 1 where a == c else 0 (the reference's data-dependent
        packed-value selector, memory_stark.rs:290-298)."""
        return (np.asarray(a) == np.uint64(c % g.P)).astype(np.uint64)


class TorchOps:
    """Device ops over int64 Goldilocks tensors on one device. Values are
    (n,) columns or 0-dim scalars (constants, challenges); the field ops
    broadcast a 0-dim operand without copying it."""

    is_ext = False

    def __init__(self, device):
        self.device = torch.device(device)

    add = staticmethod(gf.add)
    sub = staticmethod(gf.sub)
    mul = staticmethod(gf.mul)
    neg = staticmethod(gf.neg)

    def constant(self, c: int):
        return gf.scalar(c, self.device)

    def scalar_mul(self, a, c: int):
        c = int(c) % g.P
        if c == 0:
            return torch.zeros_like(a)
        if c == 1:
            return a
        if c < (1 << 32):
            return gf.mul_u32(a, c)
        return gf.mul(a, gf.scalar(c, a.device))

    @staticmethod
    def add_many(terms):
        acc = terms[0]
        for t in terms[1:]:
            acc = gf.add(acc, t)
        return acc

    @staticmethod
    def indicator_eq_const(a, c: int):
        """Element-wise 1 where a == c else 0."""
        return (a == gf.scalar(c, a.device)).to(torch.int64)


class ExtOps:
    is_ext = True

    @staticmethod
    def add(a, b):
        return ge.add(a, b)

    @staticmethod
    def sub(a, b):
        return ge.sub(a, b)

    @staticmethod
    def mul(a, b):
        return ge.mul(a, b)

    @staticmethod
    def neg(a):
        return ge.neg(a)

    @staticmethod
    def constant(c: int):
        return ge.from_base(c % g.P)

    @staticmethod
    def scalar_mul(a, c: int):
        return ge.scalar_mul(a, c % g.P)

    @staticmethod
    def add_many(terms):
        acc = terms[0]
        for t in terms[1:]:
            acc = ge.add(acc, t)
        return acc

    @staticmethod
    def indicator_eq_const(a, c: int):
        arr = np.asarray(a).reshape(2)
        hit = int(arr[0]) == c % g.P and int(arr[1]) == 0
        return ge.from_base(1 if hit else 0)
