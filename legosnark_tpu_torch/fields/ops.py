"""Uniform op interfaces over Fq and the Fq2 extension.

Counterpart of `legosnark_tpu/fields/ops.py:35-233`. The group law is
written once against this interface and serves G1 (over Fq) and G2 (over
Fq2). Fq elements are int32 tensors `[..., 8, V]`; Fq2 elements are
`[..., 2, 8, V]` (c0, c1 ahead of the limbs). Batch shapes are tuples
whose last entry is the vector axis.
"""
from __future__ import annotations

import torch

from . import limb as fl
from .limb import FieldSpec


def ext_shape(shape, k: int):
    """Insert a tower/limb axis of size k ahead of the vector axis."""
    shape = tuple(shape)
    if not shape:
        return (k, 1)
    return shape[:-1] + (k, shape[-1])


class FqOps:
    """Prime-field ops (Montgomery form).

    plain=True multiplies with the plain version of kernel K1 on every
    device: the plain versions of the G1 kernels are built on it."""

    #: number of element axes after the batch dims (limb + vector)
    ndim = 2

    def __init__(self, spec: FieldSpec, plain: bool = False):
        self.spec = spec
        if plain:
            from .cuda_limb import mont_mul_plain
            self._mul = mont_mul_plain
        else:
            self._mul = fl.mont_mul

    def add(self, a, b):
        return fl.add(self.spec, a, b)

    def sub(self, a, b):
        return fl.sub(self.spec, a, b)

    def neg(self, a):
        return fl.neg(self.spec, a)

    def mul(self, a, b):
        return self._mul(self.spec, a, b)

    def sqr(self, a):
        return self._mul(self.spec, a, a)

    def inv(self, a):
        return fl.inv(self.spec, a)

    def zero(self, shape, device):
        return fl.zero(self.spec, shape, device)

    def one(self, shape, device):
        return fl.one(self.spec, shape, device)

    def is_zero(self, a):
        return fl.is_zero(self.spec, a)

    def eq(self, a, b):
        return fl.eq(self.spec, a, b)

    def select(self, c, a, b):
        return fl.select(c, a, b)

    def const(self, x: int, device):
        """Montgomery-form constant [8, 1]."""
        return fl.const_mont(self.spec, x, device)

    def bcast(self, c, batch_shape):
        """Broadcast an [8, 1] constant to a batch shape."""
        return c.expand(ext_shape(batch_shape, fl.NLIMBS))

    def batch_shape(self, a):
        return a.shape[:-2] + a.shape[-1:]


class Fq2Ops:
    """Quadratic extension Fq[u]/(u^2+1) over a base FqOps."""

    ndim = 3

    def __init__(self, base: FqOps):
        self.base = base
        self.spec = base.spec

    def c0(self, a):
        return a[..., 0, :, :]

    def c1(self, a):
        return a[..., 1, :, :]

    def pack(self, c0, c1):
        c0, c1 = torch.broadcast_tensors(c0, c1)
        return torch.stack([c0, c1], dim=-3)

    def add(self, a, b):
        F = self.base
        return self.pack(F.add(self.c0(a), self.c0(b)),
                         F.add(self.c1(a), self.c1(b)))

    def sub(self, a, b):
        F = self.base
        return self.pack(F.sub(self.c0(a), self.c0(b)),
                         F.sub(self.c1(a), self.c1(b)))

    def neg(self, a):
        F = self.base
        return self.pack(F.neg(self.c0(a)), F.neg(self.c1(a)))

    def mul(self, a, b):
        # Karatsuba: 3 base muls
        F = self.base
        a0, a1, b0, b1 = self.c0(a), self.c1(a), self.c0(b), self.c1(b)
        t0 = F.mul(a0, b0)
        t1 = F.mul(a1, b1)
        t2 = F.mul(F.add(a0, a1), F.add(b0, b1))
        return self.pack(F.sub(t0, t1), F.sub(t2, F.add(t0, t1)))

    def sqr(self, a):
        # (a0+a1)(a0-a1), 2 a0 a1
        F = self.base
        a0, a1 = self.c0(a), self.c1(a)
        c0 = F.mul(F.add(a0, a1), F.sub(a0, a1))
        t = F.mul(a0, a1)
        return self.pack(c0, F.add(t, t))

    def zero(self, shape, device):
        return self.base.zero(ext_shape(shape, 2), device)

    def one(self, shape, device):
        F = self.base
        return self.pack(F.one(shape, device), F.zero(shape, device))

    def is_zero(self, a):
        return torch.all(fl.canon(self.spec, a) == 0, dim=-2).all(dim=-2)

    def eq(self, a, b):
        same = fl.canon(self.spec, a) == fl.canon(self.spec, b)
        return torch.all(same, dim=-2).all(dim=-2)

    def select(self, c, a, b):
        return torch.where(c[..., None, None, :], a, b)

    def const(self, x, device):
        """Constant [2, 8, 1] from an int pair (c0, c1)."""
        return torch.stack([self.base.const(x[0], device),
                            self.base.const(x[1], device)])

    def bcast(self, c, batch_shape):
        shape = tuple(batch_shape) or (1,)
        return c.expand(shape[:-1] + (2, fl.NLIMBS, shape[-1]))

    def batch_shape(self, a):
        return a.shape[:-3] + a.shape[-1:]
