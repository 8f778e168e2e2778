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


def stacked(fn, pairs) -> list:
    """fn applied once to stacked operands: [(a1, b1), (a2, b2), ...] ->
    [fn(a1, b1), fn(a2, b2), ...]. All operands broadcast to one shape;
    on the card the stack costs one launch of each kernel fn runs."""
    xs = torch.broadcast_tensors(*(t for pr in pairs for t in pr))
    return list(fn(torch.stack(xs[0::2]), torch.stack(xs[1::2])).unbind(0))


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
    """Quadratic extension Fq[u]/(u^2+1) over a base FqOps.

    add, sub and neg act on both coefficients at once (the field ops are
    elementwise over leading axes); each product runs its base products
    as one stacked call (`stacked`), one K1 launch on the card."""

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
        return self.base.add(a, b)

    def sub(self, a, b):
        return self.base.sub(a, b)

    def neg(self, a):
        return self.base.neg(a)

    def conj(self, a):
        return self.pack(self.c0(a), self.base.neg(self.c1(a)))

    def mul(self, a, b):
        # Karatsuba: 3 base products in one call
        F = self.base
        a, b = torch.broadcast_tensors(a, b)
        a0, a1, b0, b1 = self.c0(a), self.c1(a), self.c0(b), self.c1(b)
        s = F.add(torch.stack([a0, b0]), torch.stack([a1, b1]))
        t0, t1, t2 = F.mul(torch.stack([a0, a1, s[0]]),
                           torch.stack([b0, b1, s[1]])).unbind(0)
        return self.pack(F.sub(t0, t1), F.sub(t2, F.add(t0, t1)))

    def sqr(self, a):
        # (a0+a1)(a0-a1), 2 a0 a1: 2 base products in one call
        F = self.base
        a0, a1 = self.c0(a), self.c1(a)
        c0, t = F.mul(torch.stack([F.add(a0, a1), a0]),
                      torch.stack([F.sub(a0, a1), a1])).unbind(0)
        return self.pack(c0, F.add(t, t))

    def inv(self, a):
        F = self.base
        a0, a1 = self.c0(a), self.c1(a)
        n0, n1 = F.mul(torch.stack([a0, a1]), torch.stack([a0, a1])).unbind(0)
        ninv = F.inv(F.add(n0, n1))
        return self.pack(*F.mul(torch.stack([a0, F.neg(a1)]),
                                ninv).unbind(0))

    def mul_by_xi(self, a):
        """Multiply by xi = 9 + u (the Fq6 non-residue):
        (9 a0 - a1) + (a0 + 9 a1) u, 9x = 8x + x by three doublings."""
        F = self.base
        x2 = F.add(a, a)
        x4 = F.add(x2, x2)
        x9 = F.add(F.add(x4, x4), a)
        return self.pack(F.sub(self.c0(x9), self.c1(a)),
                         F.add(self.c0(a), self.c1(x9)))

    def mul_base(self, a, s):
        """Multiply by a base-field scalar s [..., 8, V]."""
        return self.base.mul(a, s[..., None, :, :])

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
