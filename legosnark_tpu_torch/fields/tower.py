"""Fq6 / Fq12 tower-field ops for the BN254 pairing.

Counterpart of `legosnark_tpu/fields/tower.py`, the same tower:
  Fq2  = Fq [u] / (u^2 + 1)
  Fq6  = Fq2[v] / (v^3 - xi),  xi = 9 + u
  Fq12 = Fq6[w] / (w^2 - v)

Layouts (limb axis at -2, vector axis last, as in `fields/limb.py`):
Fq6 = [..., 3, 2, 8, V] (c0, c1, c2 Fq2 coefficients), Fq12 =
[..., 2, 3, 2, 8, V]. Additions act on whole tensors (the field ops are
elementwise over leading axes). The independent Fq2 products of one
Fq6/Fq12 product are stacked into one Fq2 product, so an Fq12 product is
one K1 launch on the card (54 base products side by side).
"""
from __future__ import annotations

import torch

from . import limb as fl
from .ops import Fq2Ops, ext_shape, stacked


class Fq6Ops:
    """Cubic extension Fq2[v]/(v^3 - xi)."""

    ndim = 4

    def __init__(self, f2: Fq2Ops):
        self.f2 = f2
        self.spec = f2.spec

    def c(self, a, i):
        return a[..., i, :, :, :]

    def pack(self, c0, c1, c2):
        return torch.stack(torch.broadcast_tensors(c0, c1, c2), dim=-4)

    def add(self, a, b):
        return fl.add(self.spec, a, b)

    def sub(self, a, b):
        return fl.sub(self.spec, a, b)

    def neg(self, a):
        return fl.neg(self.spec, a)

    def mul(self, a, b):
        # Karatsuba-style: the 6 Fq2 products in one stacked call
        F = self.f2
        a, b = torch.broadcast_tensors(a, b)
        a0, a1, a2 = (self.c(a, i) for i in range(3))
        b0, b1, b2 = (self.c(b, i) for i in range(3))
        sa = F.add(torch.stack([a1, a0, a0]), torch.stack([a2, a1, a2]))
        sb = F.add(torch.stack([b1, b0, b0]), torch.stack([b2, b1, b2]))
        t = F.mul(torch.cat([torch.stack([a0, a1, a2]), sa]),
                  torch.cat([torch.stack([b0, b1, b2]), sb]))
        t0, t1, t2 = t[0], t[1], t[2]
        # s1 = u1 - t1 - t2, s2 = u2 - t0 - t1, s3 = u3 - t0 - t2
        s = F.sub(t[3:], F.add(torch.stack([t1, t0, t0]),
                               torch.stack([t2, t1, t2])))
        xs = F.mul_by_xi(torch.stack([s[0], t2]))
        return self.pack(*F.add(torch.stack([t0, s[1], s[2]]),
                                torch.stack([xs[0], xs[1], t1])).unbind(0))

    def sqr(self, a):
        return self.mul(a, a)

    def mul_by_v(self, a):
        """v * (a0 + a1 v + a2 v^2) = xi*a2 + a0 v + a1 v^2."""
        return self.pack(self.f2.mul_by_xi(self.c(a, 2)), self.c(a, 0),
                         self.c(a, 1))

    def mul_f2(self, a, s):
        """Multiply by an Fq2 scalar s [..., 2, 8, V]."""
        return self.f2.mul(a, s[..., None, :, :, :])

    def inv(self, a):
        F = self.f2
        a0, a1, a2 = (self.c(a, i) for i in range(3))
        a00, a12, a22, a01, a11, a02 = stacked(
            F.mul, [(a0, a0), (a1, a2), (a2, a2), (a0, a1), (a1, a1),
                    (a0, a2)])
        x12, x22 = F.mul_by_xi(torch.stack([a12, a22])).unbind(0)
        c0 = F.sub(a00, x12)
        c1 = F.sub(x22, a01)
        c2 = F.sub(a11, a02)
        p0, p1, p2 = stacked(F.mul, [(a0, c0), (a2, c1), (a1, c2)])
        t = F.inv(F.add(p0, F.mul_by_xi(F.add(p1, p2))))
        return self.mul_f2(self.pack(c0, c1, c2), t)

    def zero(self, shape, device):
        return self.f2.zero(ext_shape(shape, 3), device)

    def one(self, shape, device):
        F = self.f2
        return self.pack(F.one(shape, device), F.zero(shape, device),
                         F.zero(shape, device))

    def eq(self, a, b):
        same = fl.canon(self.spec, a) == fl.canon(self.spec, b)
        return same.all(dim=-2).all(dim=-2).all(dim=-2)

    def select(self, c, a, b):
        return torch.where(c[..., None, None, None, :], a, b)


class Fq12Ops:
    """Quadratic extension Fq6[w]/(w^2 - v)."""

    ndim = 5

    def __init__(self, f6: Fq6Ops):
        self.f6 = f6
        self.f2 = f6.f2
        self.spec = f6.spec

    def c(self, a, i):
        return a[..., i, :, :, :, :]

    def pack(self, c0, c1):
        return torch.stack(torch.broadcast_tensors(c0, c1), dim=-5)

    def add(self, a, b):
        return fl.add(self.spec, a, b)

    def sub(self, a, b):
        return fl.sub(self.spec, a, b)

    def mul(self, a, b):
        # Karatsuba: 3 Fq6 products in one stacked call
        F = self.f6
        a, b = torch.broadcast_tensors(a, b)
        a0, a1 = self.c(a, 0), self.c(a, 1)
        b0, b1 = self.c(b, 0), self.c(b, 1)
        s = F.add(torch.stack([a0, b0]), torch.stack([a1, b1]))
        t0, t1, t2 = F.mul(torch.stack([a0, a1, s[0]]),
                           torch.stack([b0, b1, s[1]])).unbind(0)
        c0 = F.add(t0, F.mul_by_v(t1))
        c1 = F.sub(t2, F.add(t0, t1))
        return self.pack(c0, c1)

    def sqr(self, a):
        # complex squaring: c1 = 2 a0 a1,
        # c0 = (a0 + a1)(a0 + v a1) - a0 a1 - v a0 a1; 2 Fq6 products
        F = self.f6
        a0, a1 = self.c(a, 0), self.c(a, 1)
        x, t = F.mul(torch.stack([F.add(a0, a1), a0]),
                     torch.stack([F.add(a0, F.mul_by_v(a1)), a1])).unbind(0)
        c0 = F.sub(x, F.add(t, F.mul_by_v(t)))
        return self.pack(c0, F.add(t, t))

    def inv(self, a):
        F = self.f6
        a0, a1 = self.c(a, 0), self.c(a, 1)
        s0, s1 = F.mul(torch.stack([a0, a1]), torch.stack([a0, a1])).unbind(0)
        t = F.inv(F.sub(s0, F.mul_by_v(s1)))
        r0, r1 = F.mul(torch.stack([a0, a1]), t).unbind(0)
        return self.pack(r0, F.neg(r1))

    def conj(self, a):
        """Conjugation a0 - a1 w == Frobenius^6 == unitary inverse."""
        return self.pack(self.c(a, 0), self.f6.neg(self.c(a, 1)))

    def one(self, shape, device):
        F = self.f6
        return self.pack(F.one(shape, device), F.zero(shape, device))

    def batch_shape(self, a):
        return a.shape[:-5] + a.shape[-1:]

    def eq(self, a, b):
        same = fl.canon(self.spec, a) == fl.canon(self.spec, b)
        return same.flatten(-5, -2).all(dim=-2)

    def is_one(self, a):
        return self.eq(a, self.one(self.batch_shape(a), a.device))

    def select(self, c, a, b):
        return torch.where(c[..., None, None, None, None, :], a, b)

    # -- sparse multiplication used by the Miller loop ----------------------
    def mul_by_034(self, a, e0, e3, e4):
        """Multiply by the sparse element e0 + (e3 + e4 v) w (Fq2
        coefficients c0, c3, c4 of the w-basis): the D-twist line shape.
        The 15 Fq2 products run as one stacked call."""
        F6, F2 = self.f6, self.f2
        a0, a1 = self.c(a, 0), self.c(a, 1)
        s = F6.add(a0, a1)
        e03 = F2.add(e0, e3)
        b0, b1, b2 = (F6.c(a1, i) for i in range(3))
        s0, s1, s2 = (F6.c(s, i) for i in range(3))
        p = stacked(F2.mul, [
            (F6.c(a0, 0), e0), (F6.c(a0, 1), e0), (F6.c(a0, 2), e0),
            (b0, e3), (b2, e4), (b1, e3), (b0, e4), (b2, e3), (b1, e4),
            (s0, e03), (s2, e4), (s1, e03), (s0, e4), (s2, e03), (s1, e4)])
        t0 = F6.pack(p[0], p[1], p[2])
        x = F2.mul_by_xi(torch.stack([p[4], p[10]]))
        t1 = F6.pack(F2.add(p[3], x[0]), F2.add(p[5], p[6]),
                     F2.add(p[7], p[8]))
        t2 = F6.pack(F2.add(p[9], x[1]), F2.add(p[11], p[12]),
                     F2.add(p[13], p[14]))
        c0 = F6.add(t0, F6.mul_by_v(t1))
        c1 = F6.sub(t2, F6.add(t0, t1))
        return self.pack(c0, c1)
