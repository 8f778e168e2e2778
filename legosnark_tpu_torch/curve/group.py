"""Complete projective group law for BN254 G1 and G2 on torch tensors.

Counterpart of `legosnark_tpu/curve/group.py`: the Renes-Costello-Batina
complete formulas for a = 0 (eprint 2015/1060, Algorithms 7 and 9), one
straight-line sequence for generic adds, doublings and the identity
(0 : 1 : 0). All functions are batched over leading axes plus the vector
axis, and generic over the field ops, so the same code serves G1 (Fq) and
G2 (Fq2). `CurveOps.add`/`double` go to kernels K2/K3 on G1 and K5/K6 on
G2 (`cuda_group`); their plain versions, which CPU tensors take, run the
formulas below (`rcb_add`, `rcb_double`) in torch code.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..config import resolve_device
from ..fields import limb as fl
from ..fields.ops import Fq2Ops, FqOps
from . import bn254


class Point(NamedTuple):
    """Homogeneous projective point (X : Y : Z); identity = (0 : 1 : 0)."""

    x: Any
    y: Any
    z: Any


def point_map(f, *ps: Point) -> Point:
    return Point(*(f(*xs) for xs in zip(*ps)))


def point_stack(ps, dim: int = 0) -> Point:
    """Stack equal-shaped point batches on a new leading axis."""
    return Point(*(torch.stack(list(xs), dim=dim) for xs in zip(*ps)))


def point_concat(ps) -> Point:
    """Concatenate point batches along the vector (last) axis."""
    return Point(*(torch.cat(list(xs), dim=-1) for xs in zip(*ps)))


def rcb_add(F, b3, p, q) -> Point:
    """Complete addition (RCB Algorithm 7, a = 0); b3 = F.const(3b)."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    t0 = F.mul(X1, X2)
    t1 = F.mul(Y1, Y2)
    t2 = F.mul(Z1, Z2)
    t3 = F.mul(F.add(X1, Y1), F.add(X2, Y2))
    t3 = F.sub(t3, F.add(t0, t1))
    t4 = F.mul(F.add(Y1, Z1), F.add(Y2, Z2))
    t4 = F.sub(t4, F.add(t1, t2))
    X3 = F.mul(F.add(X1, Z1), F.add(X2, Z2))
    Y3 = F.sub(X3, F.add(t0, t2))
    X3 = F.add(t0, t0)
    t0 = F.add(X3, t0)
    t2 = F.mul(b3, t2)
    Z3 = F.add(t1, t2)
    t1 = F.sub(t1, t2)
    Y3 = F.mul(b3, Y3)
    X3 = F.mul(t4, Y3)
    t2_ = F.mul(t3, t1)
    X3 = F.sub(t2_, X3)
    Y3 = F.mul(Y3, t0)
    t1 = F.mul(t1, Z3)
    Y3 = F.add(t1, Y3)
    t0 = F.mul(t0, t3)
    Z3 = F.mul(Z3, t4)
    Z3 = F.add(Z3, t0)
    return Point(X3, Y3, Z3)


def rcb_double(F, b3, p) -> Point:
    """Complete doubling (RCB Algorithm 9, a = 0)."""
    X, Y, Z = p
    t0 = F.sqr(Y)
    Z3 = F.add(t0, t0)
    Z3 = F.add(Z3, Z3)
    Z3 = F.add(Z3, Z3)
    t1 = F.mul(Y, Z)
    t2 = F.sqr(Z)
    t2 = F.mul(b3, t2)
    X3 = F.mul(t2, Z3)
    Y3 = F.add(t0, t2)
    Z3 = F.mul(t1, Z3)
    t1 = F.add(t2, t2)
    t2 = F.add(t1, t2)
    t0 = F.sub(t0, t2)
    Y3 = F.mul(t0, Y3)
    Y3 = F.add(X3, Y3)
    t1 = F.mul(X, Y)
    X3 = F.mul(t0, t1)
    X3 = F.add(X3, X3)
    return Point(X3, Y3, Z3)


class CurveOps:
    """Group-law ops for y^2 = x^3 + b over a field-ops instance.

    b is a Python int (G1) or an int pair (G2). add and double go to the
    G1 kernels of `cuda_group` (K2/K3) where g1=True, else to the G2
    kernels (K5/K6); on CPU tensors, to their plain versions."""

    def __init__(self, field, b, g1: bool = False):
        self.F = field
        self.b = b
        self.g1 = g1

    # -- constructors ------------------------------------------------------
    def identity(self, shape, device) -> Point:
        F = self.F
        return Point(F.zero(shape, device), F.one(shape, device),
                     F.zero(shape, device))

    def from_affine(self, x, y) -> Point:
        return Point(x, y, self.F.one(self.F.batch_shape(x), x.device))

    def is_identity(self, p: Point):
        return self.F.is_zero(p.z)

    # -- group law ---------------------------------------------------------
    def add(self, p: Point, q: Point) -> Point:
        from . import cuda_group
        c = [t.contiguous() for t in torch.broadcast_tensors(*p, *q)]
        add = cuda_group.add_points if self.g1 else cuda_group.g2_add_points
        return Point(*add(c[:3], c[3:]))

    def double(self, p: Point, times: int = 1) -> Point:
        """[2^times] p for times >= 1: one K3 launch on G1, one K6 launch
        on G2."""
        if times < 1:
            raise ValueError(f"double: times must be >= 1, got {times}")
        from . import cuda_group
        c = [t.contiguous() for t in torch.broadcast_tensors(*p)]
        dbl = (cuda_group.double_point if self.g1
               else cuda_group.g2_double_point)
        return Point(*dbl(c, times))

    def neg(self, p: Point) -> Point:
        return Point(p.x, self.F.neg(p.y), p.z)

    def select(self, c, p: Point, q: Point) -> Point:
        F = self.F
        return Point(F.select(c, p.x, q.x), F.select(c, p.y, q.y),
                     F.select(c, p.z, q.z))

    def eq(self, p: Point, q: Point):
        """Projective equality, identity equal only to identity."""
        F = self.F
        pi, qi = self.is_identity(p), self.is_identity(q)
        cross = (F.eq(F.mul(p.x, q.z), F.mul(q.x, p.z))
                 & F.eq(F.mul(p.y, q.z), F.mul(q.y, p.z)))
        return (pi & qi) | (~pi & ~qi & cross)

    def on_curve(self, p: Point):
        """Y^2 Z == X^3 + b Z^3 (holds for the identity)."""
        F = self.F
        b = F.const(self.b, p.x.device)
        lhs = F.mul(F.sqr(p.y), p.z)
        rhs = F.add(F.mul(F.sqr(p.x), p.x), F.mul(b, F.mul(F.sqr(p.z), p.z)))
        return F.eq(lhs, rhs)

    # -- scalar multiplication --------------------------------------------
    def scalar_mul(self, p: Point, k) -> Point:
        """[k]P for k canonical Fr limbs [..., 8, V]; point and scalar
        batches broadcast. Fixed 4-bit windows over 256 bits, MSB first:
        a table of 0..15 times P, then per window four doublings (one call)
        and one add of the table entry (the complete law absorbs 0*P)."""
        F = self.F
        dev = p.x.device
        kb = k.shape[:-2] + k.shape[-1:]
        joint = torch.broadcast_shapes(F.batch_shape(p.x), kb)
        full = joint[:-1] + p.x.shape[-F.ndim:-1] + joint[-1:]
        p = Point(*(c.expand(full) for c in p))
        tab = point_stack([self.identity(joint, dev), p])   # [2, ...]
        step = p
        for _ in range(3):
            step = self.double(step)
            tab = point_map(lambda t, s: torch.cat([t, s]), tab,
                            self.add(tab, step))
        kw = fl.widen(k).expand(joint[:-1] + (fl.NLIMBS,) + joint[-1:])
        acc = None
        for w in range(fl.LIMB_BITS * fl.NLIMBS // 4 - 1, -1, -1):
            limb, off = divmod(4 * w, fl.LIMB_BITS)
            digit = (kw[..., limb, :] >> off) & 15
            idx = digit.reshape(joint[:-1] + (1,) * (F.ndim - 1) + joint[-1:])
            idx = idx.expand(full)[None]
            entry = point_map(lambda t: torch.gather(t, 0, idx)[0], tab)
            if acc is None:
                acc = entry
                continue
            acc = self.add(self.double(acc, times=4), entry)
        return acc

    # -- reductions --------------------------------------------------------
    def sum_reduce(self, p: Point) -> Point:
        """Tree sum along the vector axis -> one point (V = 1)."""
        n = p.x.shape[-1]
        while n > 1:
            h = n // 2
            s = self.add(point_map(lambda a: a[..., :h], p),
                         point_map(lambda a: a[..., h : 2 * h], p))
            if n % 2:
                s = point_map(lambda a, b: torch.cat([a, b[..., -1:]], -1),
                              s, p)
            p = s
            n = (n + 1) // 2
        return p


def scan(op, xs, reverse: bool = False):
    """Inclusive scan of a tuple of tensors along the last axis under an
    associative, commutative `op(tuple, tuple) -> tuple`.

    Work-efficient: pair-reduce neighbours, recurse on the half, then fill
    the even positions with one more op - about 2n ops in 2*log2(n)
    batched calls. reverse=True gives suffix sums."""
    if reverse:
        out = _scan(op, tuple(t.flip(-1) for t in xs))
        return tuple(t.flip(-1) for t in out)
    return _scan(op, tuple(xs))


def _scan(op, xs):
    n = xs[0].shape[-1]
    if n == 1:
        return xs
    h = n // 2
    pair = op(tuple(t[..., 0 : 2 * h : 2] for t in xs),
              tuple(t[..., 1 : 2 * h : 2] for t in xs))
    sp = _scan(op, tuple(pair))               # sp[i] = x[0] + ... + x[2i+1]
    m = (n - 1) // 2                          # even positions 2, 4, ..., 2m
    ev = op(tuple(t[..., :m] for t in sp),
            tuple(t[..., 2 : 2 * m + 1 : 2] for t in xs)) if m else None
    out = []
    for k, t in enumerate(xs):
        o = torch.empty(t.shape, dtype=t.dtype, device=t.device)
        o[..., 0] = t[..., 0]
        o[..., 1 : 2 * h : 2] = sp[k]
        if m:
            o[..., 2 : 2 * m + 1 : 2] = ev[k]
        out.append(o)
    return tuple(out)


def to_affine_batch(C: CurveOps, p: Point) -> Point:
    """Normalize a batch to z in {0, 1}: (x/z, y/z, 1), identity kept as
    (0, 1, 0). One field inversion for the whole batch: prefix and
    suffix products of z (`scan`) give every other z."""
    F = C.F
    dev = p.z.device
    is_id = F.is_zero(p.z)
    shape = F.batch_shape(p.z)
    one = F.bcast(F.one((), dev), shape)
    zsafe = F.select(is_id, one, p.z)

    def mul(a, b):
        return (F.mul(a[0], b[0]),)

    (pref,) = scan(mul, (zsafe,))
    (suf,) = scan(mul, (zsafe,), reverse=True)
    tinv = F.inv(pref[..., -1:])
    pref_m1 = torch.cat([one[..., :1], pref[..., :-1]], dim=-1)
    suf_p1 = torch.cat([suf[..., 1:], one[..., :1]], dim=-1)
    zinv = F.mul(tinv, F.mul(pref_m1, suf_p1))
    x = F.mul(p.x, zinv)
    y = F.mul(p.y, zinv)
    zero = F.bcast(F.zero((), dev), shape)
    return Point(F.select(is_id, zero, x), F.select(is_id, one, y),
                 F.select(is_id, zero, one))


# ---------------------------------------------------------------------------
# Concrete curves
# ---------------------------------------------------------------------------

FQ_OPS = FqOps(bn254.FQ)
FQ2_OPS = Fq2Ops(FQ_OPS)
FR_OPS = FqOps(bn254.FR)

G1 = CurveOps(FQ_OPS, bn254.B_G1, g1=True)
G2 = CurveOps(FQ2_OPS, bn254.B_G2)


def g1_generator(shape=(), device=None) -> Point:
    dev = resolve_device(device)
    x = FQ_OPS.bcast(FQ_OPS.const(bn254.G1_GEN[0], dev), shape)
    y = FQ_OPS.bcast(FQ_OPS.const(bn254.G1_GEN[1], dev), shape)
    return G1.from_affine(x, y)


def g2_generator(shape=(), device=None) -> Point:
    dev = resolve_device(device)
    x = FQ2_OPS.bcast(FQ2_OPS.const(bn254.G2_GEN_X, dev), shape)
    y = FQ2_OPS.bcast(FQ2_OPS.const(bn254.G2_GEN_Y, dev), shape)
    return G2.from_affine(x, y)


# ---------------------------------------------------------------------------
# int converters (host Python ints; affine, None for the identity)
# ---------------------------------------------------------------------------


def _fq_ints(t):
    return [bn254.FQ.from_mont_int(v) for v in fl.limbs_to_ints(t).reshape(-1)]


def g1_to_ints(p: Point) -> list:
    """G1 batch [..., 8, V] -> flat list of affine (x, y) or None."""
    out = []
    for x, y, z in zip(_fq_ints(p.x), _fq_ints(p.y), _fq_ints(p.z)):
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, bn254.Q)
            out.append((x * zi % bn254.Q, y * zi % bn254.Q))
    return out


def g2_to_ints(p: Point) -> list:
    """G2 batch [2, 8, V] -> list of affine ((x0, x1), (y0, y1)) or None."""
    Q = bn254.Q

    def pairs(t):
        return list(zip(_fq_ints(t[0]), _fq_ints(t[1])))

    out = []
    for x, y, z in zip(pairs(p.x), pairs(p.y), pairs(p.z)):
        if z == (0, 0):
            out.append(None)
            continue
        d = pow(z[0] * z[0] + z[1] * z[1], -1, Q)
        zi = (z[0] * d % Q, -z[1] * d % Q)

        def mul(a, b):
            return ((a[0] * b[0] - a[1] * b[1]) % Q,
                    (a[0] * b[1] + a[1] * b[0]) % Q)
        out.append((mul(x, zi), mul(y, zi)))
    return out


def g1_from_ints(pts, device) -> Point:
    """List of affine (x, y) int pairs or None -> Point batch [8, n]."""
    xs, ys, zs = [], [], []
    for pt in pts:
        x, y, z = (0, 1, 0) if pt is None else (pt[0], pt[1], 1)
        xs.append(x)
        ys.append(y)
        zs.append(z)
    spec = bn254.FQ
    return Point(*(fl.tensor(spec.to_mont_ints(v), device)
                   for v in (xs, ys, zs)))


def g2_from_ints(pts, device) -> Point:
    """List of affine G2 points (pairs of int pairs) or None -> [2, 8, n]."""
    coords = ([], [], [])
    for pt in pts:
        x, y, z = ((0, 0), (1, 0), (0, 0)) if pt is None else (pt[0], pt[1],
                                                              (1, 0))
        for lst, v in zip(coords, (x, y, z)):
            lst.append(v)
    spec = bn254.FQ

    def pack(vals):
        c0 = spec.to_mont_ints([v[0] for v in vals])
        c1 = spec.to_mont_ints([v[1] for v in vals])
        return fl.tensor(np.stack([c0, c1]), device)
    return Point(*(pack(v) for v in coords))
