"""Univariate dense polynomials over Fr.

Counterpart of `legosnark_tpu/prototools/polytools.py`: coefficient
arrays [..., 8, deg+1] in Montgomery form, ascending on the vector axis;
the constructors, sum and schoolbook product (degrees here are the
sumcheck's, at most 3; large products go through `prototools.ntt`),
Horner evaluation, powers, the homomorphic evaluation over commitment
points, and the sum of an MLE table over the Boolean cube.
"""
from __future__ import annotations

import torch

from ..config import resolve_device
from ..curve import bn254
from ..curve.group import G1, Point
from ..fields import limb as fl
from .mle import field_sum

FR = bn254.FR


def zero(deg: int, device=None):
    """The zero polynomial with deg + 1 coefficients."""
    return fl.zero(FR, (deg + 1,), resolve_device(device)).clone()


def one(device=None):
    return fl.one(FR, (), resolve_device(device)).clone()


def x(device=None):
    """The polynomial X."""
    dev = resolve_device(device)
    return torch.cat([fl.zero(FR, (), dev), fl.one(FR, (), dev)], dim=-1)


def one_minus_x(device=None):
    """1 - X."""
    one_ = fl.one(FR, (), resolve_device(device))
    return torch.cat([one_, fl.neg(FR, one_)], dim=-1)


def add(a, b):
    """Coefficient sum; the shorter polynomial is padded with zeros."""
    n = max(a.shape[-1], b.shape[-1])
    a, b = (torch.constant_pad_nd(t, (0, n - t.shape[-1])) for t in (a, b))
    return fl.add(FR, a, b)


def mul(a, b):
    """Schoolbook product [..., 8, la] x [..., 8, lb] -> [..., 8, la+lb-1]:
    all la * lb coefficient products in one Montgomery product, then la
    shifted additions."""
    la, lb = a.shape[-1], b.shape[-1]
    a, b = torch.broadcast_tensors(a[..., :, :, None], b[..., :, None, :])
    prods = fl.mont_mul(FR, a.flatten(-2), b.flatten(-2))    # [..., 8, la*lb]
    out = torch.zeros(prods.shape[:-1] + (la + lb - 1,), dtype=prods.dtype,
                      device=prods.device)
    for i in range(la):
        out[..., i : i + lb] = fl.add(FR, out[..., i : i + lb],
                                      prods[..., i * lb : (i + 1) * lb])
    return out


def scalar_mul(a, s):
    """s * a for s [..., 8, 1]."""
    return fl.mont_mul(FR, a, s)


def eval_at(a, t):
    """Horner evaluation: a [8, m], t [8, 1] -> [8, 1]."""
    m = a.shape[-1]
    acc = a[..., m - 1 : m]
    for i in range(m - 2, -1, -1):
        acc = fl.add(FR, fl.mont_mul(FR, acc, t), a[..., i : i + 1])
    return acc


def powers_of(t, m: int):
    """[1, t, t^2, ..., t^(m-1)] as [..., 8, m]; t [..., 8, 1] Montgomery."""
    cols = [fl.one(FR, (), t.device).expand(t.shape)]
    for _ in range(m - 1):
        cols.append(fl.mont_mul(FR, cols[-1], t))
    return torch.cat(cols, dim=-1)


def eval_as_poly_on(comms: Point, t_mont) -> Point:
    """Homomorphic evaluation sum_j t^j * C_j of a commitment batch
    [..., 8, deg+1] at t [..., 8, 1]: one batched scalar multiplication
    over all deg+1 points, then a tree sum -> [..., 8, 1]. Leading axes
    evaluate several polynomials, or one at several points, at once."""
    pw = fl.from_mont(FR, powers_of(t_mont, comms.x.shape[-1]))
    return G1.sum_reduce(G1.scalar_mul(comms, pw))


def sum_over_all_bin_values(v_mont):
    """Sum of an MLE table over the Boolean cube: the table's sum
    [..., 8, 2^k] -> [..., 8, 1]."""
    return field_sum(v_mont)
