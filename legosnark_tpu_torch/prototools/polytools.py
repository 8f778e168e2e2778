"""Univariate dense polynomials over Fr: what the prover needs.

Counterpart of `legosnark_tpu/prototools/polytools.py` (`eval_at`,
`powers_of`, `eval_as_poly_on`): coefficient arrays [8, deg+1] in
Montgomery form, ascending on the vector axis.
"""
from __future__ import annotations

import torch

from ..curve import bn254
from ..curve.group import G1, Point
from ..fields import limb as fl

FR = bn254.FR


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
