"""Optimal ate pairing on BN254, batched over the vector axis.

Counterpart of `legosnark_tpu/curve/pairing.py`: homogeneous-projective
doubling and addition steps on the D-type twist (Costello-Lange-Naehrig),
line values in the sparse form c0 + (c3 + c4 v) w folded in with
`Fq12Ops.mul_by_034`, a loop over the bits of 6x+2, and the x-adic
addition chain of the final exponentiation's hard part. Every function
batches over leading axes and the vector axis (pairs side by side); the
independent Fq2 products of each step run as one stacked call, so a step
is a few K1 launches on the card. The loops branch on the static bits in
Python instead of computing and masking the addition step.

Identities are masked at the API boundary: an identity leg is replaced
by the generator and its Miller value by 1. `pairing_checks` evaluates
several products of pairings with one Miller loop over all their pairs
and one final exponentiation of width K; each product is still checked
on its own. The JAX package's per-pad-width jitted pieces are not
carried over: nothing here is compiled ahead of time.

Spans (`utils/trace`): `pairing.checks` around each `pairing_checks`
and `pairing_product_is_one` (attributes: pairs in all, products), with the
children `pairing.miller` (affine legs, Miller loop, product of the
Miller values) and `pairing.final_exp`.

The final exponentiation is the JAX package's: its hard part computes
f^(2x(6x^2 + 3x + 1)(q^4 - q^2 + 1)/r), a fixed power (coprime to r) of
the reduced pairing f^((q^12 - 1)/r). So `pairing` is bilinear and
non-degenerate, and is that power of `tests/oracle.py`'s pairing.
"""
from __future__ import annotations

import functools
import math

import torch

from ..fields.tower import Fq6Ops, Fq12Ops
from ..utils import trace
from . import bn254
from .group import (FQ2_OPS, FQ_OPS, G1, G2, Point, point_concat,
                    to_affine_batch)

F1 = FQ_OPS
F2 = FQ2_OPS
F6 = Fq6Ops(F2)
F12 = Fq12Ops(F6)

_ATE_BITS = [int(b) for b in bin(6 * bn254.BN_X + 2)[3:]]
_X_BITS = [int(b) for b in bin(bn254.BN_X)[3:]]


@functools.lru_cache(None)
def _consts(device: torch.device) -> dict:
    """Frobenius factors as [2, 3, 2, 8, 1] Fq12-shaped Fq2 tensors (the
    factor of v^i w^j at [j, i]), the twist-Frobenius factors, 1/2 and
    the twist's b."""
    fc = bn254.frob_coeffs()
    q = bn254.Q
    gam = {}
    for n in (1, 2, 3):
        rows = [torch.stack([F2.const(fc[n][2 * i + j], device)
                             for i in range(3)]) for j in range(2)]
        gam[n] = torch.stack(rows)
    return {
        "gamma": gam,
        "twist_qx": F2.const(bn254._fq2_pow(bn254.XI, (q - 1) // 3), device),
        "twist_qy": F2.const(bn254._fq2_pow(bn254.XI, (q - 1) // 2), device),
        "two_inv": F1.const(pow(2, -1, q), device),
        "b_twist": F2.const(bn254.B_G2, device),
    }


def frobenius(a, n: int):
    """q^n-power Frobenius on Fq12 [..., 2, 3, 2, 8, V]: conjugate every
    Fq2 coefficient for odd n, then scale the coefficient of v^i w^j by
    gamma_n[2i + j] (one stacked Fq2 product)."""
    if n % 2 == 1:
        a = F2.conj(a)
    return F2.mul(a, _consts(a.device)["gamma"][n])


# ---------------------------------------------------------------------------
# Miller loop
# ---------------------------------------------------------------------------


def _dbl_step(rx, ry, rz):
    """CLN doubling step on the twist: the new R and the line
    coefficients (c0, c3, c4), c0 to be scaled by P.y and c3 by P.x."""
    k = _consts(rx.device)
    s = F2.add(ry, rz)
    xy, b, c, j, hh = F2.mul(torch.stack([rx, ry, rz, rx, s]),
                             torch.stack([ry, ry, rz, rx, s])).unbind(0)
    c3x = F2.add(F2.add(c, c), c)
    e = F2.mul(k["b_twist"], c3x)
    a = F2.mul_base(xy, k["two_inv"])
    f = F2.add(F2.add(e, e), e)
    h = F2.sub(hh, F2.add(b, c))
    g = F2.mul_base(F2.add(b, f), k["two_inv"])
    g2, e2, nx, nz = F2.mul(torch.stack([g, e, a, b]),
                            torch.stack([g, e, F2.sub(b, f), h])).unbind(0)
    ny = F2.sub(g2, F2.add(F2.add(e2, e2), e2))
    c3 = F2.add(F2.add(j, j), j)
    return (nx, ny, nz), (F2.neg(h), c3, F2.sub(e, b))


def _add_step(rx, ry, rz, qx, qy):
    """CLN mixed addition step R += Q (Q affine on the twist)."""
    yz, xz = F2.mul(torch.stack(torch.broadcast_tensors(qy, qx)),
                    torch.stack([rz, rz])).unbind(0)
    theta = F2.sub(ry, yz)
    lam = F2.sub(rx, xz)
    c, d = F2.mul(torch.stack([theta, lam]),
                  torch.stack([theta, lam])).unbind(0)
    e, f, g = F2.mul(torch.stack([lam, rz, rx]),
                     torch.stack([d, c, d])).unbind(0)
    h = F2.sub(F2.add(e, f), F2.add(g, g))
    qx, qy = torch.broadcast_tensors(qx, qy)
    nx, t, ery, nz, tq, lq = F2.mul(
        torch.stack([lam, theta, e, rz, theta, lam]),
        torch.stack([h, F2.sub(g, h), ry, e, qx, qy])).unbind(0)
    ny = F2.sub(t, ery)
    return (nx, ny, nz), (lam, F2.neg(theta), F2.sub(tq, lq))


def _ell(f, coeffs, px, py):
    """Fold a line value into f: f *= (c0*P.y) + (c3*P.x + c4 v) w."""
    c0, c3, c4 = coeffs
    s0, s3 = F1.mul(torch.stack([c0, c3]),
                    torch.stack([py, px])[..., None, :, :]).unbind(0)
    return F12.mul_by_034(f, s0, s3, c4)


def _mul_by_char(qx, qy):
    """Untwist-Frobenius-twist endomorphism on an affine twist point."""
    k = _consts(qx.device)
    return F2.mul(torch.stack([F2.conj(qx), F2.conj(qy)]),
                  torch.stack([k["twist_qx"].expand_as(qx),
                               k["twist_qy"].expand_as(qy)])).unbind(0)


def miller_loop(px, py, qx, qy):
    """Batched Miller loop. px, py: affine G1 coordinates [..., 8, V];
    qx, qy: affine G2 coordinates [..., 2, 8, V]. Returns Fq12 [..., V]."""
    batch = F1.batch_shape(px)
    dev = px.device
    f = F12.one(batch, dev)
    rx, ry, rz = qx, qy, F2.bcast(F2.one((), dev), batch)
    for bit in _ATE_BITS:
        f = F12.sqr(f)
        (rx, ry, rz), cd = _dbl_step(rx, ry, rz)
        f = _ell(f, cd, px, py)
        if bit:
            (rx, ry, rz), ca = _add_step(rx, ry, rz, qx, qy)
            f = _ell(f, ca, px, py)
    # the last two addition steps, with q1 = pi(Q) and q2 = -pi^2(Q)
    q1x, q1y = _mul_by_char(qx, qy)
    q2x, q2y = _mul_by_char(q1x, q1y)
    (rx, ry, rz), c1 = _add_step(rx, ry, rz, q1x, q1y)
    f = _ell(f, c1, px, py)
    _, c2 = _add_step(rx, ry, rz, q2x, F2.neg(q2y))
    return _ell(f, c2, px, py)


# ---------------------------------------------------------------------------
# Final exponentiation
# ---------------------------------------------------------------------------


def _exp_by_neg_x(f):
    """f^(-x) for the BN parameter x (f in the cyclotomic subgroup, where
    the inverse is the conjugate)."""
    acc = f
    for bit in _X_BITS:
        acc = F12.sqr(acc)
        if bit:
            acc = F12.mul(acc, f)
    return F12.conj(acc)


def final_exp(f):
    """Easy part f^((q^6 - 1)(q^2 + 1)), then the hard part's x-adic chain
    (Fuentes-Castaneda et al., as in the JAX package, libff and arkworks)."""
    f = F12.mul(F12.conj(f), F12.inv(f))
    r = F12.mul(frobenius(f, 2), f)
    y0 = _exp_by_neg_x(r)
    y1 = F12.sqr(y0)
    y2 = F12.sqr(y1)
    y3 = F12.mul(y2, y1)
    y4 = _exp_by_neg_x(y3)
    y5 = F12.sqr(y4)
    y6 = F12.conj(_exp_by_neg_x(y5))
    y3 = F12.conj(y3)
    y7 = F12.mul(y6, y4)
    y8 = F12.mul(y7, y3)
    y9 = F12.mul(y8, y1)
    y10 = F12.mul(y8, y4)
    y11 = F12.mul(y10, r)
    y13 = F12.mul(frobenius(y9, 1), y11)
    y14 = F12.mul(frobenius(y8, 2), y13)
    y15 = frobenius(F12.mul(F12.conj(r), y9), 3)
    return F12.mul(y15, y14)


# ---------------------------------------------------------------------------
# High-level API
# ---------------------------------------------------------------------------


def pairing(px, py, qx, qy):
    """Reduced optimal ate pairing e(P, Q) of affine coordinates, batched."""
    return final_exp(miller_loop(px, py, qx, qy))


def g1_affine(p: Point):
    """Projective G1 -> (x, y, valid); an identity becomes the generator's
    coordinates with valid False, so that its pairing stays defined."""
    a = to_affine_batch(G1, p)
    valid = ~G1.is_identity(p)
    dev = p.x.device
    gx, gy = (F1.bcast(F1.const(c, dev), F1.batch_shape(p.x))
              for c in bn254.G1_GEN)
    return F1.select(valid, a.x, gx), F1.select(valid, a.y, gy), valid


def g2_affine(p: Point):
    a = to_affine_batch(G2, p)
    valid = ~G2.is_identity(p)
    dev = p.x.device
    gx, gy = (F2.bcast(F2.const(c, dev), F2.batch_shape(p.x))
              for c in (bn254.G2_GEN_X, bn254.G2_GEN_Y))
    return F2.select(valid, a.x, gx), F2.select(valid, a.y, gy), valid


def _tree_prod(fs):
    """Product of an Fq12 batch along the vector axis -> [..., 1]."""
    n = fs.shape[-1]
    while n > 1:
        h = n // 2
        prod = F12.mul(fs[..., :h], fs[..., h : 2 * h])
        if n % 2:
            prod = torch.cat([prod, fs[..., -1:]], dim=-1)
        fs = prod
        n = (n + 1) // 2
    return fs


def _miller_masked(g1_points: Point, g2_points: Point):
    """Miller values of projective pairs, 1 where either leg is the
    identity."""
    px, py, v1 = g1_affine(g1_points)
    qx, qy, v2 = g2_affine(g2_points)
    fs = miller_loop(px, py, qx, qy)
    return F12.select(v1 & v2, fs, F12.one(F12.batch_shape(fs), fs.device))


def multi_miller(g1_points: Point, g2_points: Point):
    """prod_i miller(P_i, Q_i) over the vector axis, identity legs
    contributing 1 -> Fq12 [..., 1]."""
    return _tree_prod(_miller_masked(g1_points, g2_points))


def _checked(miller, pairs: int, products: int):
    """Whether each final exponentiation of `miller()`'s products is 1,
    as the spans `pairing.checks`, `pairing.miller`, `pairing.final_exp`."""
    with trace.span("pairing.checks", pairs=pairs, products=products):
        with trace.span("pairing.miller"):
            f = miller()
        with trace.span("pairing.final_exp"):
            f = final_exp(f)
        return F12.is_one(f)[..., 0]


def pairing_product_is_one(g1_points: Point, g2_points: Point):
    """prod_i e(P_i, Q_i) == 1 over the vector axis, for every leading
    batch index: G1 [..., 8, n] and G2 [..., 2, 8, n] -> bool [...]."""
    products = math.prod(g1_points.x.shape[:-2])
    return _checked(lambda: multi_miller(g1_points, g2_points),
                    products * g1_points.x.shape[-1], products)


def _grouped_miller(groups, sizes):
    """The product of each group's Miller values -> Fq12 [K, ..., 1]."""
    fs = _miller_masked(point_concat([g for g, _ in groups]),
                        point_concat([g for _, g in groups]))
    dev = fs.device
    total, width = sum(sizes), max(sizes)
    fs = torch.cat([fs, F12.one((1,), dev)], dim=-1)   # column `total` is 1
    idx = torch.full((len(groups), width), total, dtype=torch.long)
    off = 0
    for k, n in enumerate(sizes):
        idx[k, :n] = torch.arange(off, off + n)
        off += n
    g = fs[..., idx.to(dev)].movedim(-2, 0)             # [K, 2,3,2,8, width]
    return _tree_prod(g)


def pairing_checks(groups):
    """For each (G1 [8, n_k], G2 [2, 8, n_k]) in `groups`, whether
    prod_i e(P_i, Q_i) == 1 -> bool [K]. One Miller loop runs over all
    pairs and one final exponentiation over the K products."""
    sizes = [g1.x.shape[-1] for g1, _ in groups]
    return _checked(lambda: _grouped_miller(groups, sizes), sum(sizes),
                    len(groups))


def simple_pairing_check(a1: Point, a2: Point, b1: Point, b2: Point):
    """e(a1, a2) == e(b1, b2), as e(-a1, a2) * e(b1, b2) == 1 with one
    final exponentiation."""
    return pairing_product_is_one(point_concat([G1.neg(a1), b1]),
                                  point_concat([a2, b2]))
