"""Sigma-protocol proofs over Pedersen commitments.

Counterpart of `legosnark_tpu/gadgets/sigma.py`: scalar Pedersen
commitments C = v*G + r*H over G1, the Chaum-Pedersen equality proof
and the CP93 product proof, with their verifiers. Each verifier runs all
of its scalar multiplications as one batched call.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..curve import bn254
from ..curve.group import FR_OPS, G1, Point, point_concat, point_map
from ..fields import limb as fl
from ..utils import trace

FR = bn254.FR


def _smul(p: Point, k_mont) -> Point:
    """k*P with the point broadcast across the scalar batch: p [.., 8, 1]
    against k [8, m] gives [.., 8, m]."""
    return G1.scalar_mul(p, fl.from_mont(FR, k_mont))


def _col(p: Point, i: int) -> Point:
    return point_map(lambda a: a[..., i : i + 1], p)


@trace.spanned("sigma.smul")
def smul_many(terms) -> list:
    """[(P_k, s_k), ...] -> [s_k * P_k] in one batched scalar
    multiplication: P_k a G1 batch [..., 8, m] and s_k Montgomery Fr
    scalars broadcastable against it (a [8, 1] point against [8, m]
    scalars, say). Each product keeps the broadcast shape of its pair.
    Each call is one span `sigma.smul` (`utils/trace`)."""
    shapes, pts, ks = [], [], []
    for p, k in terms:
        shape = torch.broadcast_shapes(p.x.shape, k.shape)
        shapes.append(shape)
        pts.append(point_map(lambda a: _flat(a.expand(shape)), p))
        ks.append(_flat(k.expand(shape)))
    out = _smul(point_concat(pts), torch.cat(ks, dim=-1))
    res, off = [], 0
    for shape in shapes:
        m = pts[len(res)].x.shape[-1]
        res.append(point_map(lambda a, o=off, m=m, sh=shape: _unflat(
            a[..., o : o + m], sh), out))
        off += m
    return res


def _flat(t):
    """[..., 8, m] -> [8, M] (the limb axis first, everything else flat)."""
    return t.movedim(-2, 0).reshape(t.shape[-2], -1)


def _unflat(t, shape):
    return t.reshape((shape[-2],) + shape[:-2] + shape[-1:]).movedim(0, -2)


def pedersen(g: Point, h: Point, v_mont, r_mont) -> Point:
    """C = v*G + r*H."""
    gv, hr = smul_many([(g, v_mont), (h, r_mont)])
    return G1.add(gv, hr)


class ZKEqProof(NamedTuple):
    """Com(v; r0) and Com(v; r1) hide the same value: a Schnorr proof of
    opening of c0 - c1 = (r0 - r1)*H to zero."""

    a: Point  # first move k*H
    z: Any    # response k + e*(r0 - r1), Montgomery Fr


def zkeq_prove(h: Point, r0, r1, k, e) -> ZKEqProof:
    """k the prover's nonce, e the challenge: Montgomery Fr [8, 1], or
    [8, d] for d independent proofs in one call."""
    return ZKEqProof(_smul(h, k),
                     FR_OPS.add(k, FR_OPS.mul(e, FR_OPS.sub(r0, r1))))


def zkeq_verify(h: Point, c0: Point, c1: Point, pf: ZKEqProof, e):
    """z*H == a + e*(c0 - c1), batched over the vector axis -> bool [m]."""
    zh, ed = smul_many([(h, pf.z), (G1.add(c0, G1.neg(c1)), e)])
    return G1.eq(zh, G1.add(pf.a, ed))


class ZKPrdProof(NamedTuple):
    """CP93 product argument: cz hides x*y given cx, cy."""

    alpha: Point
    beta: Point
    delta: Point
    z1: Any
    z2: Any
    z3: Any
    z4: Any
    z5: Any


def zkprd_commit(g: Point, h: Point, y, ry, bs):
    """The first moves (alpha, beta, delta) of the product proof: they
    depend on the nonces bs [8, 5] and on y, ry only, so a Fiat-Shamir
    prover absorbs them before it draws the challenge. The Pedersen legs
    take one batched scalar multiplication per base pair."""
    gs, hs = smul_many([
        (g, torch.cat([y, bs[..., 0:1], bs[..., 2:3]], dim=-1)),
        (h, torch.cat([ry, bs[..., 1:2], bs[..., 3:5]], dim=-1))])
    return zkprd_moves(gs, hs, bs)


def zkprd_moves(gs: Point, hs: Point, bs):
    """(alpha, beta, delta) from the G legs (y, b1, b3)*G [8, 3] and the
    H legs (ry, b2, b4, b5)*H [8, 4]."""
    cy, alpha, beta = (G1.add(_col(gs, i), _col(hs, i)) for i in range(3))
    delta = G1.add(_smul(cy, bs[..., 0:1]), _col(hs, 3))
    return alpha, beta, delta


def zkprd_prove(x, rx, y, ry, rz, bs, e, moves) -> ZKPrdProof:
    """bs [8, 5] prover nonces, e [8, 1] challenge, `moves` the first
    moves (`zkprd_commit`) for the same nonces; cx = Com(x; rx),
    cy = Com(y; ry), cz = Com(x*y; rz)."""
    F = FR_OPS
    alpha, beta, delta = moves
    b1, b2, b3, b4, b5 = (bs[..., i : i + 1] for i in range(5))
    z1 = F.add(b1, F.mul(e, x))
    z2 = F.add(b2, F.mul(e, rx))
    z3 = F.add(b3, F.mul(e, y))
    z4 = F.add(b4, F.mul(e, ry))
    z5 = F.add(b5, F.mul(e, F.sub(rz, F.mul(x, ry))))
    return ZKPrdProof(alpha, beta, delta, z1, z2, z3, z4, z5)


def zkprd_verify(g: Point, h: Point, cx: Point, cy: Point, cz: Point,
                 pf: ZKPrdProof, e):
    """The three group equations, with one batched scalar multiplication:
      z1*G + z2*H == alpha + e*cx
      z3*G + z4*H == beta  + e*cy
      z1*cy + z5*H == delta + e*cz
    -> bool []."""
    gz1, gz3, cyz1, hz2, hz4, hz5, cxe, cye, cze = smul_many([
        (g, pf.z1), (g, pf.z3), (cy, pf.z1), (h, pf.z2), (h, pf.z4),
        (h, pf.z5), (cx, e), (cy, e), (cz, e)])
    lhs = G1.add(point_concat([gz1, gz3, cyz1]),
                 point_concat([hz2, hz4, hz5]))
    rhs = G1.add(point_concat([pf.alpha, pf.beta, pf.delta]),
                 point_concat([cxe, cye, cze]))
    return G1.eq(lhs, rhs).all()
