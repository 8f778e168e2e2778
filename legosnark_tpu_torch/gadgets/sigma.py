"""Sigma-protocol proofs over Pedersen commitments (prover side).

Counterpart of `legosnark_tpu/gadgets/sigma.py:30-97`: scalar Pedersen
commitments C = v*G + r*H over G1, the Chaum-Pedersen equality proof
and the CP93 product proof, with injected challenges.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..curve import bn254
from ..curve.group import FR_OPS, G1, Point, point_map
from ..fields import limb as fl

FR = bn254.FR


def _smul(p: Point, k_mont) -> Point:
    """k*P with the point broadcast across the scalar batch: p [.., 8, 1]
    against k [8, m] gives [.., 8, m]."""
    return G1.scalar_mul(p, fl.from_mont(FR, k_mont))


def _col(p: Point, i: int) -> Point:
    return point_map(lambda a: a[..., i : i + 1], p)


class ZKEqProof(NamedTuple):
    """Com(v; r0) and Com(v; r1) hide the same value: a Schnorr proof of
    opening of c0 - c1 = (r0 - r1)*H to zero."""

    a: Point  # first move k*H
    z: Any    # response k + e*(r0 - r1), Montgomery Fr


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


def zkprd_prove(g: Point, h: Point, x, rx, y, ry, rz, bs, e) -> ZKPrdProof:
    """bs [8, 5] prover nonces, e [8, 1] challenge; cx = Com(x; rx),
    cy = Com(y; ry), cz = Com(x*y; rz)."""
    F = FR_OPS
    b1, b2, b3, b4, b5 = (bs[..., i : i + 1] for i in range(5))
    # the four Pedersen commitments cy, alpha, beta and delta's H leg,
    # with one batched scalar multiplication per base
    gs = _smul(g, torch.cat([y, b1, b3], dim=-1))
    hs = _smul(h, torch.cat([ry, b2, b4, b5], dim=-1))
    cy, alpha, beta = (G1.add(_col(gs, i), _col(hs, i)) for i in range(3))
    delta = G1.add(_smul(cy, b1), _col(hs, 3))
    z1 = F.add(b1, F.mul(e, x))
    z2 = F.add(b2, F.mul(e, rx))
    z3 = F.add(b3, F.mul(e, y))
    z4 = F.add(b4, F.mul(e, ry))
    z5 = F.add(b5, F.mul(e, F.sub(rz, F.mul(x, ry))))
    return ZKPrdProof(alpha, beta, delta, z1, z2, z3, z4, z5)
