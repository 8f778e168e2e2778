"""CPAC - arithmetic circuits as CPhadL composed with the subspace argument.

Counterpart of `legosnark_tpu/gadgets/arithcirc.py`. A circuit of n
multiplication gates o = l o r and m linear constraints
W (l ‖ r ‖ o) = t over committed wire vectors l, r, o:
  * CPhadL (`gadgets.lipmaa`) proves the gates;
  * the subspace argument (`gadgets.subspace`) proves the wiring with

        [ Z(chi)G     0        0     | L_1..L_n    0       0    ]
        [   0      Z(chi)G     0     |    0     L_1..L_n   0    ]
        [   0         0     Z(chi)G  |    0        0    L_1..L_n ]
        [   0         0        0     |         W_ij G            ]

    (L_i = l_i(chi) G, the Lagrange bases of CPhadL's commitments) for the
    witness w = (d1, d2, d3, l, r, o) and x = (c_l, c_r, c_o, t_1 G ..
    t_m G): it re-derives the three commitments, which binds both
    arguments to the same wires, and enforces the constraints.

Layout: wire vectors [8, n]; the relation's rows on a leading axis,
[3 + m, 8, 3 + 3n].
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..config import resolve_device
from ..curve import bn254
from ..curve import msm as msm_mod
from ..curve import pairing as pr
from ..curve.group import G1, Point, point_concat, point_map, point_stack
from ..fields import limb as fl
from . import lipmaa, subspace

FR = bn254.FR
R = bn254.R


class ACRel(NamedTuple):
    """n gates; W: [m, 3n] int constraint matrix; t: [m] int publics."""

    n: int
    W: Any    # numpy object array of ints
    t: Any    # list of ints


class ACKey(NamedTuple):
    hadl_key: Any          # lipmaa.HadLKey
    ss_key: Any            # subspace.SubspaceKey
    t_points: Point        # [8, m] t_i G, the public right-hand side


class ACProof(NamedTuple):
    ca: Any                # lipmaa.InterpComm of l
    cb: Any                # of r
    cc: Any                # of o
    had_pi: Point
    lin_pi: Point


def proof_size_group_elements() -> dict:
    """Three commitments (a G1 and a G2 leg each) and two proof points."""
    return {"g1": 5, "g2": 3, "fr": 0}


def keygen(rel: ACRel, seed: int = 0, device=None) -> ACKey:
    """CPhadL's key (seed), the relation above, the subspace key of its
    points (seed ^ 0xAC) and the t_i G."""
    dev = resolve_device(device)
    n, m = rel.n, len(rel.t)
    hk = lipmaa.keygen(n, seed, dev)
    lag, zg = hk.interp.lag_g1, hk.interp.z_g1
    id1, idn = G1.identity((1,), dev), G1.identity((n,), dev)

    def row_commit(slot: int) -> Point:
        return point_concat([zg if j == slot else id1 for j in range(3)]
                            + [lag if j == slot else idn for j in range(3)])

    # W_ij G and t_i G in one fixed-base batch multiplication
    ints = [int(v) % R for v in np.asarray(rel.W, dtype=object).reshape(-1)]
    ints += [int(v) % R for v in rel.t]
    pts = msm_mod.batch_scalar_mul(G1, msm_mod.generator_table(G1, dev),
                                   fl.tensor(fl.ints_to_limbs(ints), dev), c=8)
    w_pts = point_map(lambda x: x[..., : m * 3 * n].reshape(
        fl.NLIMBS, m, 3 * n).movedim(-2, 0), pts)                # [m, 8, 3n]
    t_points = point_map(lambda x: x[..., m * 3 * n :], pts)     # [8, m]

    top = point_stack([row_commit(s) for s in range(3)])        # [3, 8, 3+3n]
    bot = point_concat([G1.identity((m, 3), dev), w_pts])        # [m, 8, 3+3n]
    M = point_map(lambda a, b: torch.cat([a, b]), top, bot)
    return ACKey(hk, subspace.keygen(M, seed ^ 0xAC), t_points)


def prove(key: ACKey, l_mont, r_mont, o_mont, d_mont) -> ACProof:
    """The wires' commitments (rows of one commit call, randomness
    d_mont [8, 3]), CPhadL's pi for the gates and the subspace proof for
    the wiring."""
    cms = lipmaa.commit(key.hadl_key.interp,
                        torch.stack([l_mont, r_mont, o_mont]),
                        d_mont.T[:, :, None])
    ca, cb, cc = (lipmaa.InterpComm(*(point_map(lambda x, i=i: x[i], p)
                                      for p in cms)) for i in range(3))
    had_pi = lipmaa.prove(key.hadl_key, l_mont, r_mont, o_mont, d_mont)
    w = torch.cat([d_mont, l_mont, r_mont, o_mont], dim=-1)
    return ACProof(ca, cb, cc, had_pi, subspace.prove(key.ss_key, w))


def verify(key: ACKey, proof: ACProof):
    """CPhadL's equation, the subspace equation and the three
    commitments' well-formedness, as five products of pairings in one
    `pairing_checks` -> bool []."""
    ik = key.hadl_key.interp
    x = point_concat([proof.ca.c, proof.cb.c, proof.cc.c, key.t_points])
    groups = (lipmaa.verify_pairings(key.hadl_key, proof.ca, proof.cb,
                                     proof.cc, proof.had_pi)
              + subspace.verify_pairings(key.ss_key, x, proof.lin_pi))
    for cm in (proof.ca, proof.cb, proof.cc):
        groups += lipmaa.commit_pairings(ik, cm)
    return pr.pairing_checks(groups).all()
