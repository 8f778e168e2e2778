"""CPsc - commit-and-prove sumcheck, honest-verifier prover.

Counterpart of `legosnark_tpu/gadgets/sumcheck.py:53-197, 410-414` with
the challenges injected (`challenges`, `rand['eq_e']`, `rand['prd_e']`):

  d rounds producing univariate h_i (degree = number of tables), each
  committed coefficient-wise; per-round ZKEq proofs that h_i(0) + h_i(1)
  equals the running claim; CPpoly openings of the committed MLEs at the
  round challenges; one ZKPrd proof that z_d = a~(r) * b~(r).

Layout: tables [k, 8, 2^d]; challenge lists [8, d]; scalars [8, 1].
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..curve import bn254
from ..curve.group import FR_OPS, G1, Point, point_concat, point_map
from ..fields import limb as fl
from ..prototools import mle, polytools
from . import poly as cppoly
from . import sigma

FR = bn254.FR


class SumcheckProof(NamedTuple):
    r: Any                 # [8, d] round challenges (mont)
    h_comms: Point         # [d, 8, D+1] G1 scalar commitments to h coeffs
    eq_proofs: sigma.ZKEqProof   # batched on the vector axis [8, d]
    ans_comms: Point       # [8, 2] G1 answer commitments (a~(r), b~(r))
    poly_pfs: Any          # tuple of PolyPf
    prd_proof: sigma.ZKPrdProof
    finals: Any            # [8, 2] final answers (mont)


def commit_scalar(g: Point, v_mont) -> Point:
    """Deterministic scalar commitment v*G, batched: v [8, m] -> [8, m]."""
    return G1.scalar_mul(g, fl.from_mont(FR, v_mont))


def prove(key: cppoly.PolyKey, tables, rand, challenges, open_points,
          open_tables):
    """Sumcheck prove over the product of the stacked `tables` [2, 8, 2^d].

    rand: prover nonces 'eq_k' [8, d] and 'prd_b' [8, 5], and the injected
        challenges 'eq_e' [8, d] and 'prd_e' [8, 1].
    challenges: [8, d] round challenges.
    open_points, open_tables: where CPpoly opens and what it opens, one
        point per table.
    Returns (proof, z0) with z0 the claimed sum (mont [8, 1])."""
    d = challenges.shape[-1]
    dev = tables.device
    full = tables
    g, h = key.g1, _blinding(key)

    hs = []
    for i in range(d):
        hs.append(mle.round_poly(full))             # [8, k+1]
        full = mle.fold(full, challenges[..., i : i + 1])
    # the challenges are given, so all rounds' coefficients are committed
    # in one batched scalar multiplication
    k1 = hs[0].shape[-1]
    hc = commit_scalar(g, torch.cat(hs, dim=-1))    # [8, d*(k+1)]
    h_comms = point_map(lambda a: a.reshape(a.shape[:-1] + (d, k1))
                        .movedim(-2, 0), hc)        # [d, 8, k+1]
    z0 = fl.add(FR, polytools.eval_at(hs[0], fl.zero(FR, (), dev)),
                polytools.eval_at(hs[0], fl.one(FR, (), dev)))

    # per-round ZKEq proofs (deterministic commitments: r0 == r1 == 0)
    eq_pfs = sigma.ZKEqProof(
        a=sigma._smul(h, rand["eq_k"]),
        z=FR_OPS.add(rand["eq_k"],
                     FR_OPS.mul(rand["eq_e"], FR_OPS.zero((d,), dev))))

    ans, ans_c, pfs = [], [], []
    for t, pt in zip(open_tables, open_points):
        a_val, a_com = cppoly.compute_answer(key, t, pt)
        ans.append(a_val)
        ans_c.append(a_com)
        pfs.append(cppoly.prove(key, t, pt))

    # final product proof: z_d = a~(r) * b~(r)
    zero = FR_OPS.zero((), dev)
    prd = sigma.zkprd_prove(g, h, ans[0], zero,
                            ans[1], zero, zero, rand["prd_b"], rand["prd_e"])

    proof = SumcheckProof(
        r=challenges, h_comms=h_comms, eq_proofs=eq_pfs,
        ans_comms=point_concat(ans_c), poly_pfs=tuple(pfs), prd_proof=prd,
        finals=torch.cat(ans, dim=-1))
    return proof, z0


def _blinding(key: cppoly.PolyKey) -> Point:
    """Blinding base H for scalar commitments: the last alpha-shifted
    base (independent of G while alpha stays secret)."""
    return point_map(lambda x: x[..., -1:], key.bases_a[cppoly.poly_d(key)])
