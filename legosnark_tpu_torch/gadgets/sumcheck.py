"""CPsc - commit-and-prove sumcheck.

Counterpart of `legosnark_tpu/gadgets/sumcheck.py:53-197, 268-350,
410-414`:

  prover: d rounds producing univariate h_i (degree = number of tables),
          each committed coefficient-wise; per-round ZKEq proofs that
          h_i(0) + h_i(1) equals the running claim; CPpoly openings of
          the committed MLEs at the round challenges; one ZKPrd proof
          that z_d = beta(rho, r) * a~(r) * b~(r).
  verifier: replays the round checks on the commitments
          (`polytools.eval_as_poly_on`), checks the CPpoly openings and
          the product proof.

Two shapes. Matrix mode (CPmmp) proves sum_p a[p] * b[p] (beta == 1);
with a weight table beta = eq(rho, .) (`beta_table`, CPhad) the rounds
have degree 3 and the verifier evaluates beta(rho, r) in closed form
(`beta_point_fn`).

Two modes. Honest-verifier: the challenges are given (`challenges`,
`rand['eq_e']`, `rand['prd_e']`). Fiat-Shamir: a `Transcript` absorbs
each round's h commitments before that round's challenge, the ZKEq first
moves before eq_e, and the answer commitments and ZKPrd first moves
before prd_e, in the JAX package's order; the verifier recomputes every
challenge from the proof (the proof's `r` is not read).

Layout: tables [k, 8, 2^d]; challenge lists [8, d]; scalars [8, 1].
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..curve import bn254
from ..curve import pairing as pr
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


def proof_size_group_elements(d: int, k: int) -> dict:
    """Proof size of d rounds of degree k (`SumcheckPf::getSize`): the
    h coefficient commitments, the ZKEq first moves and the two answer
    commitments, the ZKPrd first moves and two CPpoly proofs in G1; the
    ZKEq and ZKPrd responses and the finals in Fr."""
    return {"g1": d * (k + 1) + d + 2 + 3 + 2 * 2 * d, "g2": 0,
            "fr": d + 5 + 2}


def commit_scalar(g: Point, v_mont) -> Point:
    """Deterministic scalar commitment v*G, batched: v [8, m] -> [8, m]."""
    return G1.scalar_mul(g, fl.from_mont(FR, v_mont))


def prove(key: cppoly.PolyKey, tables, rand, open_points_fn, open_tables,
          challenges=None, transcript=None, beta_table=None,
          extra_openings=()):
    """Sumcheck prove over the product of the stacked `tables` [2, 8, 2^d],
    times `beta_table` [8, 2^d] when one is given.

    rand: prover nonces 'eq_k' [8, d] and 'prd_b' [8, 5], and in
        honest-verifier mode the challenges 'eq_e' [8, d] and 'prd_e'
        [8, 1].
    challenges: [8, d] round challenges (honest-verifier mode), or None
        with a `transcript` (Fiat-Shamir mode).
    open_points_fn: maps the [8, d] round challenges to the points where
        CPpoly opens `open_tables`, one per table.
    extra_openings: (table, point) pairs of further CPpoly openings of
        the same size, proved with the sumcheck's own (one MSM per round
        for all of them).
    Returns (proof, z0, z0_comm, extra_pfs): the claimed sum (mont
    [8, 1]), its commitment z0*G and the PolyPf of each extra opening."""
    if (challenges is None) == (transcript is None):
        raise ValueError("give either challenges or a transcript")
    d = tables.shape[-1].bit_length() - 1
    dev = tables.device
    full = tables if beta_table is None else torch.cat(
        [beta_table[None], tables])
    g, h = key.g1, _blinding(key)

    hs, hcs, rs = [], [], []
    for i in range(d):
        hpoly = mle.round_poly(full)                # [8, k+1]
        if transcript is not None:
            hc = commit_scalar(g, hpoly)
            transcript.absorb_point(hc)
            hcs.append(hc)
            r = transcript.challenge()
        else:
            r = challenges[..., i : i + 1]
        hs.append(hpoly)
        rs.append(r)
        full = mle.fold(full, r)
    r_stack = torch.cat(rs, dim=-1)
    z0 = fl.add(FR, polytools.eval_at(hs[0], fl.zero(FR, (), dev)),
                polytools.eval_at(hs[0], fl.one(FR, (), dev)))
    points = open_points_fn(r_stack)
    ans = [mle.eval_mle(t, pt) for t, pt in zip(open_tables, points)]
    zero = FR_OPS.zero((), dev)

    # one batched scalar multiplication: the ZKEq first moves, the
    # answer commitments and z0's, the ZKPrd Pedersen legs and, with
    # injected challenges, every round's h commitments
    nb = rand["prd_b"]
    terms = [(h, rand["eq_k"]), (g, torch.cat(ans + [z0], dim=-1)),
             (g, torch.cat([ans[1], nb[..., 0:1], nb[..., 2:3]], dim=-1)),
             (h, torch.cat([zero, nb[..., 1:2], nb[..., 3:5]], dim=-1))]
    if transcript is None:
        terms.append((g, torch.stack(hs)))          # [d, 8, k+1]
    prods = sigma.smul_many(terms)
    a_eq, ans_z0, gs, hs_ = prods[:4]
    ans_comms = point_map(lambda x: x[..., :2], ans_z0)
    z0_comm = point_map(lambda x: x[..., 2:], ans_z0)
    if transcript is None:
        h_comms = prods[4]
    else:
        h_comms = point_map(lambda *a: torch.stack(a), *hcs)
    moves = sigma.zkprd_moves(gs, hs_, nb)

    if transcript is not None:
        transcript.absorb_point(a_eq)
        eq_e = transcript.challenges(d)
    else:
        eq_e = rand["eq_e"]
    eq_pfs = sigma.ZKEqProof(
        a=a_eq, z=FR_OPS.add(rand["eq_k"],
                             FR_OPS.mul(eq_e, FR_OPS.zero((d,), dev))))
    opened = list(zip(open_tables, points)) + list(extra_openings)
    pfs = cppoly.unstack(cppoly.prove(
        key, torch.stack([t for t, _ in opened]),
        torch.stack([pt for _, pt in opened])))

    # final product proof: z_d = (beta(rho, r) * a~(r)) * b~(r), the
    # folded weight table's value standing for beta(rho, r)
    lhs = ans[0] if beta_table is None else fl.mont_mul(FR, full[0], ans[0])
    if transcript is not None:
        transcript.absorb_point(ans_comms)
        transcript.absorb_point(point_concat(moves))
        prd_e = transcript.challenge()
    else:
        prd_e = rand["prd_e"]
    prd = sigma.zkprd_prove(lhs, zero, ans[1], zero, zero, nb, prd_e, moves)

    k = len(open_tables)
    proof = SumcheckProof(
        r=r_stack, h_comms=h_comms, eq_proofs=eq_pfs, ans_comms=ans_comms,
        poly_pfs=tuple(pfs[:k]), prd_proof=prd, finals=torch.cat(ans, dim=-1))
    return proof, z0, z0_comm, pfs[k:]


def verify(key: cppoly.PolyKey, z0_comm: Point, mle_comms, proof,
           open_points_fn, rand=None, transcript=None, z0_mont=None,
           extra_openings=(), beta_point_fn=None):
    """Sumcheck verify -> bool [] (on the proof's device).

    z0_comm: commitment to the claimed sum; with `z0_mont` (a claim the
    verifier knows in the clear) z0_comm must commit to it. mle_comms:
    the PolyComm of each committed MLE. open_points_fn: as in `prove`.
    rand: the honest-verifier challenges {'eq_e', 'prd_e'}; or a
    `transcript`, from which every challenge is recomputed.
    extra_openings: (PolyComm, answer commitment, point, PolyPf) of
    further CPpoly openings to check with the sumcheck's own.
    beta_point_fn: r [8, d] -> beta(rho, r) [8, 1] for a proof made with
    a `beta_table`; the product proof is then checked against
    beta(rho, r) * ans_a.

    The proof carries its answers in the clear (`finals`); they must be
    the values its answer commitments commit to.

    One batched scalar multiplication (`sigma.smul_many`) evaluates
    every round's h_i on its commitments at 0, 1 and r_i
    (`polytools.eval_as_poly_on`, all rounds at once), commits the finals
    and z0, and forms sum_i r_i W_i of each opening; then
    `sigma.zkeq_verify` checks the ZKEq proofs of all rounds and
    `sigma.zkprd_verify` the ZKPrd proof. All CPpoly pairing equations go
    to one `pairing_checks` call. The
    verdict is read after each of the three stages, and a failed stage
    ends the verification (a rejected proof costs no pairing)."""
    if (rand is None) == (transcript is None):
        raise ValueError("give either rand or a transcript")
    hcomms = proof.h_comms                              # [d, 8, k+1]
    d, k1 = hcomms.x.shape[0], hcomms.x.shape[-1]
    dev = hcomms.x.device
    g, h = key.g1, _blinding(key)

    if transcript is not None:
        rs = []
        for i in range(d):
            transcript.absorb_point(point_map(lambda x, i=i: x[i], hcomms))
            rs.append(transcript.challenge())
        r_stack = torch.cat(rs, dim=-1)
        transcript.absorb_point(proof.eq_proofs.a)
        eq_e = transcript.challenges(d)
        transcript.absorb_point(proof.ans_comms)
        pp = proof.prd_proof
        transcript.absorb_point(point_concat([pp.alpha, pp.beta, pp.delta]))
        prd_e = transcript.challenge()
    else:
        r_stack, eq_e, prd_e = proof.r, rand["eq_e"], rand["prd_e"]

    openings = [(cm, point_map(lambda x, i=i: x[..., i : i + 1],
                               proof.ans_comms), pt, pf)
                for i, (cm, pt, pf) in enumerate(zip(
                    mle_comms, open_points_fn(r_stack), proof.poly_pfs))]
    openings += list(extra_openings)

    # round replay: h_i at (0, 1, r_i) on the commitments, as [d, 3, 8, 1]
    at = torch.stack([fl.zero(FR, (d,), dev), fl.one(FR, (d,), dev),
                      r_stack]).movedim(-1, 0)[..., None]
    terms = [(point_map(lambda x: x[:, None], hcomms),
              polytools.powers_of(at, k1)), (g, proof.finals)]
    terms += [(pf.witness, pt) for _, _, pt, pf in openings]
    ans_a = point_map(lambda x: x[..., 0:1], proof.ans_comms)
    ans_b = point_map(lambda x: x[..., 1:2], proof.ans_comms)
    if beta_point_fn is not None:
        terms.append((ans_a, beta_point_fn(r_stack)))
    if z0_mont is not None:
        terms.append((g, z0_mont))
    prods = sigma.smul_many(terms)
    ev = G1.sum_reduce(prods[0])
    checks = [G1.eq(prods[1], proof.ans_comms).all()]
    rws = [G1.sum_reduce(p) for p in prods[2 : 2 + len(openings)]]
    rest = prods[2 + len(openings):]
    lhs_comm = ans_a if beta_point_fn is None else rest.pop(0)
    if z0_mont is not None:
        checks.append(G1.eq(rest.pop(0), z0_comm).all())
    if not bool(torch.stack(checks).all()):
        return torch.zeros((), dtype=torch.bool, device=dev)

    def rounds(p):
        """[d, 8, 1] -> [8, d]: the rounds onto the vector axis."""
        return point_map(lambda x: x[..., 0].movedim(0, -1), p)

    v_comm = rounds(G1.add(point_map(lambda x: x[:, 0], ev),
                           point_map(lambda x: x[:, 1], ev)))
    at_r = rounds(point_map(lambda x: x[:, 2], ev))
    claims = point_concat([z0_comm, point_map(lambda x: x[..., :-1], at_r)])
    z_comm = point_map(lambda x: x[..., -1:], at_r)
    eq_ok = sigma.zkeq_verify(h, v_comm, claims, proof.eq_proofs, eq_e)
    prd_ok = sigma.zkprd_verify(g, h, lhs_comm, ans_b, z_comm,
                                proof.prd_proof, prd_e)
    if not bool(eq_ok.all() & prd_ok):
        return torch.zeros((), dtype=torch.bool, device=dev)

    groups = []
    for (cm, ansc, pt, pf), rw in zip(openings, rws):
        groups += cppoly.commit_pairings(key, cm)
        groups += cppoly.verify_pairings(key, cm, ansc, pt, pf, rw=rw)
    return pr.pairing_checks(groups).all()


def _blinding(key: cppoly.PolyKey) -> Point:
    """Blinding base H for scalar commitments: the last alpha-shifted
    base (independent of G while alpha stays secret)."""
    return point_map(lambda x: x[..., -1:], key.bases_a[cppoly.poly_d(key)])
