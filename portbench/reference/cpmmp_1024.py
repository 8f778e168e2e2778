"""Plain reference of CPmmp with the output in clear (C = A*B public).

Rebuilds from the inputs alone what an honest prover must send and checks
every equation a verifier would, with the SRS trapdoor standing in for the
pairings:

- the SRS secrets s (2d of them) and alpha, drawn from numpy seed
  `srs_seed ^ 0x9057` as 40-byte little-endian integers mod r, s first;
  the commitment to a matrix M is M~(s) * G and its knowledge leg alpha
  times that (M~ the MLE of M flattened row-major, variable i on bit
  2d-1-i of the index);
- C = A*B by Freivalds' check at a vector drawn from `freivalds_seed`;
- Fiat-Shamir: the MiMC transcript labelled 0x4D4D5243 absorbs A's and
  B's commitment pairs, then all of C, and squeezes r, then s; each
  sumcheck round absorbs its three coefficient commitments before its
  challenge; then the ZKEq first moves (d challenges), the answer
  commitments and the ZKPrd first moves (one challenge). Honest-verifier:
  all of these are the inputs `hv`;
- t = C~(r, s) = sum_k A~(r, k) B~(k, s), t_comm = t G; the sumcheck chain
  through its coefficient commitments; finals = (A~(r, rho), B~(rho, s));
  the ZKEq and ZKPrd equations with H = alpha G; each CPpoly opening
  C - ans G = sum_j (s_j - pt_j) W_j and its alpha legs.

Wide work (MLE folds over 2^20 entries, the mat-vec products, the digest
of C) runs in `_fr_torch` on the inputs' device; the rest in host ints.
"""
from __future__ import annotations

import numpy as np

from . import _bn254 as hb
from . import _fr_torch as F

R = hb.R
G = hb.G1_GEN
LABEL = 0x4D4D5243


def _flat_words(M):
    """[n, 8, n] -> [8, n^2] row-major."""
    n = M.shape[0]
    return M.movedim(0, -2).reshape(M.shape[1], n * n)


def _matvec(M_can, x: list) -> list:
    """M x mod r for a canonical [16, n, n] matrix and host ints x."""
    x_m = F.to_mont(F.from_ints(x, M_can.device))[:, None, :]
    return F.sum_mod(F.mont_mul(M_can, x_m))


def check(inputs: dict, out: dict) -> list:
    """The names of the values and equations of the program's output
    `out` that the reference cannot confirm, for the statement `inputs`
    (A, B canonical limbs and the public C as the program holds it)."""
    bad = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            bad.append(what)

    n = inputs["n"]
    d = n.bit_length() - 1
    A = F.from_words(_flat_words(inputs["A"]))                # [16, n^2]
    B = F.from_words(_flat_words(inputs["B"]))
    BT = F.from_words(_flat_words(inputs["B"].permute(2, 1, 0)))
    C = F.from_mont(F.from_words(_flat_words(inputs["C"])))   # canonical
    A_m, B_m, BT_m, C_m = (F.to_mont(x) for x in (A, B, BT, C))

    # C = A*B (Freivalds), the SRS trapdoor, the commitments
    x = hb.fr_draws(np.random.default_rng(inputs["freivalds_seed"]), n)
    sq = (F.LIMBS, n, n)
    expect(_matvec(C.view(sq), x) == _matvec(A.view(sq),
                                              _matvec(B.view(sq), x)),
           "public output C = A*B (Freivalds)")
    draws = hb.fr_draws(np.random.default_rng(inputs["srs_seed"] ^ 0x9057),
                        2 * d + 1)
    s_key, alpha = draws[: 2 * d], draws[2 * d]
    H = hb.aff_mul(G, alpha)
    comms = []
    for name, M_m in (("A", A_m), ("B", B_m)):
        c = hb.aff_mul(G, F.mle_eval(M_m, s_key)[0])
        ca = hb.aff_mul(c, alpha)
        comms.append((c, ca))
        key = name.lower()
        expect(hb.g1_points(out[f"{key}_c"]) == [c], f"commitment C_{name}")
        expect(hb.g1_points(out[f"{key}_ca"]) == [ca],
               f"commitment Ca_{name}")

    # r and s
    hv = inputs["hv"]
    tr = None
    if hv is None:
        tr = hb.Transcript(LABEL)
        for c, ca in comms:
            tr.absorb_points([c, ca])
        tr.absorb_digest(F.tree_digest(C_m))
        r, s = tr.challenges(d), tr.challenges(d)
    else:
        r, s = hv["r"], hv["s"]
    expect(hb.fr_ints(out["r"]) == r, "row challenges r")
    expect(hb.fr_ints(out["s"]) == s, "column challenges s")

    # the claim and the sumcheck over d rounds
    ta = F.mle_eval(A_m, r)                        # A~(r, k) for every k
    tb = F.mle_eval(BT_m, s)                       # B~(k, s) for every k
    t = sum(a * b for a, b in zip(ta, tb)) % R
    expect(F.mle_eval(C_m, r + s)[0] == t, "C~(r, s) = <A~(r, .), B~(., s)>")
    t_comm = hb.aff_mul(G, t)
    expect(hb.g1_points(out["t_comm"]) == [t_comm], "t_comm = C~(r, s) G")

    hc = hb.g1_points(out["h_comms"])
    k1 = len(hc) // d
    rounds = [hc[i * k1 : (i + 1) * k1] for i in range(d)]
    rho = []
    for i in range(d):
        if tr is not None:
            tr.absorb_points(rounds[i])
            rho.append(tr.challenge())
        else:
            rho.append(hv["chal"][i])
    expect(hb.fr_ints(out["sc_r"]) == rho, "sumcheck challenges")
    claim, v_comms, claims, at_r = t_comm, [], [], []
    for i, c in enumerate(rounds):
        v = hb.aff_add(c[0], hb.aff_sum(c))            # h(0) + h(1)
        expect(v == claim, f"sumcheck round {i}: h(0) + h(1) = claim")
        v_comms.append(v)
        claims.append(claim)
        claim = hb.aff_sum(hb.aff_mul(cj, pow(rho[i], j, R))
                           for j, cj in enumerate(c))
        at_r.append(claim)
    finals = [hb.mle_fold(ta, rho)[0], hb.mle_fold(tb, rho)[0]]
    expect(hb.fr_ints(out["finals"]) == finals, "sumcheck finals")
    expect(claim == hb.aff_mul(G, finals[0] * finals[1]),
           "last round closes on finals[0] * finals[1]")

    # ZKEq per round: z H = a + e (v - claim)
    eq_a = hb.g1_points(out["eq_a"])
    if tr is not None:
        tr.absorb_points(eq_a)
        eq_e = tr.challenges(d)
    else:
        eq_e = hv["eq_e"]
    for i, (a, z) in enumerate(zip(eq_a, hb.fr_ints(out["eq_z"]))):
        diff = hb.aff_add(v_comms[i], hb.aff_neg(claims[i]))
        expect(hb.aff_mul(H, z) == hb.aff_add(a, hb.aff_mul(diff, eq_e[i])),
               f"ZKEq round {i}")

    # answers and the ZKPrd proof of finals[0] * finals[1]
    ans = hb.g1_points(out["ans_comms"])
    expect(ans == [hb.aff_mul(G, f) for f in finals], "answer commitments")
    prd = out["prd"]
    moves = [hb.g1_points(prd[k])[0] for k in ("alpha", "beta", "delta")]
    if tr is not None:
        tr.absorb_points(ans)
        tr.absorb_points(moves)
        e = tr.challenge()
    else:
        e = hv["prd_e"][0]
    z1, z2, z3, z4, z5 = (hb.fr_ints(prd[f"z{i}"])[0] for i in range(1, 6))
    cx, cy, cz = ans[0], ans[1], at_r[-1]
    for i, (lhs, rhs) in enumerate((
            (hb.aff_add(hb.aff_mul(G, z1), hb.aff_mul(H, z2)),
             hb.aff_add(moves[0], hb.aff_mul(cx, e))),
            (hb.aff_add(hb.aff_mul(G, z3), hb.aff_mul(H, z4)),
             hb.aff_add(moves[1], hb.aff_mul(cy, e))),
            (hb.aff_add(hb.aff_mul(cy, z1), hb.aff_mul(H, z5)),
             hb.aff_add(moves[2], hb.aff_mul(cz, e))))):
        expect(lhs == rhs, f"ZKPrd equation {i + 1}")

    # the two CPpoly openings, A at (r || rho) and B at (rho || s)
    for i, (name, pt) in enumerate((("A", r + rho), ("B", rho + s))):
        w, wa = (hb.g1_points(x) for x in out["openings"][i])
        rhs = hb.aff_sum(hb.aff_mul(wj, s_key[j] - pt[j])
                         for j, wj in enumerate(w))
        lhs = hb.aff_add(comms[i][0], hb.aff_neg(hb.aff_mul(G, finals[i])))
        expect(lhs == rhs, f"opening of {name}: C - ans G = sum (s_j - pt_j) W_j")
        expect(wa == [hb.aff_mul(wj, alpha) for wj in w],
               f"opening of {name}: Wa_j = alpha W_j")
    return bad
