"""The port's CPhad (legosnark_tpu_torch.gadgets.hadamard) at n = 8.

Fast tier, on one module-scoped key, commitments and honest-verifier
proof: the proof checked in host integers by the PST13 trapdoors rebuilt
from keygen's seed (t = c~(rho), the finals equal to the MLEs of a and
b at the round challenges, the round chain closing on
beta(rho, r) a~(r) b~(r), every opening); the HV and Fiat-Shamir proofs
verify; a proof for c != a o b and a proof with two round commitments
swapped do not. Slow tier: keygen, commitments and HV proof equal to the
JAX package's element for element, for the same injected rho,
challenges and sigma values, and the port verifies the JAX proof.
Fiat-Shamir proofs are held to the JAX package by verification, not by
bytes (ROADMAP R5).
"""
import numpy as np
import pytest
import torch

import oracle

from legosnark_tpu_torch import convert
from legosnark_tpu_torch.curve import bn254
from legosnark_tpu_torch.curve.group import Point
from legosnark_tpu_torch.fields import limb as fl
from legosnark_tpu_torch.gadgets import hadamard as cphad
from legosnark_tpu_torch.utils import rand as lrand

# The plain path runs many small torch ops; idle intra-op threads spin and
# starve the other test processes, so the port's tests use one thread.
torch.set_num_threads(1)

R = bn254.R
FR = bn254.FR
D = 3
N = 1 << D
KEY_SEED = 2


def mont(ints):
    return fl.tensor(FR.to_mont_ints(ints), "cpu")


def ints(t):
    return [int(v) for v in convert.to_ints(t).reshape(-1)]


def draws(rng):
    """a, b, c = a o b, then rho, the round challenges and the sigma
    challenges, as ints; the nonces come from `make_nonces`."""
    a = lrand.rand_fr_ints(rng, N)
    b = lrand.rand_fr_ints(rng, N)
    c = [x * y % R for x, y in zip(a, b)]
    rho, chal, eq_e = (lrand.rand_fr_ints(rng, D) for _ in range(3))
    return a, b, c, rho, chal, eq_e, lrand.rand_fr_ints(rng, 1)


@pytest.fixture(scope="module")
def had():
    a, b, c, rho, chal, eq_e, prd_e = draws(np.random.default_rng(31))
    key = cphad.keygen(N, KEY_SEED, "cpu")
    comms = [cphad.commit_vec(key, mont(v)) for v in (a, b, c)]
    sigma = {**cphad.make_nonces(D, seed=3, device="cpu"),
             "eq_e": mont(eq_e), "prd_e": mont(prd_e)}
    pf = cphad.prove(key, mont(a), mont(b), mont(c), mont(rho), mont(chal),
                     sigma)
    return {"vals": (a, b, c), "rho": rho, "chal": chal, "sigma": sigma,
            "key": key, "comms": comms, "proof": pf}


def mle_at(vals, pt):
    for x in pt:
        h = len(vals) // 2
        vals = [(lo + x * (hi - lo)) % R for lo, hi in zip(vals[:h], vals[h:])]
    return vals[0]


def test_hv_proof_satisfies_host_checks(had):
    """Every group element of the proof from host ints and the rebuilt
    trapdoors s (PST13 point) and alpha (knowledge shift)."""
    rng = np.random.default_rng(KEY_SEED ^ 0x9057)
    s_key, alpha = lrand.rand_fr_ints(rng, D), lrand.rand_fr_int(rng)
    G = oracle.G1
    a, b, c = had["vals"]
    pf = had["proof"]
    sc = pf.sc_proof
    rho, r = ints(pf.rho), ints(sc.r)
    assert rho == had["rho"] and r == had["chal"]

    for v, cm in zip((a, b, c), had["comms"]):
        assert convert.to_ints(cm.c) == [oracle.g1_mul(G, mle_at(v, s_key))]
        assert convert.to_ints(cm.ca) == \
            [oracle.g1_mul(G, alpha * mle_at(v, s_key))]
    t = mle_at(c, rho)
    assert convert.to_ints(pf.t_ans_comm) == [oracle.g1_mul(G, t)]
    fa, fb = mle_at(a, r), mle_at(b, r)
    assert ints(sc.finals) == [fa, fb]

    # the round chain: Com(h_i(0)) + Com(h_i(1)) = the running claim,
    # starting at t and closing on beta(rho, r) a~(r) b~(r)
    hc = convert.to_ints(Point(*(x.movedim(0, -2).reshape(8, -1)
                                 for x in sc.h_comms)))
    assert len(hc) == D * 4                         # degree-3 rounds
    claim = oracle.g1_mul(G, t)
    for i in range(D):
        cs = hc[4 * i : 4 * i + 4]
        at01 = cs[0]
        for cj in cs:
            at01 = oracle.g1_add(at01, cj)
        assert at01 == claim, f"round {i}"
        claim = None
        for j, cj in enumerate(cs):
            claim = oracle.g1_add(claim, oracle.g1_mul(cj, pow(r[i], j, R)))
    beta = 1
    for x, y in zip(rho, r):
        beta = beta * (x * y + (1 - x) * (1 - y)) % R
    assert claim == oracle.g1_mul(G, beta * fa * fb)

    # openings: C - ans G = sum_j (s_j - pt_j) W_j, Wa_j = alpha W_j
    opened = ((had["comms"][2], rho, pf.c_poly_pf, t),
              (had["comms"][0], r, sc.poly_pfs[0], fa),
              (had["comms"][1], r, sc.poly_pfs[1], fb))
    assert convert.to_ints(sc.ans_comms) == [oracle.g1_mul(G, fa),
                                             oracle.g1_mul(G, fb)]
    for cm, pt, ppf, ans in opened:
        w, wa = convert.to_ints(ppf.witness), convert.to_ints(ppf.witnessa)
        rhs = None
        for j in range(D):
            rhs = oracle.g1_add(rhs, oracle.g1_mul(w[j], s_key[j] - pt[j]))
            assert wa[j] == oracle.g1_mul(w[j], alpha)
        lhs = oracle.g1_add(convert.to_ints(cm.c)[0],
                            oracle.g1_neg(oracle.g1_mul(G, ans)))
        assert lhs == rhs


def test_hv_proof_verifies(had):
    assert bool(cphad.verify(had["key"], *had["comms"], had["proof"],
                             had["sigma"]))


def test_fs_proof_verifies(had):
    a, b, c = (mont(v) for v in had["vals"])
    nonces = cphad.make_nonces(D, seed=D, device="cpu")
    pf = cphad.prove_fs(had["key"], a, b, c, *had["comms"], nonces)
    assert ints(pf.rho) != had["rho"]           # drawn from the transcript
    assert bool(cphad.verify_fs(had["key"], *had["comms"], pf))


def test_swapped_round_commitments_are_rejected(had):
    pf = had["proof"]
    sc = pf.sc_proof
    bad = pf._replace(sc_proof=sc._replace(
        h_comms=Point(*(t.roll(1, 0) for t in sc.h_comms))))
    assert not bool(cphad.verify(had["key"], *had["comms"], bad,
                                 had["sigma"]))


def test_proof_of_a_wrong_product_is_rejected(had):
    a, b, c = had["vals"]
    c_bad = c[:-1] + [(c[-1] + 1) % R]
    key = had["key"]
    c_cm = cphad.commit_vec(key, mont(c_bad))
    pf = cphad.prove(key, mont(a), mont(b), mont(c_bad), mont(had["rho"]),
                     mont(had["chal"]), had["sigma"])
    assert not bool(cphad.verify(key, had["comms"][0], had["comms"][1],
                                 c_cm, pf, had["sigma"]))


def test_proof_size_counts_the_degree3_rounds(had):
    assert cphad.proof_size_group_elements(had["key"]) == {
        "g1": D * 4 + D + 2 + 3 + 4 * D + 1 + 2 * D, "g2": 0,
        "fr": D + 7 + D}


@pytest.mark.slow
def test_keygen_commit_prove_equal_jax(had):
    """The JAX package's CPhad for the same seeds and injected values,
    element for element; the port also proves on the JAX key carried over
    by `convert`, and verifies the JAX proof."""
    import jax.numpy as jnp
    from legosnark_tpu.curve import bn254 as jbn
    from legosnark_tpu.curve.group import (g1_to_oracle_batch,
                                           g2_to_oracle_batch)
    from legosnark_tpu.gadgets import hadamard as jhad

    def jm(x):
        return jnp.asarray(jbn.FR.to_mont_ints(x))

    def jints(x):
        return [int(v) for v in convert.jax_field_ints(
            np.asarray(x), bn254.FR).reshape(-1)]

    a, b, c, rho, chal, eq_e, prd_e = draws(np.random.default_rng(31))
    jkey = jhad.keygen(N, seed=KEY_SEED)
    jk, tk = jkey.poly_key, had["key"].poly_key
    for j in range(D + 1):
        assert convert.to_ints(tk.bases[j]) == g1_to_oracle_batch(jk.bases[j])
        assert convert.to_ints(tk.bases_a[j]) == \
            g1_to_oracle_batch(jk.bases_a[j])
    assert convert.to_ints(tk.g2_s, g2=True) == g2_to_oracle_batch(jk.g2_s)
    assert convert.to_ints(tk.g2_alpha, g2=True) == \
        g2_to_oracle_batch(jk.g2_alpha)

    jcomms = [jhad.commit_vec(jkey, jm(v)) for v in (a, b, c)]
    for got, want in zip(had["comms"], jcomms):
        assert convert.to_ints(got.c) == g1_to_oracle_batch(want.c)
        assert convert.to_ints(got.ca) == g1_to_oracle_batch(want.ca)
    jn = jhad.make_nonces(D, seed=3)
    jsigma = {**jn, "eq_e": jm(eq_e), "prd_e": jm(prd_e)}
    for k in ("eq_k", "prd_b"):
        assert ints(had["sigma"][k]) == jints(jn[k])
    jpf = jhad.prove(jkey, jm(a), jm(b), jm(c), jm(rho), jm(chal), jsigma)

    key = convert.hadkey_from_jax(jkey, "cpu")
    mine = cphad.prove(key, mont(a), mont(b), mont(c), mont(rho), mont(chal),
                       had["sigma"])
    for pf in (had["proof"], mine):
        sp, jp = pf.sc_proof, jpf.sc_proof
        assert ints(pf.rho) == jints(jpf.rho)
        assert convert.to_ints(pf.t_ans_comm) == \
            g1_to_oracle_batch(jpf.t_ans_comm)
        for got, want in zip((pf.c_poly_pf,) + tuple(sp.poly_pfs),
                             (jpf.c_poly_pf,) + tuple(jp.poly_pfs)):
            assert convert.to_ints(got.witness) == \
                g1_to_oracle_batch(want.witness)
            assert convert.to_ints(got.witnessa) == \
                g1_to_oracle_batch(want.witnessa)
        assert ints(sp.r) == jints(jp.r)
        for i in range(D):
            assert convert.to_ints(Point(*(t[i] for t in sp.h_comms))) == \
                g1_to_oracle_batch(type(jp.h_comms)(
                    *(t[i] for t in jp.h_comms)))
        assert convert.to_ints(sp.eq_proofs.a) == \
            g1_to_oracle_batch(jp.eq_proofs.a)
        assert ints(sp.eq_proofs.z) == jints(jp.eq_proofs.z)
        assert convert.to_ints(sp.ans_comms) == \
            g1_to_oracle_batch(jp.ans_comms)
        assert ints(sp.finals) == jints(jp.finals)
        for f in ("alpha", "beta", "delta"):
            assert convert.to_ints(getattr(sp.prd_proof, f)) == \
                g1_to_oracle_batch(getattr(jp.prd_proof, f))
        for f in ("z1", "z2", "z3", "z4", "z5"):
            assert ints(getattr(sp.prd_proof, f)) == \
                jints(getattr(jp.prd_proof, f))

    tcomms = [convert.polycomm_from_jax(cm, "cpu") for cm in jcomms]
    assert bool(cphad.verify(key, *tcomms,
                             convert.hadproof_from_jax(jpf, "cpu"),
                             had["sigma"]))
