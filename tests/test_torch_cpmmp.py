"""The port's CPmmp prover (keygen -> commit -> prove, honest-verifier
mode) against the JAX package at n = 4, element for element, and the
port's verifier on the JAX package's own proof.

One module-scoped fixture runs the JAX side once: keygen(4, seed=1), the
staged commitments of A and B and the staged in-clear prover (equal to
the monolithic prover, tests/test_staged.py). The port then runs on the
CPU, both with its own keygen and with the JAX key carried over by
`convert`; every proof element is compared as canonical integers or
affine points.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from legosnark_tpu.curve import bn254 as jbn
from legosnark_tpu.curve.group import g1_to_oracle_batch, g2_to_oracle_batch
from legosnark_tpu.gadgets import matrix as jmat
from legosnark_tpu.utils import rand as jrand

from legosnark_tpu_torch import convert
from legosnark_tpu_torch.curve import bn254
from legosnark_tpu_torch.curve.group import Point
from legosnark_tpu_torch.fields import limb as fl
from legosnark_tpu_torch.gadgets import matrix as tmat

# The plain path runs many small torch ops; idle intra-op threads spin and
# starve the other test processes, so the port's tests use one thread.
torch.set_num_threads(1)

D = 2
N = 1 << D


@pytest.fixture(scope="module")
def jax_run():
    rng = np.random.default_rng(11)
    key = jmat.keygen(N, seed=1)
    R = jbn.R
    A = [[jrand.rand_fr_int(rng) for _ in range(N)] for _ in range(N)]
    B = [[jrand.rand_fr_int(rng) for _ in range(N)] for _ in range(N)]
    C = [[sum(a * b for a, b in zip(row, col)) % R for col in zip(*B)]
         for row in A]
    mats = [jnp.asarray(np.stack([jbn.FR.to_mont_ints(r) for r in M]))
            for M in (A, B, C)]
    nonces = jmat.make_nonces(D, seed=3)
    chal = jrand.rand_fr_mont(rng, D)
    hv = {"eq_e": jrand.rand_fr_mont(rng, D),
          "prd_e": jrand.rand_fr_mont(rng, 1)}
    r = jrand.rand_fr_mont(rng, D)
    s = jrand.rand_fr_mont(rng, D)
    a_cm = jmat.commit_matrix_staged(key, mats[0])
    b_cm = jmat.commit_matrix_staged(key, mats[1])
    pf = jmat.prove_output_in_clear_staged(key, mats[0], mats[1], r, s,
                                           nonces, chal, hv)
    return {"key": key, "mats": mats, "nonces": nonces, "chal": chal,
            "hv": hv, "r": r, "s": s, "a_cm": a_cm, "b_cm": b_cm, "pf": pf}


def field(x):
    """JAX Montgomery array -> port tensor on the CPU."""
    return fl.tensor(convert.field_from_jax(np.asarray(x), bn254.FR), "cpu")


def jints(x):
    return [int(v) for v in convert.jax_field_ints(np.asarray(x),
                                                   bn254.FR).reshape(-1)]


def pints(x):
    return [int(v) for v in convert.to_ints(x).reshape(-1)]


def test_keygen_equals_jax(jax_run):
    jk = jax_run["key"].poly_key
    tk = tmat.keygen(N, seed=1, device="cpu").poly_key
    assert len(tk.bases) == len(jk.bases) == 2 * D + 1
    for j in range(2 * D + 1):
        assert convert.to_ints(tk.bases[j]) == g1_to_oracle_batch(jk.bases[j])
        assert convert.to_ints(tk.bases_a[j]) == \
            g1_to_oracle_batch(jk.bases_a[j])
    assert convert.to_ints(tk.g2_s, g2=True) == g2_to_oracle_batch(jk.g2_s)
    assert convert.to_ints(tk.g2_alpha, g2=True) == \
        g2_to_oracle_batch(jk.g2_alpha)
    assert convert.to_ints(tk.g1) == g1_to_oracle_batch(jk.g1)
    assert convert.to_ints(tk.g2, g2=True) == g2_to_oracle_batch(jk.g2)


def test_commit_and_prove_equal_jax(jax_run):
    key = convert.matkey_from_jax(jax_run["key"], "cpu")
    Am, Bm, Cm = (field(m) for m in jax_run["mats"])
    nonces = {k: field(v) for k, v in jax_run["nonces"].items()}
    hv = {k: field(v) for k, v in jax_run["hv"].items()}
    a_cm = tmat.commit_matrix(key, Am)
    b_cm = tmat.commit_matrix(key, Bm)
    pf = tmat.prove_output_in_clear(
        key, Am, Bm, Cm, field(jax_run["r"]), field(jax_run["s"]), nonces,
        challenges=field(jax_run["chal"]), hv_rand=hv)

    for got, want in ((a_cm, jax_run["a_cm"]), (b_cm, jax_run["b_cm"])):
        assert convert.to_ints(got.c) == g1_to_oracle_batch(want.c)
        assert convert.to_ints(got.ca) == g1_to_oracle_batch(want.ca)

    jpf = jax_run["pf"]
    sp, jp = pf.sc_proof, jpf.sc_proof
    assert convert.to_ints(pf.t_comm) == g1_to_oracle_batch(jpf.t_comm)
    assert pints(pf.r) == jints(jpf.r) and pints(pf.s) == jints(jpf.s)
    # h_comms [d, 8, k+1]: round by round
    for i in range(D):
        got = Point(*(t[i] for t in sp.h_comms))
        want = jax.tree.map(lambda t: t[i], jp.h_comms)
        assert convert.to_ints(got) == g1_to_oracle_batch(want)
    assert convert.to_ints(sp.eq_proofs.a) == g1_to_oracle_batch(jp.eq_proofs.a)
    assert pints(sp.eq_proofs.z) == jints(jp.eq_proofs.z)
    assert convert.to_ints(sp.ans_comms) == g1_to_oracle_batch(jp.ans_comms)
    assert len(sp.poly_pfs) == len(jp.poly_pfs) == 2
    for got, want in zip(sp.poly_pfs, jp.poly_pfs):
        assert convert.to_ints(got.witness) == g1_to_oracle_batch(want.witness)
        assert convert.to_ints(got.witnessa) == \
            g1_to_oracle_batch(want.witnessa)
    for f in ("alpha", "beta", "delta"):
        assert convert.to_ints(getattr(sp.prd_proof, f)) == \
            g1_to_oracle_batch(getattr(jp.prd_proof, f)), f
    for f in ("z1", "z2", "z3", "z4", "z5"):
        assert pints(getattr(sp.prd_proof, f)) == \
            jints(getattr(jp.prd_proof, f)), f
    assert pints(sp.finals) == jints(jp.finals)
    assert pf.c_poly_pf is None
    assert convert.to_ints(pf.c_ans_comm) == convert.to_ints(pf.t_comm)


def test_port_verifies_the_jax_proof(jax_run):
    """`convert` carries the JAX package's n = 4 honest-verifier proof, key
    and commitments into the port: the port's verifier accepts them, and
    rejects the proof with its round commitments rotated. This holds the
    verifier against the reference without running the JAX verifier."""
    key = convert.matkey_from_jax(jax_run["key"], "cpu")
    a_cm = convert.polycomm_from_jax(jax_run["a_cm"], "cpu")
    b_cm = convert.polycomm_from_jax(jax_run["b_cm"], "cpu")
    C = field(jax_run["mats"][2])
    pf = convert.matproof_from_jax(jax_run["pf"], "cpu")
    hv = {k: field(v) for k, v in jax_run["hv"].items()}
    assert bool(tmat.verify_output_in_clear(key, a_cm, b_cm, C, pf,
                                            hv_rand=hv))
    sc = pf.sc_proof
    bad = pf._replace(sc_proof=sc._replace(
        h_comms=Point(*(t.roll(1, 0) for t in sc.h_comms))))
    assert not bool(tmat.verify_output_in_clear(key, a_cm, b_cm, C, bad,
                                                hv_rand=hv))
