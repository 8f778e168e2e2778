"""The port's verifiers on the CPU: CPmmp at n = 4 in the honest-verifier
mode and both Fiat-Shamir modes, with tampers; CPpoly openings and
knowledge checks; the sigma protocols.

Every verdict is exact (a pairing product is 1 or not; group elements
are compared projectively). The reference's own tamper tests are
slow-tier and have no recorded green run (ROADMAP R4), so the tampers
here are held to the one requirement that matters: each is rejected.
The Fiat-Shamir transcript absorbs points in the port's own encoding
(ROADMAP R5), so those proofs cannot equal the JAX package's byte for
byte; they are held to verification.
"""
import collections
import contextlib
import io

import numpy as np
import pytest
import torch

from legosnark_tpu_torch.curve import bn254
from legosnark_tpu_torch.curve import pairing as pr
from legosnark_tpu_torch.curve.group import G1, Point, g1_generator
from legosnark_tpu_torch.examples import matrixsc
from legosnark_tpu_torch.fields import limb as fl
from legosnark_tpu_torch.gadgets import matrix as cpmat
from legosnark_tpu_torch.gadgets import poly as cppoly
from legosnark_tpu_torch.gadgets import sigma
from legosnark_tpu_torch.prototools import mle, polytools
from legosnark_tpu_torch.utils import rand as lrand
from legosnark_tpu_torch.utils import trace

# The plain path runs many small torch ops; idle intra-op threads spin and
# starve the other test processes, so the port's tests use one thread.
torch.set_num_threads(1)

FR = bn254.FR


@contextlib.contextmanager
def _traced(spans: list):
    """Tracing on over the block; its spans are appended to `spans`."""
    trace.drain()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        spans += trace.drain()


@pytest.fixture(scope="module")
def hv():
    """The port's own n = 4 honest-verifier keygen -> commit -> prove ->
    verify (the example's `run`, verify included), traced. Its key and
    commitments serve the Fiat-Shamir proofs too. Its printed lines are
    kept under "stdout", its spans under "spans"."""
    out = io.StringIO()
    spans = []
    with contextlib.redirect_stdout(out), _traced(spans):
        res = matrixsc.run(2, device="cpu", fs=False)
    return {**res, "stdout": out.getvalue(), "spans": spans}


@pytest.fixture(scope="module")
def fs(hv):
    """Fiat-Shamir proof of C = A*B with C public, on `hv`'s key and
    commitments, its verdict and the spans of both (traced)."""
    spans = []
    with _traced(spans):
        pf = cpmat.prove_output_in_clear_fs(
            hv["key"], hv["A"], hv["B"], hv["C"], hv["a_comm"],
            hv["b_comm"], hv["nonces"])
        ok = bool(cpmat.verify_output_in_clear_fs(
            hv["key"], hv["a_comm"], hv["b_comm"], hv["C"], pf))
    return pf, ok, spans


@pytest.fixture(scope="module")
def committed(hv):
    """Fiat-Shamir proof with C committed, on `hv`'s key and commitments."""
    c_cm = cpmat.commit_matrix(hv["key"], hv["C"])
    pf = cpmat.prove_fs(hv["key"], hv["A"], hv["B"], hv["C"], hv["a_comm"],
                        hv["b_comm"], c_cm, hv["nonces"])
    return c_cm, pf


def _verify(res, proof=None, C=None):
    return bool(cpmat.verify_output_in_clear(
        res["key"], res["a_comm"], res["b_comm"],
        res["C"] if C is None else C, res["proof"] if proof is None else proof,
        hv_rand=res["hv"]))


def test_hv_round_trip(hv):
    assert hv["ok"] is True


def test_example_reports_proof_size(hv):
    """`run` returns the JAX package's proof size for the same d and
    prints it as the JAX example does."""
    from legosnark_tpu.gadgets import matrix as jmatrix

    want = jmatrix.proof_size_group_elements(hv["key"])
    assert hv["proof_size"] == want
    assert (f"## proof size: {want['g1']} G1 + {want['g2']} G2 + "
            f"{want['fr']} Fr\n") in hv["stdout"]
    assert set(hv["times"]) >= {"keygen_s", "commit_s", "prove_s",
                                "verify_s"}


def _tamper(res, what):
    pf = res["proof"]
    sc = pf.sc_proof
    one = fl.one(FR, (), "cpu")
    if what == "round_commitment_swapped":
        def swap(x):
            y = x.clone()
            y[0, ..., 0], y[0, ..., 1] = x[0, ..., 1], x[0, ..., 0]
            return y
        return pf._replace(sc_proof=sc._replace(
            h_comms=Point(*(swap(t) for t in sc.h_comms)))), None
    if what == "final_changed":
        finals = sc.finals.clone()
        finals[..., :1] = fl.add(FR, finals[..., :1], one)
        return pf._replace(sc_proof=sc._replace(finals=finals)), None
    if what == "opening_witness_changed":
        w = sc.poly_pfs[0]
        bad = w._replace(witness=Point(*(t.roll(1, -1) for t in w.witness)))
        return pf._replace(sc_proof=sc._replace(
            poly_pfs=(bad,) + tuple(sc.poly_pfs[1:]))), None
    C = res["C"].clone()                              # entry of C changed
    C[0, :, :1] = fl.add(FR, C[0, :, :1], one)
    return pf, C


@pytest.mark.parametrize("what", ["round_commitment_swapped",
                                  "final_changed",
                                  "opening_witness_changed",
                                  "c_entry_changed"])
def test_hv_tamper_is_rejected(hv, what):
    proof, C = _tamper(hv, what)
    assert _verify(hv, proof, C) is False


def test_fs_in_clear_round_trip(hv, fs):
    pf, ok, _ = fs
    assert ok is True
    # the challenges were drawn from the transcript, not injected
    assert pf.r.shape == (8, 2) and not torch.equal(pf.r, hv["r"])


def test_fs_in_clear_tamper_is_rejected(hv, fs):
    """Verifying against the commitments in the other order re-derives
    other challenges from the transcript."""
    assert not bool(cpmat.verify_output_in_clear_fs(
        hv["key"], hv["b_comm"], hv["a_comm"], hv["C"], fs[0]))


def _children(spans, parent) -> list:
    return [s.name for s in spans if s.parent == parent.id]


def test_hv_statement_spans(hv):
    """The traced honest-verifier run: the MSMs of commit; the sumcheck
    prover with one span per round, its batched scalar multiplication and
    the openings' MSMs; the verifier's replay, sigma and pairing stages;
    no transcript."""
    spans = hv["spans"]
    by_id = {s.id: s for s in spans}
    top = collections.Counter(s.name for s in spans if s.parent is None)
    # keygen's two fixed-base batches, then the statement's spans
    assert top == {"msm.batch": 2, "msm": 2, "sumcheck.prove": 1,
                   "sumcheck.replay": 1, "sigma.verify": 1,
                   "pairing.checks": 1}
    (prover,) = [s for s in spans if s.name == "sumcheck.prove"]
    assert _children(spans, prover) == ["sumcheck.round"] * 2 + [
        "sigma.smul", "poly.prove"]
    (opening,) = [s for s in spans if s.name == "poly.prove"]
    assert _children(spans, opening) == ["msm"] * 4
    # batched scalar multiplications: the prover's one, one in the
    # verifier's replay, two in its sigma checks
    assert collections.Counter(
        by_id[s.parent].name for s in spans if s.name == "sigma.smul") == {
            "sumcheck.prove": 1, "sumcheck.replay": 1, "sigma.verify": 2}
    assert [s.attrs["round"] for s in spans
            if s.name == "sumcheck.round"] == [0, 1]
    for s in spans:
        if s.name == "msm":
            # a commitment's two legs; the openings' two tables, two each
            assert s.attrs["curve"] == "G1" and s.attrs["rows"] in (2, 4)
            assert _children(spans, s) == ["msm.digits", "msm.chunk",
                                           "msm.horner"]
    (pc,) = [s for s in spans if s.name == "pairing.checks"]
    assert _children(spans, pc) == ["pairing.miller", "pairing.final_exp"]
    # one Miller loop over every equation's pairs, each of two pairs or more
    assert pc.attrs["pairs"] >= 2 * pc.attrs["products"] >= 2


def test_fs_statement_spans(fs):
    """The traced Fiat-Shamir prove and verify: each prover round absorbs
    and squeezes inside its own span; no transcript span nests in another;
    each counts its MiMC permutations."""
    _, _, spans = fs
    by_id = {s.id: s for s in spans}
    tr = [s for s in spans if s.name.startswith("transcript.")]
    assert tr and all(s.counts["mimc.permute"] >= 1 for s in tr)
    assert not any(s.parent in by_id
                   and by_id[s.parent].name.startswith("transcript.")
                   for s in tr)
    rounds = [s for s in spans if s.name == "sumcheck.round"]
    assert len(rounds) == 2
    for r in rounds:
        assert _children(spans, r) == ["transcript.absorb",
                                       "transcript.squeeze"]
        assert r.counts["mimc.permute"] == sum(
            by_id[i].counts["mimc.permute"] for i in by_id
            if by_id[i].parent == r.id)
    assert [s.name for s in spans if s.parent is None].count(
        "pairing.checks") == 1


def test_fs_committed_round_trip(hv, committed):
    c_cm, pf = committed
    assert pf.c_poly_pf is not None
    assert bool(cpmat.verify_fs(hv["key"], hv["a_comm"], hv["b_comm"], c_cm,
                                pf))


def test_fs_committed_tamper_is_rejected(hv, committed):
    """One witness of C's opening moved: C's pairing equations fail."""
    c_cm, pf = committed
    w = pf.c_poly_pf
    bad = pf._replace(c_poly_pf=w._replace(
        witness=Point(*(t.roll(1, -1) for t in w.witness))))
    assert not bool(cpmat.verify_fs(hv["key"], hv["a_comm"], hv["b_comm"],
                                    c_cm, bad))


def test_cppoly_opening_and_knowledge():
    """2 variables: check_commit and verify true; a wrong answer, a
    swapped witness pair and a commitment whose alpha leg is not alpha
    times C are rejected (their equations checked in one batch)."""
    key = cppoly.keygen(2, seed=4, device="cpu")
    rng = np.random.default_rng(8)
    v = lrand.rand_fr_mont(rng, 4, "cpu")
    r = lrand.rand_fr_mont(rng, 2, "cpu")
    cm = cppoly.commit(key, v)
    pf = cppoly.prove(key, v, r)
    ans, wrong = sigma.smul_many([
        (key.g1, mle.eval_mle(v, r)), (key.g1, mle.eval_mle(fl.add(FR, v, v),
                                                             r))])
    swapped = pf._replace(witness=Point(*(t.flip(-1) for t in pf.witness)))
    rw, rw_swapped = (G1.sum_reduce(p) for p in sigma.smul_many(
        [(pf.witness, r), (swapped.witness, r)]))
    groups = (cppoly.commit_pairings(key, cm._replace(ca=cm.c))
              + cppoly.verify_pairings(key, cm, wrong, r, pf, rw=rw)
              + cppoly.verify_pairings(key, cm, ans, r, swapped,
                                       rw=rw_swapped))
    ok = pr.pairing_checks(groups).tolist()
    # [knowledge of the bad commitment], [main, knowledge x2] x 2
    assert ok == [False, False, True, True, False, False, False]
    assert bool(cppoly.verify(key, cm, ans, r, pf))
    assert bool(cppoly.check_commit(key, cm))


def test_sigma_verifiers():
    """ZKEq and ZKPrd: honest proofs verify, wrong statements do not."""
    rng = np.random.default_rng(9)
    g = g1_generator((), "cpu")
    h = sigma._smul(g, lrand.rand_fr_mont(rng, 1, "cpu"))
    x, y, rx, ry, rz, e = (lrand.rand_fr_mont(rng, 1, "cpu")
                           for _ in range(6))
    bs = lrand.rand_fr_mont(rng, 5, "cpu")
    k, r0, r1, v = (lrand.rand_fr_mont(rng, 2, "cpu") for _ in range(4))
    F = sigma.FR_OPS
    xy = F.mul(x, y)
    # the Pedersen commitments of both protocols, in one batch:
    # cx, cy, cz, cz_bad | c0 (2), c1 (2), c1_bad (2)
    vals = torch.cat([x, y, xy, F.add(xy, x), v, v, F.add(v, v)], dim=-1)
    rnds = torch.cat([rx, ry, rz, rz, r0, r1, r1], dim=-1)
    com = sigma.pedersen(g, h, vals, rnds)

    def col(i, m=1):
        return Point(*(t[..., i : i + m] for t in com))

    cx, cy, cz, cz_bad = (col(i) for i in range(4))
    c0, c1, c1_bad = col(4, 2), col(6, 2), col(8, 2)
    prd = sigma.zkprd_prove(x, rx, y, ry, rz, bs, e,
                            sigma.zkprd_commit(g, h, y, ry, bs))
    eq = sigma.ZKEqProof(a=sigma._smul(h, k),
                         z=F.add(k, F.mul(e, F.sub(r0, r1))))
    assert not bool(sigma.zkprd_verify(g, h, cx, cy, cz_bad, prd, e))
    assert sigma.zkeq_verify(h, c0, c1_bad, eq, e).tolist() == [False, False]
    assert bool(sigma.zkprd_verify(g, h, cx, cy, cz, prd, e))
    assert sigma.zkeq_verify(h, c0, c1, eq, e).tolist() == [True, True]


def test_eval_as_poly_on_commitments():
    """sum_j t^j (c_j G) == (sum_j c_j t^j) G, for two points t at once."""
    rng = np.random.default_rng(10)
    g = g1_generator((), "cpu")
    coeffs = lrand.rand_fr_mont(rng, 3, "cpu")
    ts = torch.stack([lrand.rand_fr_mont(rng, 1, "cpu") for _ in range(2)])
    comms, want = sigma.smul_many([
        (g, coeffs), (g, torch.cat([polytools.eval_at(coeffs, t)
                                    for t in ts], dim=-1))])
    got = polytools.eval_as_poly_on(
        Point(*(c.expand(2, -1, -1) for c in comms)), ts)     # [2, 8, 1]
    assert G1.eq(Point(*(c[..., 0].T for c in got)), want).all()


def test_srs_cache_round_trip(tmp_path):
    """keygen_cached writes the key once under the port's own file name
    and a second call loads the same points, bit for bit."""
    key = cppoly.keygen_cached(2, seed=5, cache_dir=tmp_path, device="cpu")
    files = [p.name for p in tmp_path.iterdir()]
    assert files == ["pst13_torch_d2_s5.npz"]
    again = cppoly.keygen_cached(2, seed=5, cache_dir=tmp_path, device="cpu")
    for a, b in zip(key, again):
        pts_a = a if isinstance(a, tuple) and not isinstance(a, Point) else (a,)
        pts_b = b if isinstance(b, tuple) and not isinstance(b, Point) else (b,)
        for p, q in zip(pts_a, pts_b):
            assert all(torch.equal(x, y) for x, y in zip(p, q))
    mkey = cpmat.keygen_cached(2, seed=5, cache_dir=tmp_path, device="cpu")
    assert mkey.d == 1 and torch.equal(mkey.poly_key.bases[0].x,
                                       key.bases[0].x)
