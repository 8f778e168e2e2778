"""The port's Groth16 and its `legogrothmatrix` example at n = 2 (a 2 x 2
matrix product: 8 constraints, 17 variables, 4 public outputs).

Fast tier, on one module-scoped run of `legogrothmatrix.run(2, "cpu")`
(setup with seed 2, prove with seed 2):
* `matmul_r1cs(n)` and `assign` equal the JAX package's for n = 1, 2, 3,
  4 (host Python on both sides);
* every key element equals a host-int scalar times its generator
  (tests/oracle.py), with the trapdoor drawn again from the seed and the
  QAP values computed here from per-row Lagrange values;
* A, B and C equal the host-int scalars built from the trapdoor and the
  draws of r and s, which holds the NTT quotient pipeline and every MSM
  without a pairing;
* with a window budget that splits prove's MSMs into chunks, the example
  gives the same key and proof, bit for bit, untraced (the module run is
  traced), and a traced prove counts each MSM's chunks (`msm.chunks`);
* keygen's spans: `groth16.setup`, its host QAP and one fixed-base batch
  per curve with its chunks (`msm.batch_chunks`);
* the example prints the proof size and VERIFY OK; one `pairing_checks`
  call accepts the honest proof and rejects a changed public output and
  A swapped with C;
* without a card and without `device="cpu"` the entry points raise.
Slow tier: the JAX package's setup and prove at n = 2 (seeds 2 and 3)
equal the port's element for element, and the port's verifier accepts
the JAX proof.
"""
import contextlib
import io
import time

import numpy as np
import pytest
import torch

import oracle

from legosnark_tpu_torch import config, convert
from legosnark_tpu_torch.curve import bn254
from legosnark_tpu_torch.curve import msm
from legosnark_tpu_torch.curve import pairing as pr
from legosnark_tpu_torch.curve.group import G1, G2
from legosnark_tpu_torch.examples import legogrothmatrix
from legosnark_tpu_torch.gadgets import groth16
from legosnark_tpu_torch.utils import rand as lrand
from legosnark_tpu_torch.utils import trace

# The plain path runs many small torch ops; idle intra-op threads spin and
# starve the other test processes, so the port's tests use one thread.
torch.set_num_threads(1)

R = bn254.R
N = 2


@pytest.fixture(scope="module", autouse=True)
def _inference_mode():
    """No autograd bookkeeping for the plain path's many small ops."""
    with torch.inference_mode():
        yield


@pytest.fixture(scope="module")
def run():
    """`legogrothmatrix.run(2, "cpu")` with its printed lines, traced:
    its spans under "spans"."""
    buf = io.StringIO()
    trace.drain()
    trace.enable()
    try:
        with contextlib.redirect_stdout(buf):
            res = legogrothmatrix.run(N, "cpu")
    finally:
        trace.disable()
    res["stdout"] = buf.getvalue()
    res["spans"] = trace.drain()
    return res


def g1(k):
    return oracle.g1_mul(oracle.G1, k % R)


def g2(k):
    return oracle.g2_mul(oracle.G2, k % R)


def trapdoor(seed):
    """tau, alpha, beta, gamma, delta as `setup` draws them."""
    return lrand.rand_fr_ints(np.random.default_rng(seed ^ 0x6706), 5)


def lagrange(tau, d):
    """L_j(tau) over the domain of size d, each by its own inversion
    (setup batches them)."""
    from legosnark_tpu.curve import bn254 as jbn

    root = jbn.fr_two_adic_root(d.bit_length() - 1)
    z_tau = (pow(tau, d, R) - 1) % R
    return [z_tau * pow(root, j, R) * pow(d * (tau - pow(root, j, R)), -1, R)
            % R for j in range(d)]


def qap(r1cs, tau):
    """(u, v, w) at tau, and the domain size."""
    d = 1 << (len(r1cs.A) - 1).bit_length()
    lag = lagrange(tau, d)
    out = []
    for rows in (r1cs.A, r1cs.B, r1cs.C):
        acc = [0] * r1cs.num_vars
        for row, lj in zip(rows, lag):
            for var, coef in row:
                acc[var] = (acc[var] + coef * lj) % R
        out.append(acc)
    return out, d


def proof_scalars(r1cs, z, setup_seed, prove_seed):
    """The discrete logs of A, B and C from the trapdoor and r, s."""
    tau, alpha, beta, _, delta = trapdoor(setup_seed)
    (u, v, w), _ = qap(r1cs, tau)
    r, s = lrand.rand_fr_ints(np.random.default_rng(prove_seed ^ 0x6707), 2)
    a = sum(x * y for x, y in zip(z, u)) % R
    b = sum(x * y for x, y in zip(z, v)) % R
    c = sum(x * y for x, y in zip(z, w)) % R
    npub = r1cs.num_public + 1
    priv = sum(z[i] * (beta * u[i] + alpha * v[i] + w[i])
               for i in range(npub, r1cs.num_vars))
    A = (alpha + a + r * delta) % R
    B = (beta + b + s * delta) % R
    C = ((priv + a * b - c) * pow(delta, -1, R) + s * A + r * B
         - r * s * delta) % R
    return A, B, C


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_matmul_r1cs_equals_jax(n):
    from legosnark_tpu.gadgets import groth16 as jg16

    mine, assign = groth16.matmul_r1cs(n)
    theirs, jassign = jg16.matmul_r1cs(n)
    assert tuple(mine) == tuple(theirs)
    assert mine.num_vars == n ** 3 + 2 * n ** 2 + 1
    rng = np.random.default_rng(n)
    A = [lrand.rand_fr_ints(rng, n) for _ in range(n)]
    B = [lrand.rand_fr_ints(rng, n) for _ in range(n)]
    assert assign(A, B) == jassign(A, B)


@pytest.mark.parametrize("d", [1, 2, 8, 64])
def test_lagrange_values_equal_per_value_inversion(d):
    tau = trapdoor(5)[0]
    assert groth16.lagrange_at(tau, d) == lagrange(tau, d)
    assert groth16.batch_inv_ints([3, 0, R - 1, 0]) == \
        [pow(3, -1, R), 0, R - 1, 0]


def test_setup_equals_host_ints(run):
    r1cs, pk, vk = run["r1cs"], run["pk"], run["vk"]
    tau, alpha, beta, gamma, delta = trapdoor(N)
    (u, v, w), d = qap(r1cs, tau)
    npub = r1cs.num_public + 1
    comb = [beta * a + alpha * b + c for a, b, c in zip(u, v, w)]
    dinv, ginv = pow(delta, -1, R), pow(gamma, -1, R)
    assert pk.domain == d == 8
    g1_want = {
        "alpha_g1": [alpha], "beta_g1": [beta], "delta_g1": [delta],
        "a_query": u, "b1_query": v,
        "h_query": [pow(tau, i, R) * (pow(tau, d, R) - 1) * dinv
                    for i in range(d - 1)],
        "l_query": [x * dinv for x in comb[npub:]]}
    for f, scalars in g1_want.items():
        assert convert.to_ints(getattr(pk, f)) == [g1(x) for x in scalars], f
    for f, scalars in {"beta_g2": [beta], "delta_g2": [delta],
                       "b2_query": v}.items():
        assert convert.to_ints(getattr(pk, f), g2=True) == \
            [g2(x) for x in scalars], f
    assert convert.to_ints(vk.ic) == [g1(x * ginv) for x in comb[:npub]]
    assert convert.to_ints(vk.gamma_g2, g2=True) == [g2(gamma)]
    for f in ("alpha_g1", "beta_g2", "delta_g2"):
        assert convert.to_ints(getattr(vk, f), g2=f != "alpha_g1") == \
            convert.to_ints(getattr(pk, f), g2=f != "alpha_g1")


def test_prove_equals_host_ints(run):
    A, B, C = proof_scalars(run["r1cs"], run["z"], N, N)
    pf = run["pf"]
    assert convert.to_ints(pf.a) == [g1(A)]
    assert convert.to_ints(pf.b, g2=True) == [g2(B)]
    assert convert.to_ints(pf.c) == [g1(C)]


def test_traced_run_spans(run):
    """The example's phases as spans, and in them the host witness, the
    three NTTs of H, the G1 and G2 MSMs and one pairing product."""
    spans = run["spans"]
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    phases = {s.name: s for s in roots if s.name != "msm.batch"}
    assert set(phases) == {"keygen", "prove", "verify", "commit_emul"}
    # the emulated commitment's bases, batched between verify and commit
    assert [s.attrs["curve"] for s in roots if s.name == "msm.batch"] == [
        "G1"]

    def under(phase, name):
        out = []
        for s in spans:
            up = by_id.get(s.parent)
            while up is not None and up.parent is not None:
                up = by_id.get(up.parent)
            if s.name == name and up is phases[phase]:
                out.append(s)
        return out

    r1cs, _ = groth16.matmul_r1cs(N)
    assert [s.attrs for s in under("prove", "groth16.witness")] == [
        {"rows": len(r1cs.A)}, {"vars": r1cs.num_vars}]
    assert [(s.attrs["inverse"], s.attrs["coset"], s.attrs["batch"])
            for s in under("prove", "ntt")] == [
        (True, False, 3), (False, True, 3), (True, True, 1)]
    assert [(s.attrs["curve"], s.attrs["rows"])
            for s in under("prove", "msm")] == [("G1", 2), ("G2", 1),
                                                ("G1", 1)]
    assert [s.attrs["curve"] for s in under("commit_emul", "msm")] == ["G1"]
    (pc,) = under("verify", "pairing.checks")
    assert pc.attrs == {"pairs": 4, "products": 1}
    assert [s.name for s in spans if s.parent == pc.id] == [
        "pairing.miller", "pairing.final_exp"]


def test_keygen_spans_setup_qap_and_one_batch_per_curve(run):
    """keygen holds one `groth16.setup` span (rows, vars, domain) with
    the host QAP and one fixed-base batch per curve, each of
    ceil(scalars / BATCH_CHUNK) chunks, as many counts of
    `msm.batch_chunks`."""
    spans, r1cs, D = run["spans"], run["r1cs"], run["pk"].domain
    (keygen,) = [s for s in spans if s.name == "keygen"]
    (st,) = [s for s in spans if s.parent == keygen.id]
    nv = r1cs.num_vars
    assert (st.name, st.attrs) == ("groth16.setup", {
        "rows": len(r1cs.A), "vars": nv, "domain": D})
    kids = [s for s in spans if s.parent == st.id]
    assert [s.name for s in kids] == ["groth16.qap", "msm.batch",
                                      "msm.batch"]
    total = 0
    for b, curve, n in ((kids[1], "G1", 3 + 3 * nv + D - 1),
                        (kids[2], "G2", 3 + nv)):
        chunks = -(-n // msm.BATCH_CHUNK)
        assert b.attrs == {"curve": curve, "scalars": n, "chunks": chunks}
        assert b.counts == {"msm.batch_chunks": chunks}
        total += chunks
    assert st.counts == {"msm.batch_chunks": total}


def test_chunked_prove_counts_msm_chunks(run, monkeypatch):
    """Prove again with a window budget that splits its three MSMs: each
    `msm` span holds ceil(W / windows_per_chunk) chunks and as many counts
    of `msm.chunks`, prove's total is their sum, and the proof is the
    module run's, bit for bit."""
    pk, r1cs = run["pk"], run["r1cs"]
    cols = pk.a_query.x.shape[-1] + 1                 # z | r, z | s
    c_cols = (pk.l_query.x.shape[-1] + pk.h_query.x.shape[-1] + 3)
    monkeypatch.setattr(msm, "WINDOW_BUDGET",
                        8 * msm.window_bytes(G2, (), cols))
    want = []
    for C, lead, m in ((G1, (2,), cols), (G2, (), cols), (G1, (), c_cols)):
        W = -(-(bn254.FR.bits + 1) // config.default_window(m))
        want.append(-(-W // msm.windows_per_chunk(C, W, lead, m)))
    assert min(want) > 1
    trace.drain()
    trace.enable()
    try:
        with trace.span("prove") as top:
            pf = groth16.prove(pk, r1cs, run["z"], seed=N)
    finally:
        trace.disable()
    msms = [s for s in trace.drain() if s.name == "msm"]
    assert [s.attrs["chunks"] for s in msms] == want
    assert [s.counts["msm.chunks"] for s in msms] == want
    assert top.counts["msm.chunks"] == sum(want)
    for f, want_pt in run["pf"]._asdict().items():
        assert all(torch.equal(a, b)
                   for a, b in zip(getattr(pf, f), want_pt)), f


def test_example_prints_proof_size_and_verify_ok(run):
    assert run["ok"] is True
    assert "## proof size: 2 G1 + 1 G2" in run["stdout"]
    assert "VERIFY OK" in run["stdout"]
    for phase in legogrothmatrix.PHASES:
        assert f"## groth16_{phase}_n{N}:" in run["stdout"]
        assert run["times"][phase] > 0
    assert run["proof_size"] == groth16.proof_size_group_elements() == \
        {"g1": 2, "g2": 1, "fr": 0}
    assert run["public"] == run["z"][1 : N * N + 1]


def test_example_with_chunked_windows_gives_the_same_key_and_proof(
        run, monkeypatch):
    """The n = 2 example again, with a window budget that splits each of
    prove's three MSMs into chunks: the same key and proof, bit for bit."""
    pk = run["pk"]
    cols = pk.a_query.x.shape[-1] + 1                 # z | r, z | s
    c_cols = (pk.l_query.x.shape[-1] + pk.h_query.x.shape[-1] + 3)
    monkeypatch.setattr(msm, "WINDOW_BUDGET",
                        8 * msm.window_bytes(G2, (), cols))
    for C, lead, m in ((G1, (2,), cols), (G2, (), cols), (G1, (), c_cols)):
        W = -(-(bn254.FR.bits + 1) // config.default_window(m))
        assert 1 < -(-W // msm.windows_per_chunk(C, W, lead, m))
    with contextlib.redirect_stdout(io.StringIO()):
        res = legogrothmatrix.run(N, "cpu")
    assert res["ok"] is True
    for name in ("pk", "vk", "pf"):
        for f, want in run[name]._asdict().items():
            got = getattr(res[name], f)
            assert (got == want if isinstance(want, int) else
                    all(torch.equal(a, b) for a, b in zip(got, want))), f


@pytest.fixture(scope="module")
def verdicts(run):
    """The honest proof and two tampers in one `pairing_checks` call."""
    vk, pf, public = run["vk"], run["pf"], run["public"]
    bad = list(public)
    bad[0] = (bad[0] + 1) % R
    cases = {
        "honest": groth16.verify_pairs(vk, public, pf),
        "public output changed": groth16.verify_pairs(vk, bad, pf),
        "A and C swapped": groth16.verify_pairs(
            vk, public, groth16.Proof(a=pf.c, b=pf.b, c=pf.a)),
    }
    out = pr.pairing_checks([g for gs in cases.values() for g in gs])
    return dict(zip(cases, out.tolist()))


@pytest.mark.parametrize("what,want", [("honest", True),
                                       ("public output changed", False),
                                       ("A and C swapped", False)])
def test_one_pairing_check_accepts_honest_and_rejects_tampers(verdicts, what,
                                                              want):
    assert verdicts[what] is want


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        legogrothmatrix.run(N)
    with pytest.raises(RuntimeError, match="CUDA"):
        legogrothmatrix.main([str(N)])
    with pytest.raises(RuntimeError, match="CUDA"):
        groth16.setup(groth16.matmul_r1cs(1)[0])


@pytest.fixture(scope="module")
def jax_run(run):
    """The JAX package's setup (seed 2) and prove (seed 3) on the run's
    R1CS and witness; prints its seconds."""
    from legosnark_tpu.gadgets import groth16 as jg16

    t0 = time.perf_counter()
    jpk, jvk = jg16.setup(run["r1cs"], seed=2)
    t1 = time.perf_counter()
    jpf = jg16.prove(jpk, run["r1cs"], run["z"], seed=3)
    t2 = time.perf_counter()
    print(f"JAX groth16 setup {t1 - t0:.1f} s, prove {t2 - t1:.1f} s")
    return {"pk": convert.groth16_pk_from_jax(jpk, "cpu"),
            "vk": convert.groth16_vk_from_jax(jvk, "cpu"),
            "pf": convert.groth16_proof_from_jax(jpf, "cpu")}


def _fields_ints(t):
    return {f: (convert.to_ints(p, g2=p.x.dim() == 3)
                if not isinstance(p, int) else p)
            for f, p in t._asdict().items()}


@pytest.mark.slow
def test_setup_and_prove_equal_jax(run, jax_run):
    pk, vk = groth16.setup(run["r1cs"], seed=2, device="cpu")
    pf = groth16.prove(pk, run["r1cs"], run["z"], seed=3)
    assert _fields_ints(pk) == _fields_ints(jax_run["pk"])
    assert _fields_ints(vk) == _fields_ints(jax_run["vk"])
    assert _fields_ints(pf) == _fields_ints(jax_run["pf"])
    assert convert.to_ints(pf.a) == [g1(proof_scalars(
        run["r1cs"], run["z"], 2, 3)[0])]


@pytest.mark.slow
def test_port_verify_accepts_the_jax_proof(run, jax_run):
    assert bool(groth16.verify(jax_run["vk"], run["public"], jax_run["pf"]))
