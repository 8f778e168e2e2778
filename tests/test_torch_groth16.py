"""The port's Groth16 and its `legogrothmatrix` example at n = 2 (a 2 x 2
matrix product: 8 constraints, 17 variables, 4 public outputs).

Fast tier, on one module-scoped run of `legogrothmatrix.run(2, "cpu")`
(setup with seed 2, prove with seed 2):
* `matmul_r1cs(n)` and `assign` equal the JAX package's for n = 1, 2, 3
  (host Python on both sides);
* every key element equals a host-int scalar times its generator
  (tests/oracle.py), with the trapdoor drawn again from the seed and the
  QAP values computed here from per-row Lagrange values;
* A, B and C equal the host-int scalars built from the trapdoor and the
  draws of r and s, which holds the NTT quotient pipeline and every MSM
  without a pairing;
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

from legosnark_tpu_torch import convert
from legosnark_tpu_torch.curve import bn254
from legosnark_tpu_torch.curve import pairing as pr
from legosnark_tpu_torch.examples import legogrothmatrix
from legosnark_tpu_torch.gadgets import groth16
from legosnark_tpu_torch.utils import rand as lrand

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
    """`legogrothmatrix.run(2, "cpu")` with its printed lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = legogrothmatrix.run(N, "cpu")
    res["stdout"] = buf.getvalue()
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


@pytest.mark.parametrize("n", [1, 2, 3])
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
