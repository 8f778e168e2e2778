"""The port's Pedersen commitments, input plumbing, sparse layer and
subspace argument, with the two examples that stand on them: CPlink at
N = 4 and CPAC (the matrixac example) at n = 2 (8 gates, 4 constraints).

Fast tier, on one module-scoped run of each example on the CPU:
* `rand_fr_canonical`, the sparse structures and `sparse_inner_product`
  equal the JAX package's exactly; the sparse MSMs equal
  tests/oracle.py's affine arithmetic;
* CPlink's keys, commitments, subspace key and pi equal host-int values
  from the seeds' rebuilt scalars; `init_no_pub` draws as the JAX package
  does, its commitments are homomorphic and their knowledge legs well
  formed with r != 0; `commit_scalar` equals host ints; the dense and the scalar subspace keygens give the
  sparse keygen's key; four tampered statements are rejected (every
  pairing equation of these checks in one `pairing_checks` call);
* CPAC verifies and rejects the flipped output; its commitments, pi,
  t_i G and lin_pi equal host-int scalars times G1 from the data's seed
  and keygen's rebuilt chi and k;
* `proof_size_group_elements` of poly, matrix, lipmaa, subspace and
  arithcirc equal the JAX package's.
Slow tier: both examples' keys, commitments and proofs, and the sparse
MSMs, equal the JAX package's, element for element.
"""
import numpy as np
import pytest
import torch

import oracle

from legosnark_tpu_torch import convert
from legosnark_tpu_torch.curve import bn254
from legosnark_tpu_torch.curve import pairing as pr
from legosnark_tpu_torch.curve.group import (G1, g1_from_ints, point_concat,
                                             point_map)
from legosnark_tpu_torch.examples import cplink, matrixac
from legosnark_tpu_torch.fields import limb as fl
from legosnark_tpu_torch.gadgets import (arithcirc, lipmaa, matrix, poly,
                                         snark, subspace)
from legosnark_tpu_torch.prototools import commit as cs
from legosnark_tpu_torch.utils import rand as lrand
from legosnark_tpu_torch.utils import sparse

# The plain path runs many small torch ops; idle intra-op threads spin and
# starve the other test processes, so the port's tests use one thread.
torch.set_num_threads(1)

R = bn254.R
FR = bn254.FR
LOG_N = 2
N = 1 << LOG_N
AC_N = 2
AC_SEED = 7


def mont(ints):
    return fl.tensor(FR.to_mont_ints(ints), "cpu")


def canonical(ints):
    return fl.tensor(fl.ints_to_limbs(ints), "cpu")


def ints(t):
    return [int(v) for v in convert.to_ints(t).reshape(-1)]


def ints_of_canonical(t):
    return [int(v) for v in fl.limbs_to_ints(t)]


def g1(k):
    return oracle.g1_mul(oracle.G1, k % R)


def g2(k):
    return oracle.g2_mul(oracle.G2, k % R)


def key_scalars(seed):
    """The n + 1 scalars of `commit.keygen(N, seed)`: bases, blinding."""
    return lrand.rand_fr_ints(np.random.default_rng(seed ^ 0x1E605), N + 1)


def link_draws():
    """u, r_H and r_F as `cplink.run` draws them."""
    rng = np.random.default_rng(23)
    u = [int.from_bytes(rng.bytes(31), "little") % R for _ in range(N)]
    return u, lrand.rand_fr_int(rng), lrand.rand_fr_int(rng)


@pytest.fixture(scope="module", autouse=True)
def _inference_mode():
    """No autograd bookkeeping for the plain path's many small ops."""
    with torch.inference_mode():
        yield


@pytest.fixture(scope="module")
def link():
    return cplink.run(LOG_N, "cpu")


@pytest.fixture(scope="module")
def commits(link):
    """`init_no_pub` under the run's first key: v1, v2, v1 + v2 and a
    shorter v4 (padded in the joint MSM), with the rng's state before."""
    rng = np.random.default_rng(5)
    v1, v2 = lrand.rand_fr_ints(rng, N), lrand.rand_fr_ints(rng, N)
    vals = [v1, v2, [(a + b) % R for a, b in zip(v1, v2)],
            lrand.rand_fr_ints(rng, N // 2)]
    state = rng.bit_generator.state
    pin, vin = snark.init_no_pub(link["ck_h"], [mont(v) for v in vals], rng)
    return {"vals": vals, "state": state, "pin": pin, "vin": vin,
            "rng_after": rng}


@pytest.fixture(scope="module")
def dense_keys(link):
    """The dense and the scalar subspace keygens on the run's relation."""
    sh, sf = key_scalars(1), key_scalars(2)
    ck_h, ck_f = link["ck_h"], link["ck_f"]
    M = subspace.make_linking_relation(ck_h.h, ck_f.h, ck_h.g1s, ck_f.g1s)
    sM = torch.stack([mont([sh[N], 0] + sh[:N]), mont([0, sf[N]] + sf[:N])])
    return subspace.keygen(M, seed=7), subspace.keygen_scalar(sM, seed=7)


@pytest.fixture(scope="module")
def verdicts(link, commits, dense_keys):
    """Every pairing equation of the module in one `pairing_checks`."""
    key, x, pi = link["key"], link["x"], link["pi"]
    ck_f = link["ck_f"]
    cH, cF = link["vin_h"].comm_in[0], link["vin_f"].comm_in[0]
    # F's commitment to u' = u + e_0 with the same r_F
    cF_other = G1.add(cF.c, point_map(lambda t: t[..., :1], ck_f.g1s))
    co = commits["pin"].comm_slot
    groups = {
        "dense key": subspace.verify_pairings(dense_keys[0], x, pi),
        "scalar key": subspace.verify_pairings(dense_keys[1], x, pi),
        "pi doubled": subspace.verify_pairings(key, x, G1.double(pi)),
        "F commits to u' != u": subspace.verify_pairings(
            key, point_concat([cH.c, cF_other]), pi),
        "x = (c_H, c_H)": subspace.verify_pairings(
            key, point_concat([cH.c, cH.c]), pi),
        "knowledge legs swapped": cs.knowledge_pairings(
            link["ck_h"], cs.Comm(cH.c, cF.kc)),
        "knowledge of c1 + c2": cs.knowledge_pairings(
            link["ck_h"], (co[0] + co[1]).c),
    }
    out = pr.pairing_checks([g for gs in groups.values() for g in gs])
    return dict(zip(groups, out.tolist()))


def test_rand_fr_canonical_equals_jax():
    from legosnark_tpu.fields import limb as jfl
    from legosnark_tpu.utils import rand as jrand

    mine, theirs = np.random.default_rng(3), np.random.default_rng(3)
    got = ints_of_canonical(lrand.rand_fr_canonical(mine, 6, "cpu"))
    assert got == list(jfl.limbs_to_ints(jrand.rand_fr_canonical(theirs, 6)))
    assert mine.bytes(8) == theirs.bytes(8)


def test_sparse_structures_equal_jax():
    import jax.numpy as jnp
    from legosnark_tpu.fields import limb as jfl
    from legosnark_tpu.utils import sparse as jsp

    entries = [(0, 0, 5), (2, 0, R - 7), (1, 1, 1), (3, 2, 9),
               (0, 2, (1 << 200) + 3)]
    for mnt in (False, True):
        M = sparse.insert_as_col_major(entries, 4, 3, nnz_max=2, mont=mnt,
                                       device="cpu")
        J = jsp.insert_as_col_major(entries, 4, 3, nnz_max=2, mont=mnt)
        assert M.nrows == J.nrows
        assert M.positions.tolist() == np.asarray(J.positions).tolist()
        if mnt:
            got = convert.to_ints(M.values)
            want = convert.jax_field_ints(J.values, FR)
        else:
            got = fl.limbs_to_ints(M.values)
            want = jfl.limbs_to_ints(J.values)
        assert got.tolist() == want.tolist()
    v = [0, 3, 0, 0, R - 1, 0, 7, 0]
    for nnz in (None, 5):
        sv = sparse.from_dense_scalars(canonical(v), nnz)
        jv = jsp.from_dense_scalars(jnp.asarray(jfl.ints_to_limbs(v, 20)), nnz)
        assert sv.positions.tolist() == np.asarray(jv.positions).tolist()
        assert ints_of_canonical(sv.values) == \
            list(jfl.limbs_to_ints(jv.values))


def test_sparse_inner_product_equals_jax():
    """One sparse vector, and a batch of them (a matrix's columns) in one
    call, against the JAX package's per vector."""
    import jax
    import jax.numpy as jnp
    from legosnark_tpu.curve import bn254 as jbn
    from legosnark_tpu.utils import sparse as jsp

    rng = np.random.default_rng(8)
    dense = lrand.rand_fr_ints(rng, 8)
    cols = [([1, 3, 6], lrand.rand_fr_ints(rng, 3)),
            ([0, 7, 7], lrand.rand_fr_ints(rng, 3))]
    fn = jax.jit(jsp.sparse_inner_product)
    want = [convert.jax_field_ints(fn(
        jnp.asarray(jbn.FR.to_mont_ints(dense)),
        jsp.SparseVec(jnp.asarray(jbn.FR.to_mont_ints(vals)),
                      jnp.asarray(np.array(pos, np.int32)))), FR)[0]
        for pos, vals in cols]
    assert want[0] == sum(dense[p] * v for p, v in zip(*cols[0])) % R
    one = sparse.sparse_inner_product(mont(dense), sparse.SparseVec(
        mont(cols[0][1]), torch.tensor(cols[0][0])))
    assert ints(one) == want[:1]
    batch = sparse.sparse_inner_product(mont(dense), sparse.SparseVec(
        torch.stack([mont(v) for _, v in cols]),
        torch.tensor([p for p, _ in cols])))
    assert ints(batch) == want


@pytest.fixture(scope="module")
def sparse_msms():
    """The port's sparse_msm_scalars and sparse_msm_points (c = 4) and
    matvec_g1 on small inputs, with the inputs."""
    pts = [g1(i + 2) for i in range(12)]
    ks = [0, 1, 0, 11, 0, 1, R - 5, 0, 0, 1 << 250, 0, 0]
    pos = [1, 4, 9]               # sparse bases, with dense exponents
    exps = lrand.rand_fr_ints(np.random.default_rng(4), 12)
    entries = [(0, 0, 5), (2, 0, 7), (1, 1, 1), (3, 2, 9)]
    points = g1_from_ints(pts, "cpu")
    sv = sparse.from_dense_scalars(canonical(ks), nnz=8)
    svp = sparse.SparseVec(g1_from_ints([pts[i] for i in pos], "cpu"),
                           torch.tensor(pos))
    M = sparse.insert_as_col_major(entries, 4, 3, nnz_max=2, device="cpu")
    return {"pts": pts, "ks": ks, "pos": pos, "exps": exps,
            "entries": entries,
            "scalars": convert.to_ints(
                sparse.sparse_msm_scalars(G1, points, sv, c=4)),
            "points": convert.to_ints(sparse.sparse_msm_points(
                G1, svp, canonical(exps), c=4)),
            "matvec": convert.to_ints(sparse.matvec_g1(
                M, g1_from_ints(pts[:4], "cpu")))}


def test_sparse_msms_equal_oracle(sparse_msms):
    """Against host affine arithmetic (the JAX package's own fast tier
    holds its versions to the same; the slow tier compares the two)."""
    pts, run = sparse_msms["pts"], sparse_msms
    want = None
    for p, k in zip(pts, run["ks"]):
        want = oracle.g1_add(want, oracle.g1_mul(p, k))
    assert run["scalars"] == [want]
    want = None
    for i in run["pos"]:
        want = oracle.g1_add(want, oracle.g1_mul(pts[i], run["exps"][i]))
    assert run["points"] == [want]
    for j in range(3):
        want = None
        for r, c_, v in run["entries"]:
            if c_ == j:
                want = oracle.g1_add(want, oracle.g1_mul(pts[r], v))
        assert run["matvec"][j] == want


@pytest.mark.slow
def test_sparse_msms_equal_jax(sparse_msms):
    """The JAX package's three sparse MSMs on the same inputs, point for
    point (~40 s of XLA compiles on the CPU)."""
    import jax.numpy as jnp
    from legosnark_tpu.curve.group import (G1 as JG1, g1_from_oracle,
                                           g1_to_oracle_batch)
    from legosnark_tpu.fields import limb as jfl
    from legosnark_tpu.utils import sparse as jsp

    run, pts = sparse_msms, sparse_msms["pts"]
    points = g1_from_oracle(pts)
    sv = jsp.from_dense_scalars(
        jnp.asarray(jfl.ints_to_limbs(run["ks"], 20)), nnz=8)
    assert g1_to_oracle_batch(jsp.sparse_msm_scalars(JG1, points, sv, c=4)) \
        == run["scalars"]
    svp = jsp.SparseVec(g1_from_oracle([pts[i] for i in run["pos"]]),
                        jnp.asarray(np.array(run["pos"], np.int32)))
    assert g1_to_oracle_batch(jsp.sparse_msm_points(
        JG1, svp, jnp.asarray(jfl.ints_to_limbs(run["exps"], 20)), c=4)) \
        == run["points"]
    M = jsp.insert_as_col_major(run["entries"], 4, 3, nnz_max=2)
    out = jsp.matvec_g1(M, g1_from_oracle(pts[:4]))
    assert [g1_to_oracle_batch(type(out)(*(x[j] for x in out)))[0]
            for j in range(3)] == run["matvec"]


def test_cplink_equals_host_ints(link):
    """Both commitment keys, both commitments (c and kc), the subspace
    key and pi from the seeds' scalars, in host integers."""
    assert link["ok"] is True
    sh, sf = key_scalars(1), key_scalars(2)
    u, rH, rF = link_draws()
    assert ints(link["u"]) == u
    for ck, s in ((link["ck_h"], sh), (link["ck_f"], sf)):
        assert convert.to_ints(ck.g1s) == [g1(x) for x in s[:N]]
        assert convert.to_ints(ck.h) == [g1(s[N])]
        assert convert.to_ints(ck.g2s, g2=True) == [g2(x) for x in s[:N]]
        assert convert.to_ints(ck.h2, g2=True) == [g2(s[N])]
    for pin, vin, s, r in ((link["pin_h"], link["vin_h"], sh, rH),
                           (link["pin_f"], link["vin_f"], sf, rF)):
        assert ints(pin.comm_slot[0].r) == [r]
        v = sum(a * b for a, b in zip(u, s)) + r * s[N]
        assert convert.to_ints(vin.comm_in[0].c) == [g1(v)]
        assert convert.to_ints(vin.comm_in[0].kc, g2=True) == [g2(v)]
    rng = np.random.default_rng(7 ^ 0x5AB5)
    k, a_hat = lrand.rand_fr_ints(rng, 2), lrand.rand_fr_int(rng)
    # columns h, f, the N base columns, then N empty ones (2N + 2 in all)
    p = [k[0] * sh[N], k[1] * sf[N]] + [k[0] * a + k[1] * b
                                        for a, b in zip(sh[:N], sf)] + [0] * N
    key = link["key"]
    assert convert.to_ints(key.P) == [g1(x) for x in p]
    assert convert.to_ints(key.C, g2=True) == [g2(x * a_hat) for x in k]
    assert convert.to_ints(key.a, g2=True) == [g2(a_hat)]
    w = [rH, rF] + u
    assert convert.to_ints(link["pi"]) == \
        [g1(sum(a * b for a, b in zip(w, p)))]
    assert link["proof_size"] == subspace.proof_size_group_elements()


def test_init_no_pub_draws_as_jax_and_commits(link, commits):
    """r drawn per vector as the JAX package's `init_no_pub` draws it;
    each commitment (the short vector padded) equals host ints."""
    from legosnark_tpu.utils import rand as jrand

    theirs = np.random.default_rng()
    theirs.bit_generator.state = commits["state"]
    rs = [convert.jax_field_ints(jrand.rand_fr_mont(theirs, 1), FR)[0]
          for _ in commits["vals"]]
    assert commits["rng_after"].bytes(8) == theirs.bytes(8)
    sh = key_scalars(1)
    pin, vin = commits["pin"], commits["vin"]
    assert pin.public_slot == vin.public_in == ()
    for co, cm, v, r in zip(pin.comm_slot, vin.comm_in, commits["vals"], rs):
        assert ints(co.r) == [r]
        assert ints(co.xs) == v
        s = sum(a * b for a, b in zip(v, sh)) + r * sh[N]
        assert convert.to_ints(cm.c) == [g1(s)]
        assert convert.to_ints(cm.kc, g2=True) == [g2(s)]


def test_commitments_are_homomorphic(commits, verdicts):
    """c1 + c2 - c3 for v3 = v1 + v2 is (r1 + r2 - r3) (h, h2), and the
    knowledge leg of c1 + c2 (r != 0) is well formed."""
    co = commits["pin"].comm_slot
    s = co[0] + co[1]
    assert ints(s.xs) == commits["vals"][2]
    d = s - co[2]
    r = (ints(co[0].r)[0] + ints(co[1].r)[0] - ints(co[2].r)[0]) * \
        key_scalars(1)[N]
    assert ints(d.xs) == [0] * N
    assert convert.to_ints(d.c.c) == [g1(r)]
    assert convert.to_ints(d.c.kc, g2=True) == [g2(r)]
    assert verdicts["knowledge of c1 + c2"] is True


def test_commit_scalar_equals_host_ints(link):
    """c = v g1s[0] and kc = v g2s[0] (through `Comm.scale`)."""
    v = lrand.rand_fr_int(np.random.default_rng(6))
    co = cs.commit_scalar(link["ck_h"], mont([v]))
    s = v * key_scalars(1)[0]
    assert convert.to_ints(co.c.c) == [g1(s)]
    assert convert.to_ints(co.c.kc, g2=True) == [g2(s)]
    assert ints(co.r) == [0] and ints(co.xs) == [v]


def test_dense_and_scalar_keygens_give_the_sparse_key(link, dense_keys,
                                                      verdicts):
    """Their P is the sparse key's on the relation's N + 2 columns (the
    sparse relation's last N columns are empty); C and a are equal."""
    sparse_key = link["key"]
    for key in dense_keys:
        assert convert.to_ints(key.P) == convert.to_ints(sparse_key.P)[:N + 2]
        for f in ("C", "a"):
            assert convert.to_ints(getattr(key, f), g2=True) == \
                convert.to_ints(getattr(sparse_key, f), g2=True)
    assert convert.to_ints(sparse_key.P)[N + 2:] == [None] * N
    assert verdicts["dense key"] is True
    assert verdicts["scalar key"] is True


@pytest.mark.parametrize("what", ["pi doubled", "F commits to u' != u",
                                  "x = (c_H, c_H)", "knowledge legs swapped"])
def test_tampers_are_rejected(verdicts, what):
    assert verdicts[what] is False


@pytest.mark.slow
def test_cplink_equals_jax(link):
    """The JAX package's two keys, the commitments of the same u with the
    same draws, the sparse subspace key and pi, element for element."""
    import jax.numpy as jnp
    from legosnark_tpu.curve import bn254 as jbn
    from legosnark_tpu.gadgets import snark as jsnark
    from legosnark_tpu.gadgets import subspace as jsub
    from legosnark_tpu.prototools import commit as jcs
    from legosnark_tpu.utils import sparse as jsp

    rng = np.random.default_rng(23)
    u = [int.from_bytes(rng.bytes(31), "little") % R for _ in range(N)]
    jck_h, js_h = jcs.keygen(N, seed=1, return_scalars=True)
    jck_f, js_f = jcs.keygen(N, seed=2, return_scalars=True)
    for ck, jck in ((link["ck_h"], jck_h), (link["ck_f"], jck_f)):
        mine = cs.CommitmentKey(*(convert.to_ints(p, g2=i % 2 == 1)
                                  for i, p in enumerate(ck)))
        theirs = convert.commitkey_from_jax(jck, "cpu")
        assert mine == cs.CommitmentKey(
            *(convert.to_ints(p, g2=i % 2 == 1) for i, p in enumerate(theirs)))
    ju = jnp.asarray(jbn.FR.to_mont_ints(u))
    _, jvin_h = jsnark.init_no_pub(jck_h, [ju], rng)
    _, jvin_f = jsnark.init_no_pub(jck_f, [ju], rng)
    for vin, jvin in ((link["vin_h"], jvin_h), (link["vin_f"], jvin_f)):
        got, want = vin.comm_in[0], convert.comm_from_jax(jvin.comm_in[0],
                                                          "cpu")
        assert convert.to_ints(got.c) == convert.to_ints(want.c)
        assert convert.to_ints(got.kc, g2=True) == \
            convert.to_ints(want.kc, g2=True)
    sM = link["sM"]
    entries = []
    vals = convert.to_ints(sM.values)                  # [t, nnz]
    for j in range(sM.positions.shape[0]):
        for k in range(2):
            if vals[j, k]:
                entries.append((int(sM.positions[j, k]), j, int(vals[j, k])))
    jkey = jsub.keygen_scalar_sparse(
        jsp.insert_as_col_major(entries, 2, 2 * N + 2, 2, mont=True), seed=7)
    key = convert.subspacekey_from_jax(jkey, "cpu")
    for f in ("P", "C", "a"):
        on_g2 = f != "P"
        assert convert.to_ints(getattr(key, f), g2=on_g2) == \
            convert.to_ints(getattr(link["key"], f), g2=on_g2)
    jw = jnp.asarray(jbn.FR.to_mont_ints(ints(link["w"])))
    jpi = jsub.prove(jkey, jw)
    assert convert.to_ints(convert.point_from_jax(jpi, "cpu")) == \
        convert.to_ints(link["pi"])


@pytest.fixture(scope="module")
def mac():
    return matrixac.run(AC_N, "cpu")


def host_wires(n):
    """l, r, o, the constraints W (as {row: gate columns}) and t, and the
    commitments' randomness, drawn again from the example's seed."""
    rng = np.random.default_rng(0xAC0 + n)
    A = [[lrand.rand_fr_int(rng) for _ in range(n)] for _ in range(n)]
    B = [[lrand.rand_fr_int(rng) for _ in range(n)] for _ in range(n)]
    gates = [(i, k, j) for i in range(n) for k in range(n) for j in range(n)]
    l = [A[i][k] for i, k, _ in gates]
    r = [B[k][j] for _, k, j in gates]
    o = [x * y % R for x, y in zip(l, r)]
    rows = [[2 * len(gates) + g for g, (gi, _, gj) in enumerate(gates)
             if (gi, gj) == (i, j)] for i in range(n) for j in range(n)]
    t = [sum(A[i][k] * B[k][j] for k in range(n)) % R
         for i in range(n) for j in range(n)]
    return l, r, o, rows, t, lrand.rand_fr_ints(rng, 3)


def test_cpac_verifies_and_rejects_the_flipped_output(mac):
    assert mac["ok"] is True
    assert mac["tamper_rejected"] is True


def test_cpac_proof_equals_host_ints(mac):
    """c_v = (sum_i v_i l_i(chi) + d Z(chi)) G1, pi = H(chi) G1, t_i G,
    and lin_pi = (sum_i k_i <M_i, w>) G1 over the relation's scalars."""
    l, r, o, rows, t, ds = host_wires(AC_N)
    n = len(l)
    rng = np.random.default_rng(AC_SEED ^ 0x11BA)
    chi = lrand.rand_fr_int(rng)
    w_n = bn254.fr_two_adic_root(n.bit_length() - 1)
    z = (pow(chi, n, R) - 1) % R
    lag = [z * pow(w_n, i, R) * pow(n * (chi - pow(w_n, i, R)), -1, R) % R
           for i in range(n)]
    s = [(sum(a * b for a, b in zip(v, lag)) + d * z) % R
         for v, d in zip((l, r, o), ds)]
    pf, key = mac["proof"], mac["key"]
    for cm, sv in zip((pf.ca, pf.cb, pf.cc), s):
        assert convert.to_ints(cm.c) == [g1(sv)]
    assert convert.to_ints(pf.had_pi) == \
        [g1((s[0] * s[1] - s[2]) * pow(z, -1, R))]
    assert convert.to_ints(key.t_points) == [g1(x) for x in t]
    rng = np.random.default_rng((AC_SEED ^ 0xAC) ^ 0x5AB5)
    k = lrand.rand_fr_ints(rng, 3 + len(t))
    wires = l + r + o
    lin = sum(k[i] * s[i] for i in range(3))
    lin += sum(k[3 + q] * sum(wires[c] for c in cols)
               for q, cols in enumerate(rows))
    assert convert.to_ints(pf.lin_pi) == [g1(lin)]


def test_proof_sizes_equal_jax(mac):
    from legosnark_tpu.gadgets import arithcirc as jac
    from legosnark_tpu.gadgets import lipmaa as jlip
    from legosnark_tpu.gadgets import matrix as jmat
    from legosnark_tpu.gadgets import poly as jpoly
    from legosnark_tpu.gadgets import subspace as jsub

    mkey = matrix.MatKey(16, 4, None)
    assert poly.proof_size_group_elements(5) == \
        jpoly.proof_size_group_elements(5)
    assert matrix.proof_size_group_elements(mkey) == \
        jmat.proof_size_group_elements(mkey)
    assert lipmaa.proof_size_group_elements() == \
        jlip.proof_size_group_elements()
    assert subspace.proof_size_group_elements() == \
        jsub.proof_size_group_elements()
    assert arithcirc.proof_size_group_elements() == mac["proof_size"] == \
        jac.proof_size_group_elements()


@pytest.mark.slow
def test_cpac_key_and_proof_equal_jax(mac):
    """The JAX package's keygen and prove on the same relation, wires and
    randomness: t_points, the subspace key and every proof field equal
    the port's; the port verifies the JAX proof."""
    import jax.numpy as jnp
    from legosnark_tpu.curve import bn254 as jbn
    from legosnark_tpu.gadgets import arithcirc as jac

    rel = mac["rel"]
    jkey = jac.keygen(jac.ACRel(rel.n, rel.W, rel.t), seed=AC_SEED)
    l, r, o = (jnp.asarray(jbn.FR.to_mont_ints(v)) for v in mac["wires"])
    ds = [int(v) for v in convert.to_ints(mac["ds"]).reshape(-1)]
    jpf = jac.prove(jkey, l, r, o, jnp.asarray(jbn.FR.to_mont_ints(ds)))
    key = convert.ackey_from_jax(jkey, "cpu")
    pf = convert.acproof_from_jax(jpf, "cpu")

    def same(a, b, g2=False):
        return convert.to_ints(a, g2=g2) == convert.to_ints(b, g2=g2)

    assert same(key.t_points, mac["key"].t_points)
    for f in ("P", "C", "a"):
        assert same(getattr(key.ss_key, f), getattr(mac["key"].ss_key, f),
                    g2=f != "P")
    mine = mac["proof"]
    for f in ("ca", "cb", "cc"):
        assert same(getattr(pf, f).c, getattr(mine, f).c)
        assert same(getattr(pf, f).kc, getattr(mine, f).kc, g2=True)
    assert same(pf.had_pi, mine.had_pi)
    assert same(pf.lin_pi, mine.lin_pi)
    assert bool(arithcirc.verify(key, pf))
