"""The port's tower and pairing (legosnark_tpu_torch.fields.tower,
curve.pairing) against the bigint oracle, exact on canonical integers.

The oracle (`tests/oracle.py`) computes the reduced pairing
f^((q^12 - 1)/r) with a naive final exponentiation. The port's final
exponentiation is the JAX package's: its hard part (Fuentes-Castaneda et
al., as in libff and arkworks) gives f^(lam (q^12 - 1)/r) with
lam = 2x(6x^2 + 3x + 1), x the BN parameter, which is coprime to r. So the
port's pairing equals the oracle's raised to lam, and that is what is
compared. Miller-loop values are not compared: the two loops scale their
line values differently.
"""
import numpy as np
import pytest
import torch

import oracle
from legosnark_tpu_torch.curve import bn254, pairing as pr
from legosnark_tpu_torch.curve.group import g1_from_ints, g2_from_ints
from legosnark_tpu_torch.fields import limb as fl

# The plain path runs many small torch ops; idle intra-op threads spin and
# starve the other test processes, so the port's tests use one thread.
torch.set_num_threads(1)

Q = bn254.Q
X = bn254.BN_X
LAM = 2 * X * (6 * X * X + 3 * X + 1)
F6, F12 = pr.F6, pr.F12


def f6_flat(a):
    return [c for f2 in a for c in f2]


def to_tensor(vals, width):
    """Oracle tower values (Fq6 or Fq12 nested tuples) -> [.., 2, 8, n]."""
    flat = [f6_flat(v) if width == 6 else
            [c for f6 in v for c in f6_flat(f6)] for v in vals]
    k = len(flat[0])
    arr = np.stack([bn254.FQ.to_mont_ints([f[i] for f in flat])
                    for i in range(k)])
    t = fl.tensor(arr, "cpu")
    shape = (3, 2) if width == 6 else (2, 3, 2)
    return t.view(shape + (8, len(vals)))


def from_tensor(t, width):
    n = t.shape[-1]
    ints = fl.limbs_to_ints(t.reshape(-1, 8, n))
    out = []
    for i in range(n):
        v = [bn254.FQ.from_mont_int(ints[k][i]) for k in range(ints.shape[0])]
        f2 = [(v[2 * j], v[2 * j + 1]) for j in range(len(v) // 2)]
        f6 = [tuple(f2[3 * j : 3 * j + 3]) for j in range(len(f2) // 3)]
        out.append(f6[0] if width == 6 else tuple(f6))
    return out


def rand_f12(rng, n):
    def f2():
        return tuple(int.from_bytes(rng.bytes(40), "little") % Q
                     for _ in range(2))
    return [(tuple(f2() for _ in range(3)), tuple(f2() for _ in range(3)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def vals():
    rng = np.random.default_rng(21)
    return rand_f12(rng, 3), rand_f12(rng, 3)


def test_fq6_against_oracle(vals):
    A = [v[0] for v in vals[0]]
    B = [v[1] for v in vals[1]]
    a, b = to_tensor(A, 6), to_tensor(B, 6)
    assert from_tensor(F6.mul(a, b), 6) == [oracle.f6_mul(x, y)
                                            for x, y in zip(A, B)]
    assert from_tensor(F6.sqr(a), 6) == [oracle.f6_mul(x, x) for x in A]
    assert from_tensor(F6.inv(a), 6) == [oracle.f6_inv(x) for x in A]
    assert from_tensor(F6.mul_by_v(a), 6) == [oracle.f6_mul_by_v(x)
                                              for x in A]


def test_fq12_against_oracle(vals):
    A, B = vals
    a, b = to_tensor(A, 12), to_tensor(B, 12)
    assert from_tensor(F12.mul(a, b), 12) == [oracle.f12_mul(x, y)
                                              for x, y in zip(A, B)]
    assert from_tensor(F12.sqr(a), 12) == [oracle.f12_sqr(x) for x in A]
    assert from_tensor(F12.inv(a), 12) == [oracle.f12_inv(x) for x in A]
    assert from_tensor(F12.conj(a), 12) == [oracle.f12_conj(x) for x in A]
    # mul_by_034: the sparse element ((e0, 0, 0), (e3, e4, 0))
    e0, e3, e4 = a[0, 0], a[0, 1], a[1, 2]
    sparse = [((x[0][0], (0, 0), (0, 0)), (x[0][1], x[1][2], (0, 0)))
              for x in A]
    assert from_tensor(F12.mul_by_034(b, e0, e3, e4), 12) == [
        oracle.f12_mul(y, s) for y, s in zip(B, sparse)]
    assert bool(F12.is_one(F12.mul(a, F12.inv(a))).all())
    assert not bool(F12.is_one(a).any())


@pytest.mark.parametrize("n", [1, 2, 3])
def test_frobenius_against_oracle(vals, n):
    A = vals[0][:2]
    got = from_tensor(pr.frobenius(to_tensor(A, 12), n), 12)
    assert got == [oracle.f12_pow(x, Q**n) for x in A]


def setup_pairs(seed, n):
    rng = np.random.default_rng(seed)
    ks1 = [int(rng.integers(1, 1 << 50)) for _ in range(n)]
    ks2 = [int(rng.integers(1, 1 << 50)) for _ in range(n)]
    return ([oracle.g1_mul(oracle.G1, k) for k in ks1],
            [oracle.g2_mul(oracle.G2, k) for k in ks2])


def _pairing(ps, qs):
    px, py, _ = pr.g1_affine(g1_from_ints(ps, "cpu"))
    qx, qy, _ = pr.g2_affine(g2_from_ints(qs, "cpu"))
    return from_tensor(pr.pairing(px, py, qx, qy), 12)


def test_pairing_is_the_oracle_pairing_to_lam():
    ps, qs = setup_pairs(11, 2)
    got = _pairing(ps, qs)
    for i in range(2):
        assert got[i] == oracle.f12_pow(oracle.pairing(ps[i], qs[i]), LAM)


def test_pairing_bilinearity():
    ps, qs = setup_pairs(12, 1)
    p, q = ps[0], qs[0]
    e_pq, e_2pq, e_p2q = _pairing([p, oracle.g1_mul(p, 2), p],
                                  [q, q, oracle.g2_mul(q, 2)])
    sq = oracle.f12_mul(e_pq, e_pq)
    assert e_2pq == sq and e_p2q == sq
    assert e_pq != oracle.F12_ONE


def test_pairing_product_is_one_with_identity_masked():
    """Mirrors tests/test_pairing.py:100: e(P, Q) e(O, Q) e(-P, Q) == 1,
    the identity leg dropping out; and pairing_checks keeps groups apart."""
    ps, qs = setup_pairs(13, 1)
    p, q = ps[0], qs[0]
    g1 = g1_from_ints([p, None, oracle.g1_neg(p)], "cpu")
    g2 = g2_from_ints([q, q, q], "cpu")
    assert bool(pr.pairing_product_is_one(g1, g2))
    bad = g1_from_ints([p, None, p], "cpu")
    ok = pr.pairing_checks([(g1, g2), (bad, g2),
                            (g1_from_ints([p], "cpu"),
                             g2_from_ints([None], "cpu"))])
    assert ok.tolist() == [True, False, True]


def test_simple_pairing_check():
    """e(2P, Q) == e(P, 2Q) holds; e(2P, Q) == e(P, 3Q) does not."""
    ps, qs = setup_pairs(14, 1)
    p, q = ps[0], qs[0]
    a1 = g1_from_ints([oracle.g1_mul(p, 2)], "cpu")
    a2 = g2_from_ints([q], "cpu")
    b1 = g1_from_ints([p], "cpu")
    assert bool(pr.simple_pairing_check(
        a1, a2, b1, g2_from_ints([oracle.g2_mul(q, 2)], "cpu")))
    assert not bool(pr.simple_pairing_check(
        a1, a2, b1, g2_from_ints([oracle.g2_mul(q, 3)], "cpu")))


@pytest.mark.slow  # the JAX pairing costs minutes of XLA compile on the CPU
def test_pairing_equals_jax():
    from legosnark_tpu.curve import pairing as jpr
    from legosnark_tpu.curve.group import g1_from_oracle, g2_from_oracle
    from test_pairing import f12_to_oracle

    ps, qs = setup_pairs(15, 2)
    jx, jy, _ = jpr._g1aff_jit(g1_from_oracle(ps + ps))
    kx, ky, _ = jpr._g2aff_jit(g2_from_oracle(qs + qs))
    ml = jpr.miller_jit(jx, jy, kx, ky)
    got = _pairing(ps, qs)
    for i in range(2):
        want = f12_to_oracle(jpr.final_exp_jit(ml[..., i : i + 1])[..., 0])
        assert got[i] == want
