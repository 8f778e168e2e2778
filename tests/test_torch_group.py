"""Port group law (legosnark_tpu_torch.curve) against the JAX package,
the bigint oracle and the published EIP-196 vectors.

The plain versions of kernels K2/K3 are held against the JAX Pallas
kernels run in interpret mode; points are compared as affine integers,
never as projective limbs (another operation order gives another
(X : Y : Z) of the same point).
"""
import numpy as np
import jax
import pytest
import torch

import oracle
from legosnark_tpu.curve import bn254 as jbn
from legosnark_tpu.curve import pallas_group
from legosnark_tpu.curve.group import G2 as JG2
from legosnark_tpu.curve.group import Point as JPoint
from legosnark_tpu.curve.group import (g1_from_oracle, g1_to_oracle_batch,
                                       g2_from_oracle, g2_to_oracle_batch)

from legosnark_tpu_torch import convert
from legosnark_tpu_torch.curve import bn254, cuda_group
from legosnark_tpu_torch.curve import group as tg
from legosnark_tpu_torch.fields import limb as fl

# EIP-196: 2 * (1, 2) on alt_bn128
TWO_G = (1368015179489954701390400359078579693043519447331113978918064868415326638035,
         9918110051302171585080402603319702774565515993150576347155970296011118125764)

# The plain path runs many small torch ops; idle intra-op threads spin and
# starve the other test processes, so the port's tests use one thread.
torch.set_num_threads(1)


def oracle_points(n, offset=2):
    return [oracle.g1_mul(oracle.G1, k + offset) for k in range(n)]


def cases(pts):
    """Second operands: a neighbour, the identity, P itself and -P."""
    n = len(pts)
    out = []
    for i, p in enumerate(pts):
        out.append([pts[(i + 1) % n], None, p, oracle.g1_neg(p)][i % 4])
    return out


@pytest.mark.parametrize("n", [8, 160])
def test_plain_add_double_match_pallas_interpret(n):
    """n = 160 > 128 is where the Pallas kernels return loose limbs."""
    pts = oracle_points(n)
    qs = cases(pts)
    P, Q = tg.g1_from_ints(pts, "cpu"), tg.g1_from_ints(qs, "cpu")
    S = cuda_group.add_points_plain(P, Q)
    D = cuda_group.double_point_plain(P)

    jP, jQ = g1_from_oracle(pts), g1_from_oracle(qs)
    jS = pallas_group.add_points(jbn.FQ, 9, tuple(jP), tuple(jQ))
    jD = pallas_group.double_point(jbn.FQ, 9, tuple(jP))
    want_s = [oracle.g1_add(p, q) for p, q in zip(pts, qs)]
    want_d = [oracle.g1_add(p, p) for p in pts]
    assert tg.g1_to_ints(tg.Point(*S)) == want_s
    assert tg.g1_to_ints(tg.Point(*D)) == want_d
    assert g1_to_oracle_batch(JPoint(*jS)) == want_s
    assert g1_to_oracle_batch(JPoint(*jD)) == want_d
    assert want_s[1] == pts[1] and want_s[3] is None

    # the JAX outputs (loose limbs at n = 160) carried into the port
    assert tg.g1_to_ints(convert.point_from_jax(
        [np.asarray(c) for c in jS], "cpu")) == want_s


def test_mixed_chain_of_six():
    """Adds and doubles chained at width 160, outputs feeding inputs."""
    n = 160
    pts = oracle_points(n, offset=1)
    P = tg.g1_from_ints(pts, "cpu")
    acc, want = tuple(P), list(pts)
    for step in range(6):
        if step % 3 == 2:
            acc = cuda_group.double_point_plain(acc)
            want = [oracle.g1_add(w, w) for w in want]
        else:
            acc = cuda_group.add_points_plain(acc, tuple(P))
            want = [oracle.g1_add(w, p) for w, p in zip(want, pts)]
    assert tg.g1_to_ints(tg.Point(*acc)) == want


def test_g1_dispatch_equals_plain_on_cpu():
    pts = oracle_points(5)
    P = tg.g1_from_ints(pts, "cpu")
    assert tg.g1_to_ints(tg.G1.add(P, P)) == \
        tg.g1_to_ints(tg.Point(*cuda_group.add_points_plain(P, P)))
    assert tg.g1_to_ints(tg.G1.double(P)) == [oracle.g1_add(p, p) for p in pts]


@pytest.mark.parametrize("times", [1, 4, 17])
@pytest.mark.parametrize("curve", ["G1", "G2"])
def test_double_times(curve, times):
    """double(p, times=k) equals k single doublings limb for limb, and is
    [2^k] p; times < 1 raises."""
    C, mul, to_ints, from_ints, gen = {
        "G1": (tg.G1, oracle.g1_mul, tg.g1_to_ints, tg.g1_from_ints, oracle.G1),
        "G2": (tg.G2, oracle.g2_mul, tg.g2_to_ints, tg.g2_from_ints, oracle.G2),
    }[curve]
    pts = [mul(gen, 5), None]
    P = from_ints(pts, "cpu")
    want = P
    for _ in range(times):
        want = C.double(want)
    got = C.double(P, times=times)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert to_ints(got) == [mul(gen, 5 << times), None]
    if curve == "G1":
        for g, w in zip(cuda_group.double_point(tuple(P), times), want):
            assert torch.equal(g, w)
    with pytest.raises(ValueError, match="times"):
        C.double(P, times=0)
    with pytest.raises(ValueError, match="times"):
        cuda_group.double_point(tuple(P), 0)


def test_g2_add_double_match_jax():
    pts = [oracle.g2_mul(oracle.G2, k + 3) for k in range(3)]
    qs = [pts[1], None, pts[2]]
    P, Q = tg.g2_from_ints(pts, "cpu"), tg.g2_from_ints(qs, "cpu")
    want_s = [oracle.g2_add(p, q) for p, q in zip(pts, qs)]
    want_d = [oracle.g2_add(p, p) for p in pts]
    assert tg.g2_to_ints(tg.G2.add(P, Q)) == want_s
    assert tg.g2_to_ints(tg.G2.double(P)) == want_d
    jP, jQ = g2_from_oracle(pts), g2_from_oracle(qs)
    assert g2_to_oracle_batch(JG2.add(jP, jQ)) == want_s
    assert g2_to_oracle_batch(JG2.double(jP)) == want_d
    # G2 points carried over from JAX
    assert tg.g2_to_ints(convert.point_from_jax(
        [np.asarray(c) for c in jP], "cpu")) == pts
    assert tg.G2.on_curve(P).all()


def test_scalar_mul_and_eip196_vectors():
    g = tg.g1_generator((), "cpu")
    ks = [2, 3, bn254.R - 1, 0, 1, 123456789123456789]
    out = tg.G1.scalar_mul(g, fl.tensor(fl.ints_to_limbs(ks), "cpu"))
    got = tg.g1_to_ints(out)
    assert got[0] == TWO_G
    assert got[2] == (1, bn254.Q - 2)            # (r-1) G = -G
    assert got == [oracle.g1_mul(oracle.G1, k) for k in ks]
    assert tg.g1_to_ints(tg.G1.add(g, g)) == [TWO_G]
    assert tg.G1.eq(out, tg.G1.add(out, tg.G1.identity((len(ks),), "cpu"))).all()
    assert tg.G1.on_curve(out).all()


def test_to_affine_batch_and_scan():
    pts = oracle_points(6) + [None, oracle.G1]
    P = tg.g1_from_ints(pts, "cpu")
    D = tg.G1.double(P)                                # z != 1
    A = tg.to_affine_batch(tg.G1, D)
    want = [oracle.g1_add(p, p) for p in pts]
    assert tg.g1_to_ints(A) == want
    z = [int(v) for v in convert.to_ints(A.z, bn254.FQ)]
    assert z == [0 if w is None else 1 for w in want]
    # the generic scan: prefix and suffix sums of ints, odd and even n
    for n in (1, 2, 7, 8, 33):
        x = torch.arange(1, n + 1).view(1, n)
        add = lambda a, b: (a[0] + b[0],)
        assert tg.scan(add, (x,))[0].tolist() == [list(np.cumsum(range(1, n + 1)))]
        assert tg.scan(add, (x,), reverse=True)[0].tolist() == \
            [list(np.cumsum(range(n, 0, -1))[::-1])]
