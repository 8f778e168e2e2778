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
from legosnark_tpu_torch.utils import trace

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


def _g2_operands():
    """Six points k*G2 and the identity, against a neighbour, the
    identity, P itself and -P."""
    pts = [oracle.g2_mul(oracle.G2, k + 3) for k in range(6)] + [None]
    n = len(pts)
    qs = [[pts[(i + 1) % n], None, p, oracle.g2_neg(p)][i % 4]
          for i, p in enumerate(pts)]
    return pts, qs, tg.g2_from_ints(pts, "cpu"), tg.g2_from_ints(qs, "cpu")


def test_g2_dispatch_equals_plain_on_cpu():
    """G2.add and G2.double(times) take K5/K6's plain versions on the CPU:
    equal to them limb for limb and to the host-integer law; the spans
    count the two new kernels."""
    pts, qs, P, Q = _g2_operands()
    S = tg.G2.add(P, Q)
    for got, want in zip(S, cuda_group.g2_add_points_plain(tuple(P),
                                                           tuple(Q))):
        assert torch.equal(got, want)
    assert tg.g2_to_ints(S) == [oracle.g2_add(p, q) for p, q in zip(pts, qs)]
    for times in (1, 3):
        D = tg.G2.double(P, times=times)
        for got, want in zip(D, cuda_group.g2_double_point_plain(tuple(P),
                                                                 times)):
            assert torch.equal(got, want)
        assert tg.g2_to_ints(D) == [oracle.g2_mul(p, 1 << times) if p else None
                                    for p in pts]
    with pytest.raises(ValueError, match="times"):
        cuda_group.g2_double_point(tuple(P), 0)
    assert {"g2_add", "g2_double"} <= set(trace.KERNELS)


class _KernelFq2:
    """`csrc/g2.cu`'s Fq2 helpers as Fq operations on (c0, c1) pairs, with
    b3 read from the wrapper's constant block."""

    def __init__(self):
        self.F = F = cuda_group.FQ_PLAIN
        w = list(cuda_group._words("G2"))

        def fq(i):
            v = sum(w[i + k] << (32 * k) for k in range(8))
            return fl.tensor(fl.ints_to_limbs([v]), "cpu")
        self.b3, self.b3s = (fq(17), fq(25)), fq(33)
        assert w[:17] == list(cuda_group._words("G1"))[:17]
        assert torch.equal(self.b3s, F.add(*self.b3))
        assert torch.equal(torch.stack(self.b3),
                           tg.FQ2_OPS.const(bn254.B3_G2, "cpu"))

    def add(self, a, b):
        return (self.F.add(a[0], b[0]), self.F.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.F.sub(a[0], b[0]), self.F.sub(a[1], b[1]))

    def _karatsuba(self, a, b, s0, s1):
        F = self.F
        t2 = F.mul(s0, s1)
        t0, t1 = F.mul(a[0], b[0]), F.mul(a[1], b[1])
        return (F.sub(t0, t1), F.sub(t2, F.add(t0, t1)))

    def mul(self, a, b):
        F = self.F
        return self._karatsuba(a, b, F.add(a[0], a[1]), F.add(b[0], b[1]))

    def mul_b3(self, a, looped):
        """a * b3 with each Fq product's operands in the kernel's order:
        K5's `karatsuba_loop` (`looped`) forms a_i * b3_i, K6 b3_i * a_i."""
        sa = self.F.add(a[0], a[1])
        if looped:
            return self._karatsuba(a, self.b3, sa, self.b3s)
        return self._karatsuba(self.b3, a, self.b3s, sa)

    def sqr(self, a):
        F = self.F
        t = F.mul(a[0], a[1])
        return (F.mul(F.add(a[0], a[1]), F.sub(a[0], a[1])), F.add(t, t))


def _k5_order(K, p, q):
    """g2_add_kernel's sequence, line for line, operands in its order."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    t3 = K.mul(K.add(X1, Y1), K.add(X2, Y2))
    t0 = K.mul(X1, X2)
    X3 = K.mul(K.add(X1, Z1), K.add(X2, Z2))
    u = K.add(Y1, Z1)
    t2 = K.mul(Z1, Z2)
    Y3 = K.sub(X3, K.add(t0, t2))
    t1 = K.mul(Y1, Y2)
    X3 = K.add(t0, t0)
    v = K.add(Y2, Z2)
    Y3 = K.mul_b3(Y3, True)
    t3 = K.sub(t3, K.add(t0, t1))
    t4 = K.sub(K.mul(u, v), K.add(t1, t2))
    t0 = K.add(X3, t0)
    t2 = K.mul_b3(t2, True)
    Z3 = K.add(t1, t2)
    t1 = K.sub(t1, t2)
    X3 = K.sub(K.mul(t3, t1), K.mul(t4, Y3))
    Y3 = K.add(K.mul(t1, Z3), K.mul(Y3, t0))
    Z3 = K.add(K.mul(Z3, t4), K.mul(t0, t3))
    return X3, Y3, Z3


def _k6_order(K, p, times):
    """g2_double_kernel's loop, line for line, operands in its order."""
    X, Y, Z = p
    for _ in range(times):
        t3 = K.mul(X, Y)
        t0 = K.sqr(Y)
        t1 = K.mul(Y, Z)
        t2 = K.mul_b3(K.sqr(Z), False)
        Z = K.add(t0, t0)
        Z = K.add(Z, Z)
        Y = K.add(Z, Z)
        Z = K.mul(t1, Y)
        X = K.mul(t2, Y)
        Y = K.add(t0, t2)
        t1 = K.add(K.add(t2, t2), t2)
        t0 = K.sub(t0, t1)
        Y = K.add(X, K.mul(t0, Y))
        X = K.mul(t0, t3)
        X = K.add(X, X)
    return X, Y, Z


def test_g2_kernel_order_equals_plain():
    """K5/K6's Fq operations, in the kernels' order and with their constant
    block, equal the plain versions limb for limb."""
    _, _, P, Q = _g2_operands()
    K = _KernelFq2()

    def pairs(pt):
        return tuple((c[0], c[1]) for c in pt)

    def stack(pt):
        return tuple(torch.stack(c) for c in pt)
    got = stack(_k5_order(K, pairs(P), pairs(Q)))
    for g, w in zip(got, cuda_group.g2_add_points_plain(tuple(P), tuple(Q))):
        assert torch.equal(g, w)
    got = stack(_k6_order(K, pairs(P), 2))
    for g, w in zip(got, cuda_group.g2_double_point_plain(tuple(P), 2)):
        assert torch.equal(g, w)


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
