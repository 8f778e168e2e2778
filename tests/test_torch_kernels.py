"""The port's CUDA kernels against their plain versions on the card.

Needs a CUDA card: each test takes the `cuda` fixture, which skips on a
machine without one. This file imports nothing of JAX, so it also runs
where JAX is missing:
    python -m pytest tests/test_torch_kernels.py --noconftest -m requires_cuda
"""
import math

import numpy as np
import pytest
import torch

from legosnark_tpu_torch import kernels
from legosnark_tpu_torch.curve import bn254, cuda_group, msm
from legosnark_tpu_torch.curve import group as tg
from legosnark_tpu_torch.curve import pairing as pr
from legosnark_tpu_torch.fields import cuda_limb
from legosnark_tpu_torch.fields import limb as fl
from legosnark_tpu_torch.probes import mont_variants as mv
from legosnark_tpu_torch.utils import transcript as ttr
from legosnark_tpu_torch.utils.bench import edge_ints, rand_below

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand(gen, n, bound):
    return [int.from_bytes(torch.randint(0, 256, (40,), generator=gen,
                                         dtype=torch.uint8).numpy().tobytes(),
                           "little") % bound for _ in range(n)]


@pytest.mark.parametrize("spec", [bn254.FR, bn254.FQ], ids=["Fr", "Fq"])
def test_k1_equals_plain(cuda, spec):
    gen = torch.Generator().manual_seed(1)
    p = spec.p
    xs = [0, 1, p - 1, p, 2 * p - 1, (1 << 224) - 1] + _rand(gen, 1500, 2 * p)
    ys = [2 * p - 1] * 6 + _rand(gen, 1500, 2 * p)
    a = fl.tensor(fl.ints_to_limbs(xs), cuda).view(8, 2, -1).transpose(0, 1)
    b = fl.tensor(fl.ints_to_limbs(ys), cuda).view(8, 2, -1).transpose(0, 1)
    kernels.reset_launches()
    got = cuda_limb.mont_mul(spec, a, b)
    torch.cuda.synchronize()
    assert kernels.launches["mont_mul"] == 1
    assert torch.equal(got, cuda_limb.mont_mul_plain(spec, a, b))
    # an [8, 1] operand broadcast against [8, n]
    got = cuda_limb.mont_mul(spec, a[0], a[0][:, :1])
    assert torch.equal(got, cuda_limb.mont_mul_plain(spec, a[0], a[0][:, :1]))


def _g1_operands(cuda, n):
    """Coordinates of n points k*G (k = 1..n) with the identity and two
    off-curve points of edge coordinates (0 and 2q - 1) mixed in, and a
    second operand that is P itself, -P, the identity or a neighbour."""
    table = msm.fixed_base_table(tg.G1, tg.g1_generator((), cuda), c=8)
    ks = fl.tensor(fl.ints_to_limbs(range(1, n + 1)), cuda)
    P = msm.batch_scalar_mul(tg.G1, table, ks, c=8)
    lo, hi = (fl.tensor(fl.ints_to_limbs([v]), cuda)
              for v in (0, 2 * bn254.Q - 1))
    kind = torch.arange(n, device=cuda) % 7
    P = tg.G1.select(kind == 4, tg.G1.identity((n,), cuda), P)
    P = tg.G1.select(kind == 5, tg.Point(hi, lo, hi), P)
    P = tg.G1.select(kind == 6, tg.Point(lo, hi, hi), P)
    sel = torch.arange(n, device=cuda) % 4
    Q = tg.Point(*(t.roll(1, -1) for t in P))
    Q = tg.G1.select(sel == 0, P, Q)
    Q = tg.G1.select(sel == 1, tg.G1.neg(P), Q)
    Q = tg.G1.select(sel == 2, tg.G1.identity((n,), cuda), Q)
    return (tuple(t.contiguous() for t in P),
            tuple(t.contiguous() for t in Q))


@pytest.mark.parametrize("n", [1, 3, 1000, 1 << 16])
def test_k2_k3_equal_plain(cuda, n):
    p, q = _g1_operands(cuda, n)
    cases = [(p, q)]
    if n % 2 == 0:   # a leading batch axis: [2, 8, n / 2]
        cases.append(tuple(tuple(t.view(8, 2, n // 2).transpose(0, 1)
                                 .contiguous() for t in x) for x in (p, q)))
    for p, q in cases:
        kernels.reset_launches()
        s = cuda_group.add_points(p, q)
        torch.cuda.synchronize()
        assert kernels.launches == {"g1_add": 1}
        for got, want in zip(s, cuda_group.add_points_plain(p, q)):
            assert torch.equal(got, want)
        if n >= 3 and s[0].dim() == 2:   # P + (-P) at index 1
            assert tg.g1_to_ints(tg.Point(*(t[:, 1:2] for t in s))) == [None]
        for times in (1, 4, 17):
            kernels.reset_launches()
            d = cuda_group.double_point(p, times)
            torch.cuda.synchronize()
            assert kernels.launches == {"g1_double": 1}
            assert kernels.launch_widths["g1_double"] == {
                (n, times): 1}
            for got, want in zip(d, cuda_group.double_point_plain(p, times)):
                assert torch.equal(got, want)


def _g2_operands(cuda, n):
    """Coordinates [2, 8, n] of n points k*G2 (k = 1..n) with the identity
    and two off-curve points of edge coordinates (0 and 2q - 1) mixed in,
    a second operand that is P itself, -P, the identity or a neighbour,
    and where P, and P and Q both, lie on the curve."""
    table = msm.fixed_base_table(tg.G2, tg.g2_generator((), cuda), c=8)
    ks = fl.tensor(fl.ints_to_limbs(range(1, n + 1)), cuda)
    P = msm.batch_scalar_mul(tg.G2, table, ks, c=8)
    lo, hi = (fl.tensor(fl.ints_to_limbs([v, v]), cuda).T.reshape(2, 8, 1)
              for v in (0, 2 * bn254.Q - 1))
    kind = torch.arange(n, device=cuda) % 7
    P = tg.G2.select(kind == 4, tg.G2.identity((n,), cuda), P)
    P = tg.G2.select(kind == 5, tg.Point(hi, lo, hi), P)
    P = tg.G2.select(kind == 6, tg.Point(lo, hi, hi), P)
    sel = torch.arange(n, device=cuda) % 4
    Q = tg.Point(*(t.roll(1, -1) for t in P))
    Q = tg.G2.select(sel == 0, P, Q)
    Q = tg.G2.select(sel == 1, tg.G2.neg(P), Q)
    Q = tg.G2.select(sel == 2, tg.G2.identity((n,), cuda), Q)
    on_p = kind < 5
    on_q = torch.where(sel == 3, on_p.roll(1, -1), on_p | (sel == 2))
    return (tuple(t.contiguous() for t in P),
            tuple(t.contiguous() for t in Q), on_p, on_p & on_q)


@pytest.mark.parametrize("n", [1, 31, 1000])
def test_k5_k6_equal_plain(cuda, n):
    """K5 and K6 (times 1, 4, 17) bit for bit against their plain versions,
    flat and with a leading batch axis ([2, 2, 8, n / 2]); results of
    on-curve inputs on the curve; each one launch counted under g2_add /
    g2_double and none under the G1 names."""
    p, q, on_p, on_pq = _g2_operands(cuda, n)
    cases = [(p, q, on_p, on_pq)]
    if n % 2 == 0:
        def split(t):
            return t.view(2, 8, 2, n // 2).permute(2, 0, 1, 3).contiguous()
        cases.append((tuple(map(split, p)), tuple(map(split, q)),
                      on_p.view(2, n // 2), on_pq.view(2, n // 2)))
    for p, q, on_p, on_pq in cases:
        kernels.reset_launches()
        s = cuda_group.g2_add_points(p, q)
        torch.cuda.synchronize()
        assert kernels.launches == {"g2_add": 1}
        assert kernels.launch_widths["g2_add"] == {(n, 1): 1}
        for got, want in zip(s, cuda_group.g2_add_points_plain(p, q)):
            assert torch.equal(got, want)
        assert tg.G2.on_curve(tg.Point(*s))[on_pq].all()
        if n >= 3 and s[0].dim() == 3:   # P + (-P) at index 1
            assert tg.g2_to_ints(tg.Point(*(t[..., 1:2] for t in s))) == [None]
        for times in (1, 4, 17):
            kernels.reset_launches()
            d = cuda_group.g2_double_point(p, times)
            torch.cuda.synchronize()
            assert kernels.launches == {"g2_double": 1}
            assert kernels.launch_widths["g2_double"] == {(n, times): 1}
            for got, want in zip(d, cuda_group.g2_double_point_plain(p,
                                                                     times)):
                assert torch.equal(got, want)
            assert tg.G2.on_curve(tg.Point(*d))[on_p].all()


def test_g2_msm_span_counts_k5_k6(cuda):
    """A G2 MSM on the card runs its group law on K5/K6 alone (no K2/K3
    launch in its span) and gives the point the same MSM gives on the CPU
    (as affine integers: the sort orders equal digits by device, so the
    sums' projective coordinates differ)."""
    from legosnark_tpu_torch.utils import trace

    n = 40
    table = msm.fixed_base_table(tg.G2, tg.g2_generator((), cuda), c=8)
    P = msm.batch_scalar_mul(tg.G2, table, fl.tensor(
        fl.ints_to_limbs(range(3, n + 3)), cuda), c=8)
    s = fl.tensor(fl.ints_to_limbs([(7 ** k) % bn254.R for k in range(n)]),
                  cuda)
    trace.enable()
    try:
        got = msm.msm(tg.G2, P, s, c=5)
        torch.cuda.synchronize()
        spans = [sp for sp in trace.drain() if sp.name == "msm"]
    finally:
        trace.disable()
    assert len(spans) == 1 and spans[0].attrs["curve"] == "G2"
    launches = spans[0].launches
    assert launches["g2_add"] > 0 and launches["g2_double"] > 0
    assert launches["g1_add"] == launches["g1_double"] == 0
    want = msm.msm(tg.G2, tg.Point(*(t.cpu() for t in P)), s.cpu(), c=5)
    assert tg.g2_to_ints(tg.Point(*(t.cpu() for t in got))) == \
        tg.g2_to_ints(want)


@pytest.mark.parametrize("spec", [bn254.FR, bn254.FQ], ids=["Fr", "Fq"])
def test_p1_equals_plain_and_k1(cuda, spec):
    gen = torch.Generator().manual_seed(2)
    p = spec.p
    xs = edge_ints(p) + _rand(gen, 1500, 2 * p)
    ys = edge_ints(p)[::-1] + _rand(gen, 1500, 2 * p)
    a = fl.tensor(fl.ints_to_limbs(xs), cuda)
    b = fl.tensor(fl.ints_to_limbs(ys), cuda)
    kernels.reset_launches()
    sos = mv.mont_mul_sos(spec, a, b)
    tc = mv.mont_mul_tc(spec, a, b)
    torch.cuda.synchronize()
    assert kernels.launches["mont_mul_sos"] == 1
    assert kernels.launches["mont_mul_tc"] == 1
    k1 = cuda_limb.mont_mul(spec, a, b)
    assert torch.equal(sos, mv.mont_mul_sos_plain(spec, a, b))
    assert torch.equal(tc, mv.mont_mul_tc_plain(spec, a, b))
    assert torch.equal(sos, k1) and torch.equal(tc, k1)


@pytest.mark.parametrize("shape", [(8, 1), (8, 15), (8, 17), (8, 33),
                                   (8, (1 << 10) + 5), (3, 8, 37)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("spec", [bn254.FR, bn254.FQ], ids=["Fr", "Fq"])
def test_p1b_ragged_and_batched(cuda, spec, shape):
    """P1b at widths that leave a warp or a block part full, and on a
    batch: every lane takes part in each mma, only valid ones load and
    store."""
    gen = torch.Generator().manual_seed(4)
    p = spec.p
    count = (shape[0] if len(shape) == 3 else 1) * shape[-1]
    xs = (edge_ints(p) + _rand(gen, count, 2 * p))[:count]
    ys = (edge_ints(p)[::-1] + _rand(gen, count, 2 * p))[:count]
    a, b = (fl.tensor(fl.ints_to_limbs(v), cuda).view(8, -1, shape[-1])
            .transpose(0, 1).reshape(shape).contiguous() for v in (xs, ys))
    kernels.reset_launches()
    tc = mv.mont_mul_tc(spec, a, b)
    torch.cuda.synchronize()
    assert kernels.launches["mont_mul_tc"] == 1 and tc.shape == a.shape
    assert torch.equal(tc, mv.mont_mul_tc_plain(spec, a, b))
    assert torch.equal(tc, cuda_limb.mont_mul(spec, a, b))


@pytest.mark.parametrize("variant", mv.VARIANTS)
def test_p2_equals_plain(cuda, variant):
    gen = torch.Generator().manual_seed(3)
    full = (1 << 256) - 1
    xs = [0, full, full] + _rand(gen, 1500, 1 << 256)
    ys = [full, full, 1] + _rand(gen, 1500, 1 << 256)
    a = fl.tensor(fl.ints_to_limbs(xs), cuda)
    b = fl.tensor(fl.ints_to_limbs(ys), cuda)
    kernels.reset_launches()
    got = mv.limb_product(a, b, variant)
    torch.cuda.synchronize()
    assert kernels.launches[f"limb_product_{variant}"] == 1
    assert torch.equal(got, mv.limb_product_plain(a, b, variant))


@pytest.mark.parametrize("width", [1, 2, 3, 1000, 1 << 16])
def test_mimc_equals_plain(cuda, width):
    """K4 against the torch loop: the plain form, permute(x + y) (at width
    1 the absorb's state + digest) and the tree's combine at even and odd
    m, each one launch."""
    rng = np.random.default_rng(width)
    r = bn254.R
    edge = [0, 1, r - 1, r, 2 * r - 1]
    xs = (edge + rand_below(rng, width, 2 * r))[:width]
    ys = (edge[::-1] + rand_below(rng, width, 2 * r))[:width]
    x, y = (fl.tensor(fl.ints_to_limbs(v), cuda) for v in (xs, ys))
    cases = [(lambda: ttr.permute(x), lambda: ttr.permute_plain(x)),
             (lambda: ttr.permute(x, y), lambda: ttr.permute_plain(x, y))]
    for m in sorted({width, width - 1} - {0, 1}):
        h = x[:, :m]
        cases.append((lambda h=h: ttr.combine(h),
                      lambda h=h: ttr.combine_plain(h)))
    for fn, plain in cases:
        kernels.reset_launches()
        got = fn()
        torch.cuda.synchronize()
        assert kernels.launches == {"mimc": 1}
        assert torch.equal(got, plain())


def _gen_mul(cuda, ks1, ks2):
    """[k]G1 for k in ks1 and [k]G2 for k in ks2 (ints below r), as the
    projective points the fixed-base batch gives."""
    def mul(C, gen, ks):
        table = msm.fixed_base_table(C, gen((), cuda), c=8)
        return msm.batch_scalar_mul(C, table, fl.tensor(
            fl.ints_to_limbs(ks), cuda), c=8)
    return mul(tg.G1, tg.g1_generator, ks1), mul(tg.G2, tg.g2_generator, ks2)


def _rand_z(rng, cuda, lead, n):
    """Random nonzero Fq values [*lead, 8, n] in Montgomery form."""
    m = math.prod(lead)
    vals = [int(v) for v in rng.integers(1, 1 << 62, size=m * n)]
    t = fl.tensor(bn254.FQ.to_mont_ints(vals), cuda)
    return t.view(8, m, n).transpose(0, 1).reshape(lead + (8, n))


def _pairing_legs(cuda, n):
    """n pairs of legs with random z (each coordinate times one random
    Fq or Fq2 value): the generators at lane 0 (z = 1), at lanes 1, 2
    and 3 (n >= 4) the identity in G1, in G2 and in both, elsewhere
    random multiples."""
    rng = np.random.default_rng(n)
    ks = [int(v) for v in rng.integers(1, 1 << 62, size=2 * n)]
    P, Q = _gen_mul(cuda, ks[:n], ks[n:])
    lane = torch.arange(n, device=cuda)
    z1 = _rand_z(rng, cuda, (), n)
    z2 = _rand_z(rng, cuda, (2,), n)
    P = tg.Point(*(tg.FQ_OPS.mul(t, z1) for t in P))
    Q = tg.Point(*(tg.FQ2_OPS.mul(t, z2) for t in Q))
    P = tg.G1.select(lane == 0, tg.g1_generator((n,), cuda), P)
    Q = tg.G2.select(lane == 0, tg.g2_generator((n,), cuda), Q)
    P = tg.G1.select((lane == 1) | (lane == 3), tg.G1.identity((n,), cuda), P)
    Q = tg.G2.select((lane == 2) | (lane == 3), tg.G2.identity((n,), cuda), Q)
    return (tg.Point(*(t.contiguous() for t in P)),
            tg.Point(*(t.contiguous() for t in Q)))


def _canon(t):
    return fl.canon(bn254.FQ, t)


@pytest.mark.parametrize("n", [1, 4, 130])
def test_k7_k8_equal_plain(cuda, n):
    """K7 against the plain Miller values (`_miller_masked`: affine legs,
    `miller_loop_plain`, identities masked), K8 against
    `final_exp_plain` of the plain products, bit for bit on canonical
    values, one launch each; the affine entry points too."""
    P, Q = _pairing_legs(cuda, n)
    kernels.reset_launches()
    got = pr.miller_values(P, Q)
    torch.cuda.synchronize()
    assert kernels.launches == {"pairing_miller": 1}
    assert kernels.launch_widths["pairing_miller"] == {(n, 1): 1}
    want = pr._miller_masked(P, Q)
    assert torch.equal(got, _canon(want))
    # K8 over a table: every pair, single pairs, and a row of padding
    rows = [list(range(n)), [0], [n - 1, n], [n, n]]
    width = max(map(len, rows))
    idx = torch.tensor([r + [n] * (width - len(r)) for r in rows])
    kernels.reset_launches()
    fe = pr.final_exps(got, idx)
    torch.cuda.synchronize()
    assert kernels.launches == {"pairing_final_exp": 1}
    ones = torch.cat([want, pr.F12.one((1,), cuda)], dim=-1)
    prods = pr._tree_prod(ones[..., idx.to(cuda)].movedim(-2, 0))
    assert torch.equal(fe, _canon(pr.final_exp_plain(prods)))
    # the affine entry points: miller_loop (K7 with z = 1), final_exp
    px, py, v1 = pr.g1_affine(P)
    qx, qy, v2 = pr.g2_affine(Q)
    kernels.reset_launches()
    ml = pr.miller_loop(px, py, qx, qy)
    e = pr.final_exp(ml)
    torch.cuda.synchronize()
    assert kernels.launches == {"pairing_miller": 1, "pairing_final_exp": 1}
    plain_ml = pr.miller_loop_plain(px, py, qx, qy)
    assert torch.equal(ml, _canon(plain_ml))
    assert torch.equal(e, _canon(pr.final_exp_plain(plain_ml)))


def _product_groups(cuda, sizes, tampered):
    """One group of pairs per size (even): pairs (aG1, bG2) and (-abG1,
    G2), whose product of pairings is 1, in random projective form; a
    group of odd size also has an identity leg. Group `tampered` has
    ab + 1 in place of ab."""
    rng = np.random.default_rng(len(sizes))
    r = bn254.R
    ks1, ks2 = [], []
    for k, s in enumerate(sizes):
        for i in range(s // 2):
            a, b = (int(v) for v in rng.integers(1, 1 << 62, size=2))
            ab = (a * b + (k == tampered and i == 0)) % r
            ks1 += [a, (r - ab) % r]
            ks2 += [b, 1]
        if s % 2:
            ks1.append(0)
            ks2.append(int(rng.integers(1, 1 << 62)))
    P, Q = _gen_mul(cuda, ks1, ks2)
    n = len(ks1)
    z1, z2 = _rand_z(rng, cuda, (), n), _rand_z(rng, cuda, (2,), n)
    P = tg.Point(*(tg.FQ_OPS.mul(t, z1) for t in P))
    Q = tg.Point(*(tg.FQ2_OPS.mul(t, z2) for t in Q))
    groups, off = [], 0
    for s in sizes:
        groups.append(tuple(tg.Point(*(t[..., off:off + s].contiguous()
                                       for t in pt)) for pt in (P, Q)))
        off += s
    return groups


def _plain_checks(groups):
    sizes = [g.x.shape[-1] for g, _ in groups]
    f = pr.final_exp_plain(pr._grouped_miller(groups, sizes))
    return pr.F12.is_one(f)[..., 0]


@pytest.mark.parametrize("shape", ["groth16", "cpmmp"])
def test_pairing_checks_k7_k8_verdicts(cuda, shape):
    """pairing_checks and pairing_product_is_one on the card give the
    plain path's verdicts: Groth16's one group of four pairs (and the same
    group tampered), CPmmp's 2 x (one group of 2 pairs, one of 21, twenty
    of 2) with group 5 tampered (and an identity leg in each odd group);
    one K7 and one K8 launch per check and no K1 launch inside its span."""
    from legosnark_tpu_torch.utils import trace

    if shape == "groth16":
        cases = [([4], None), ([4], 0)]
    else:
        cases = [(([2, 21] + [2] * 20) * 2, 5)]
    for sizes, tampered in cases:
        groups = _product_groups(cuda, sizes, tampered)
        want = [k != tampered for k in range(len(sizes))]
        trace.enable()
        try:
            kernels.reset_launches()
            got = pr.pairing_checks(groups)
            torch.cuda.synchronize()
            spans = [s for s in trace.drain() if s.name == "pairing.checks"]
        finally:
            trace.disable()
        assert got.tolist() == want
        assert kernels.launches == {"pairing_miller": 1,
                                    "pairing_final_exp": 1}
        (span,) = spans
        assert span.launches["pairing_miller"] == 1
        assert span.launches["pairing_final_exp"] == 1
        assert span.launches["mont_mul"] == 0
        assert _plain_checks(groups).tolist() == want
        if len(sizes) == 1:
            assert bool(pr.pairing_product_is_one(*groups[0])) == want[0]
            # a leading batch axis: the group twice, as two products
            g2 = [tg.point_stack([g, g]) for g in groups[0]]
            assert pr.pairing_product_is_one(*g2).tolist() == want * 2
