"""Port MSM and fixed-base multiplication against the JAX package and the
bigint oracle.

The JAX MSM runs with the test window of conftest (LEGOSNARK_MSM_C=4);
the port's runs with c in {4, 5}, always with signed digits. Results are
compared as affine integers. The JAX side pads every case with zero
scalars to one width, so that its MSM compiles once for all sizes.
"""
import numpy as np
import jax
import pytest
import torch

import oracle
from legosnark_tpu.curve import msm as jmsm
from legosnark_tpu.curve.group import G1 as JG1
from legosnark_tpu.curve.group import (g1_from_oracle, g1_generator as
                                       jg1_generator, g1_to_oracle,
                                       g1_to_oracle_batch)
from legosnark_tpu.fields import limb as jfl

from legosnark_tpu_torch.curve import bn254, msm
from legosnark_tpu_torch.curve import group as tg
from legosnark_tpu_torch.fields import limb as fl

# The plain path runs many small torch ops; idle intra-op threads spin and
# starve the other test processes, so the port's tests use one thread.
torch.set_num_threads(1)

_JAX_MSM = jax.jit(lambda p, s: jmsm.msm(JG1, p, s))
#: the JAX MSM's one width: every case is padded to it with zero scalars
_JAX_N = 256


def jax_msm(pts, scalars):
    pad = _JAX_N - len(pts)
    P = g1_from_oracle(list(pts) + [oracle.G1] * pad)
    return g1_to_oracle(_JAX_MSM(P, jfl.ints_to_limbs(
        list(scalars) + [0] * pad, 20)))


def draw(n, seed):
    rng = np.random.default_rng(seed)
    ks = [int(rng.integers(1, 1 << 40)) for _ in range(n)]
    pts = [oracle.g1_mul(oracle.G1, k) for k in ks]
    scalars = [int.from_bytes(rng.bytes(40), "little") % bn254.R
               for _ in range(n)]
    scalars[0] = 0
    if n > 2:
        scalars[1], scalars[2] = 1, bn254.R - 1
    return pts, ks, scalars


@pytest.fixture(scope="module", params=[7, 33, 256])
def msm_case(request):
    """Inputs, the expected sum and the JAX MSM's result, once per n."""
    n = request.param
    pts, ks, scalars = draw(n, n)
    e = sum(k * s for k, s in zip(ks, scalars)) % bn254.R
    want = oracle.g1_mul(oracle.G1, e)
    jout = jax_msm(pts, scalars)
    jzero = jax_msm(pts, [0] * n)
    return pts, scalars, want, jout, jzero


@pytest.mark.parametrize("c", [4, 5])
def test_msm_matches_jax(msm_case, c):
    pts, scalars, want, jout, jzero = msm_case
    P = tg.g1_from_ints(pts, "cpu")
    s = fl.tensor(fl.ints_to_limbs(scalars), "cpu")
    assert jout == want
    assert tg.g1_to_ints(msm.msm(tg.G1, P, s, c=c)) == [want]
    zero = fl.tensor(fl.ints_to_limbs([0] * len(pts)), "cpu")
    assert jzero is None
    assert tg.g1_to_ints(msm.msm(tg.G1, P, zero, c=c)) == [None]


def test_msm_batched_bases_share_scalars():
    """A leading batch of bases runs as one MSM over shared scalars."""
    pts, ks, scalars = draw(9, 3)
    P = tg.g1_from_ints(pts, "cpu")
    P2 = tg.G1.double(P)
    both = tg.point_stack([P, P2])
    out = msm.msm(tg.G1, both, fl.tensor(fl.ints_to_limbs(scalars), "cpu"),
                  c=4)
    e = sum(k * s for k, s in zip(ks, scalars)) % bn254.R
    assert tg.g1_to_ints(out) == [oracle.g1_mul(oracle.G1, e),
                                  oracle.g1_mul(oracle.G1, 2 * e)]


def test_msm_batched_scalars():
    """Rows of scalars against shared bases, and against a batch of bases
    (broadcast), run as one MSM; each row equals its MSM alone."""
    pts, ks, scalars = draw(9, 5)
    rows = [scalars, scalars[::-1], [0] * 9]
    P = tg.g1_from_ints(pts, "cpu")
    s = torch.stack([fl.tensor(fl.ints_to_limbs(r), "cpu") for r in rows])
    want = [oracle.g1_mul(oracle.G1, sum(k * x for k, x in zip(ks, r)))
            for r in rows]
    out = msm.msm(tg.G1, P, s, c=4)
    assert out.x.shape == (3, 8, 1)
    assert tg.g1_to_ints(out) == want
    alone = msm.msm(tg.G1, P, s[1], c=4)
    assert all(torch.equal(a, b[1]) for a, b in zip(alone, out))
    both = tg.point_stack([P, tg.G1.double(P)])             # [2, 8, 9]
    out2 = msm.msm(tg.G1, tg.Point(*(t[:, None] for t in both)), s, c=4)
    assert out2.x.shape == (2, 3, 8, 1)
    assert tg.g1_to_ints(out2) == want + [oracle.g1_mul(w, 2) for w in want]


def test_g2_msm_matches_oracle():
    rng = np.random.default_rng(6)
    ks = [int(rng.integers(1, 1 << 30)) for _ in range(5)]
    scalars = [int.from_bytes(rng.bytes(40), "little") % bn254.R
               for _ in range(5)]
    Q = tg.G2.scalar_mul(tg.g2_generator((), "cpu"),
                         fl.tensor(fl.ints_to_limbs(ks), "cpu"))
    out = msm.msm(tg.G2, Q, fl.tensor(fl.ints_to_limbs(scalars), "cpu"), c=4)
    e = sum(k * x for k, x in zip(ks, scalars))
    assert tg.g2_to_ints(out) == [oracle.g2_mul(oracle.G2, e)]


def test_fixed_base_batch_matches_jax():
    rng = np.random.default_rng(4)
    ks = [int.from_bytes(rng.bytes(40), "little") % bn254.R
          for _ in range(12)] + [0, 1, bn254.R - 1]
    table = msm.fixed_base_table(tg.G1, tg.g1_generator((), "cpu"), c=8)
    assert table.x.shape == (32, 8, 256)
    got = tg.g1_to_ints(msm.batch_scalar_mul(
        tg.G1, table, fl.tensor(fl.ints_to_limbs(ks), "cpu"), c=8))
    jtable = jmsm.fixed_base_table(JG1, jg1_generator(), c=8)
    jgot = g1_to_oracle_batch(jmsm.batch_scalar_mul(
        JG1, jtable, jfl.ints_to_limbs(ks, 20), c=8))
    assert got == jgot == [oracle.g1_mul(oracle.G1, k) for k in ks]
    # the table itself: T[j, m] = m * 2^(8j) * G
    for j, m in [(0, 0), (0, 1), (3, 255), (31, 7)]:
        pt = tg.Point(*(t[j, :, m : m + 1] for t in table))
        assert tg.g1_to_ints(pt) == [oracle.g1_mul(oracle.G1, m << (8 * j))]


def test_fixed_base_batch_in_chunks(monkeypatch):
    """Chunks of 4 scalars (4 + 4 + 4 + 3) give the one-chunk batch."""
    rng = np.random.default_rng(5)
    ks = [int.from_bytes(rng.bytes(40), "little") % bn254.R
          for _ in range(15)]
    table = msm.generator_table(tg.G1, torch.device("cpu"))
    s = fl.tensor(fl.ints_to_limbs(ks), "cpu")
    whole = msm.batch_scalar_mul(tg.G1, table, s)
    monkeypatch.setattr(msm, "BATCH_CHUNK", 4)
    out = msm.batch_scalar_mul(tg.G1, table, s)
    assert all(torch.equal(a, b) for a, b in zip(out, whole))
    assert tg.g1_to_ints(out) == [oracle.g1_mul(oracle.G1, k) for k in ks]


# ---------------------------------------------------------------------------
# Windows in memory-bounded chunks (`msm.windows_per_chunk`)
# ---------------------------------------------------------------------------


#: scalars below a 24-bit prime: 7 windows of c = 4, so that a G2 MSM's
#: Horner tail is 24 plain doublings, not ~255
_SMALL = fl.FieldSpec(16777213)


@pytest.fixture(scope="module", params=["G1", "G2"])
def chunk_case(request):
    """Two sets of bases against three rows of 24-bit scalars (lead
    (2, 3)), the expected sums from the oracle and the all-at-once MSM."""
    curve = request.param
    C, gen, mul, base, n = ((tg.G1, tg.g1_generator, oracle.g1_mul,
                             oracle.G1, 9) if curve == "G1" else
                            (tg.G2, tg.g2_generator, oracle.g2_mul,
                             oracle.G2, 5))
    rng = np.random.default_rng(21)
    ks = [int(rng.integers(1, 1 << 30)) for _ in range(n)]
    rows = [[int(x) for x in rng.integers(0, _SMALL.p, n)] for _ in range(3)]
    rows[2][:2] = [0, _SMALL.p - 1]
    P = C.scalar_mul(gen((), "cpu"), fl.tensor(fl.ints_to_limbs(ks), "cpu"))
    both = tg.point_stack([P, C.double(P)])                 # [2, E.., n]
    bases = tg.Point(*(t[:, None] for t in both))           # [2, 1, E.., n]
    s = torch.stack([fl.tensor(fl.ints_to_limbs(r), "cpu") for r in rows])
    want = [mul(base, m * sum(k * x for k, x in zip(ks, r)) % bn254.R)
            for m in (1, 2) for r in rows]
    return C, bases, s, want, msm.msm(C, bases, s, c=4, fr_spec=_SMALL)


def _affine_ints(C, p):
    """Flat affine ints of a batch [lead.., E.., 1]."""
    if C is tg.G1:
        return tg.g1_to_ints(p)
    return tg.g2_to_ints(tg.point_map(lambda t: t.movedim(-3, 0), p))


@pytest.mark.parametrize("width", [1, 2, "W"])
def test_chunked_msm_equals_all_at_once(chunk_case, width):
    """Any chunk width gives the all-at-once MSM, which the oracle holds."""
    C, bases, s, want, whole = chunk_case
    W = -(-(_SMALL.bits + 1) // 4)
    assert W == 7 and msm.windows_per_chunk(C, W, (2, 3), s.shape[-1]) == W
    out = msm.msm(C, bases, s, c=4, fr_spec=_SMALL,
                  window_chunk=W if width == "W" else width)
    assert out.x.shape == whole.x.shape
    assert _affine_ints(C, tg.to_affine_batch(C, out)) == \
        _affine_ints(C, tg.to_affine_batch(C, whole))
    assert all(torch.equal(a, b) for a, b in zip(out, whole))
    if width == "W":
        assert _affine_ints(C, whole) == want


def test_chunked_msm_matches_jax():
    """Three windows per chunk against the JAX MSM (its one compiled
    width)."""
    pts, ks, scalars = draw(33, 17)
    want = oracle.g1_mul(oracle.G1, sum(k * s for k, s in zip(ks, scalars)))
    P = tg.g1_from_ints(pts, "cpu")
    s = fl.tensor(fl.ints_to_limbs(scalars), "cpu")
    out = msm.msm(tg.G1, P, s, c=5, window_chunk=3)
    assert tg.g1_to_ints(out) == [jax_msm(pts, scalars)] == [want]
    with pytest.raises(ValueError, match="window_chunk"):
        msm.msm(tg.G1, P, s, c=5, window_chunk=0)


#: (curve, lead, points, window c, chunks planned): Groth16's MSMs at
#: n = 128 (the two-row A/B1 MSM, the G2 B MSM, the C MSM, commit_emul),
#: and the widest MSMs of the other paths, which must stay in one chunk
_PLANS = [("G1", (2,), 2129922, 17, 2), ("G2", (), 2129922, 17, 4),
          ("G1", (), 4210690, 17, 2), ("G1", (), 2113536, 17, 1),
          ("G1", (), 1 << 20, 16, 1), ("G1", (), 1 << 20, 17, 1),
          ("G1", (2,), 1 << 20, 17, 1), ("G1", (2, 2), 1 << 19, 17, 1)]


@pytest.mark.parametrize("curve,lead,n,c,chunks", _PLANS)
def test_window_plan_fits_the_budget(curve, lead, n, c, chunks, monkeypatch):
    C = tg.G1 if curve == "G1" else tg.G2
    W = -(-(bn254.FR.bits + 1) // c)
    k = msm.windows_per_chunk(C, W, lead, n)
    per = msm.window_bytes(C, lead, n)
    words = 8 if curve == "G1" else 16
    copies = msm.LIVE_COPIES_G1 if curve == "G1" else msm.LIVE_COPIES_G2
    assert per == copies * 3 * int(np.prod(lead)) * words * n * 4
    assert k * per <= msm.WINDOW_BUDGET
    assert -(-W // k) == chunks == -(-W // (msm.WINDOW_BUDGET // per))
    # the chunks are as even as their count allows
    assert k == -(-W // chunks)
    monkeypatch.setattr(msm, "WINDOW_BUDGET", 0)
    assert msm.windows_per_chunk(C, W, lead, n) == 1
