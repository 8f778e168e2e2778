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
