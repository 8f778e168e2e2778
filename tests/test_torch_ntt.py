"""The port's NTT module (legosnark_tpu_torch.prototools.ntt) and the
degree-3 sumcheck round against the JAX package at log_n = 3 and 4,
exact on canonical integers, on the same numpy-seeded inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from legosnark_tpu.curve import bn254 as jbn
from legosnark_tpu.prototools import mle as jmle
from legosnark_tpu.prototools import ntt as jntt

from legosnark_tpu_torch import convert
from legosnark_tpu_torch.curve import bn254
from legosnark_tpu_torch.fields import limb as fl
from legosnark_tpu_torch.prototools import mle, ntt

# The plain path runs many small torch ops; idle intra-op threads spin and
# starve the other test processes, so the port's tests use one thread.
torch.set_num_threads(1)

R = bn254.R


def both(shape, seed):
    """Uniform Fr ints -> (port tensor, JAX array), Montgomery, with the
    limb axis ahead of the last axis of `shape`."""
    rng = np.random.default_rng(seed)
    flat = [int.from_bytes(rng.bytes(40), "little") % R
            for _ in range(int(np.prod(shape)))]
    lead, m = tuple(shape[:-1]), shape[-1]

    def lay(arr, L):
        return np.moveaxis(np.asarray(arr).reshape((L,) + lead + (m,)), 0, -2)
    return (fl.tensor(lay(bn254.FR.to_mont_ints(flat), 8), "cpu"),
            jnp.asarray(lay(jbn.FR.to_mont_ints(flat), 20)))


def ints(t):
    return [int(v) for v in convert.to_ints(t).reshape(-1)]


def jints(j):
    return [int(v) for v in
            convert.jax_field_ints(np.asarray(j), bn254.FR).reshape(-1)]


def same(t, j):
    assert tuple(t.shape[:-2]) + t.shape[-1:] == \
        tuple(j.shape[:-2]) + j.shape[-1:]
    assert ints(t) == jints(j)


def test_domain_constants_equal_jax():
    for log_n in range(0, 29):
        assert bn254.fr_two_adic_root(log_n) == jbn.fr_two_adic_root(log_n)
    assert bn254.fr_multiplicative_generator() == \
        jbn.fr_multiplicative_generator()
    with pytest.raises(ValueError):
        bn254.fr_two_adic_root(29)


@pytest.mark.parametrize("log_n", [3, 4])
def test_tables_equal_jax(log_n):
    n = 1 << log_n
    assert ntt._bitrev_on(log_n, torch.device("cpu")).tolist() == \
        jntt._bitrev(log_n).tolist()
    base = bn254.fr_two_adic_root(log_n)
    same(ntt._powers(base, log_n, "cpu"), jntt._powers(base, log_n))
    for s in range(1, log_n + 1):
        for inverse in (False, True):
            same(ntt._stage_twiddle(log_n, s, inverse, "cpu"),
                 jntt._stage_twiddle(log_n, s, inverse))
    assert ntt._powers(base, log_n, "cpu").shape == (8, n)


@pytest.mark.parametrize("log_n", [3, 4])
def test_transforms_equal_jax(log_n):
    n = 1 << log_n
    a, ja = both((2, n), 100 + log_n)       # two vectors at once
    same(ntt.ntt(a), jntt.ntt(ja))
    same(ntt.intt(a), jntt.intt(ja))
    same(ntt.coset_ntt(a), jntt.coset_ntt(ja))
    same(ntt.coset_intt(a), jntt.coset_intt(ja))
    same(ntt.divide_by_z_on_coset(a), jntt.divide_by_z_on_coset(ja))
    assert ints(ntt.intt(ntt.ntt(a))) == ints(a)
    assert ints(ntt.coset_intt(ntt.coset_ntt(a))) == ints(a)


@pytest.mark.parametrize("log_n", [3, 4])
def test_poly_mul_and_domain_queries_equal_jax(log_n):
    n = 1 << log_n
    a, ja = both((n - 3,), 200 + log_n)
    b, jb = both((n // 2 + 2,), 300 + log_n)
    same(ntt.poly_mul_ntt(a, b), jntt.poly_mul_ntt(ja, jb))
    want = [0] * (a.shape[-1] + b.shape[-1] - 1)
    for i, x in enumerate(ints(a)):
        for j, y in enumerate(ints(b)):
            want[i + j] = (want[i + j] + x * y) % R
    assert ints(ntt.poly_mul_ntt(a, b)) == want
    t, jt = both((1,), 400 + log_n)
    same(ntt.vanishing_at(n, t), jntt.vanishing_at(n, jt))
    lag = ntt.all_lagrange_at(n, t)
    same(lag, jntt.all_lagrange_at(n, jt))
    # the Lagrange basis at t interpolates: sum_i l_i(t) = 1
    assert sum(ints(lag)) % R == 1


def test_degree3_round_poly_equals_jax():
    """The CPhad sumcheck's round: beta, a and b stacked, degree 3."""
    t, jt = both((3, 8), 500)
    same(mle.round_poly(t), jmle.round_poly(jt))
    r, jr = both((1,), 501)
    same(mle.round_poly(mle.fold(t, r)), jmle.round_poly(jmle.fold(jt, jr)))
