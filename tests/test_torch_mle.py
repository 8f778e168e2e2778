"""Port MLE pieces (legosnark_tpu_torch.prototools.mle) and the sampler
against the JAX package at n = 8, exact on canonical integers."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from legosnark_tpu.curve import bn254 as jbn
from legosnark_tpu.fields import limb as jfl
from legosnark_tpu.prototools import mle as jmle
from legosnark_tpu.utils import rand as jrand

from legosnark_tpu_torch import convert
from legosnark_tpu_torch.curve import bn254
from legosnark_tpu_torch.fields import limb as fl
from legosnark_tpu_torch.gadgets import matrix as tmat
from legosnark_tpu_torch.prototools import mle, polytools
from legosnark_tpu_torch.utils import rand as trand

# The plain path runs many small torch ops; idle intra-op threads spin and
# starve the other test processes, so the port's tests use one thread.
torch.set_num_threads(1)

N = 8
D = 3


def both(ints_shape, seed):
    """Uniform Fr ints -> (port tensor, JAX array), Montgomery, [.., 8|20, m]."""
    rng = np.random.default_rng(seed)
    flat = [int.from_bytes(rng.bytes(40), "little") % bn254.R
            for _ in range(int(np.prod(ints_shape)))]
    lead, m = ints_shape[:-1], ints_shape[-1]

    def shape(arr, L):
        arr = np.asarray(arr).reshape((L,) + tuple(lead) + (m,))
        return np.moveaxis(arr, 0, -2)
    return (fl.tensor(shape(bn254.FR.to_mont_ints(flat), 8), "cpu"),
            jnp.asarray(shape(jbn.FR.to_mont_ints(flat), 20)))


def same(t, j):
    got = convert.to_ints(t)
    want = convert.jax_field_ints(np.asarray(j), bn254.FR)
    assert got.shape == want.shape
    assert [int(v) for v in got.reshape(-1)] == \
        [int(v) for v in want.reshape(-1)]


def test_fold_eval_beta():
    v, jv = both((4, 1 << D), 1)
    rho, jrho = both((D,), 2)
    same(mle.fold(v, rho[:, :1]), jmle.fold(jv, jrho[:, :1]))
    same(mle.eval_mle(v, rho), jmle.eval_mle(jv, jrho))
    same(mle.mk_beta(rho), jmle.mk_beta(jrho))
    same(mle.field_sum(v), jmle.field_sum(jv))
    same(mle.field_prod(v), jmle.field_prod(jv))
    same(mle.field_sum_leading(v), jmle.field_sum_leading(jv))


def test_matrix_fold_round_poly_matmul():
    A, jA = both((N, N), 3)
    B, jB = both((N, N), 4)
    rho, jrho = both((D,), 5)
    same(mle.matrix_mle_fold(A, mle.mk_beta(rho)),
         jmle.matrix_mle_fold(jA, jmle.mk_beta(jrho)))
    same(mle.matmul_mont(A, B), jmle.matmul_mont(jA, jB))
    same(mle.matmul_mont(A, B, chunk=2), jmle.matmul_mont(jA, jB))
    t, jt = both((2, 1 << D), 6)
    same(mle.round_poly(t), jmle.round_poly(jt))
    x, jx = both((1,), 7)
    c, jc = both((4,), 8)
    same(mle.poly_eval(c, x), jmle.poly_eval(jc, jx))
    same(polytools.eval_at(c, x), jmle.poly_eval(jc, jx))
    same(polytools.powers_of(x, 4)[:, 3:],
         jfl.mont_mul(jbn.FR, jx, jfl.mont_mul(jbn.FR, jx, jx)))
    same(tmat.flatten_matrix(A),
         jnp.moveaxis(jA, 0, -2).reshape(20, N * N))


def test_samplers_draw_what_jax_draws():
    for n in (1, 5, 64):
        got = trand.rand_fr_limbs_fast(np.random.default_rng(n), n)
        want = jrand.rand_fr_limbs_fast(np.random.default_rng(n), n)
        assert [int(v) for v in fl.limbs_to_ints(got)] == \
            [int(v) for v in jfl.limbs_to_ints(want)]
    got = trand.rand_fr_mont(np.random.default_rng(9), 6, "cpu")
    want = jrand.rand_fr_mont(np.random.default_rng(9), 6)
    same(got, want)
    nonces = tmat.make_nonces(4, seed=7, device="cpu")
    from legosnark_tpu.gadgets import matrix as jmat
    jn = jmat.make_nonces(4, seed=7)
    for k in ("eq_k", "prd_b"):
        same(nonces[k], jn[k])
