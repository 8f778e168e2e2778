"""The probes' plain versions (P1a, P1b, P2) against Python ints and K1's
plain version, bit for bit, at n = 256 on random and edge inputs.

These plain versions are what the card's kernels are held to, so a wrong
8-bit digit split, Toeplitz matrix or carry pass shows here first.
"""
import numpy as np
import pytest
import torch

from legosnark_tpu_torch import kernels
from legosnark_tpu_torch.curve import bn254
from legosnark_tpu_torch.fields import cuda_limb
from legosnark_tpu_torch.fields import limb as fl
from legosnark_tpu_torch.probes import mont_variants as mv
from legosnark_tpu_torch.utils.bench import edge_ints

# The plain path runs many small torch ops; idle intra-op threads spin and
# starve the other test processes, so the port's tests use one thread.
torch.set_num_threads(1)

N = 256


def _ints(rng, n, bound):
    return [int.from_bytes(rng.bytes(40), "little") % bound for _ in range(n)]


@pytest.mark.parametrize("spec", [bn254.FR, bn254.FQ], ids=["Fr", "Fq"])
def test_mont_products_equal_k1_and_ints(spec):
    rng = np.random.default_rng(31)
    p = spec.p
    xs = edge_ints(p) + _ints(rng, N - 7, 2 * p)
    ys = edge_ints(p)[::-1] + _ints(rng, N - 7, 2 * p)
    a = fl.tensor(fl.ints_to_limbs(xs), "cpu")
    b = fl.tensor(fl.ints_to_limbs(ys), "cpu")
    k1 = cuda_limb.mont_mul_plain(spec, a, b)
    kernels.reset_launches()
    tc = mv.mont_mul_tc(spec, a, b)           # CPU tensors: plain version
    sos = mv.mont_mul_sos(spec, a, b)
    assert sum(kernels.launches.values()) == 0
    assert torch.equal(tc, mv.mont_mul_tc_plain(spec, a, b))
    assert torch.equal(tc, k1) and torch.equal(sos, k1)
    rinv = pow(spec.R, -1, p)
    for i, v in enumerate(fl.limbs_to_ints(tc)):
        # (ab + Mp)/R with M in [0, R): the exact integer, below 2p
        m = (-xs[i] * ys[i] * pow(p, -1, spec.R)) % spec.R
        assert v == (xs[i] * ys[i] + m * p) // spec.R
        assert v % p == xs[i] * ys[i] * rinv % p and v < 2 * p


def test_toeplitz_tables():
    for spec in (bn254.FR, bn254.FQ):
        T = mv.toeplitz_bytes(spec.p).astype(np.int64)
        ninv = spec.ninv.to_bytes(32, "little")
        pb = spec.p.to_bytes(32, "little")
        assert T.shape == (96, 32)
        assert T[0, 0] == ninv[0] and T[31, 0] == ninv[31] and T[0, 1] == 0
        assert T[32, 0] == pb[0] and T[94, 31] == pb[31] and T[32, 1] == 0
        assert not T[95].any()                  # column 63 of m*p is 0
        # the columns of N @ digits and P @ digits are exact in int32
        assert 32 * 255 * 255 < 2**31


@pytest.mark.parametrize("variant", mv.VARIANTS)
def test_limb_product_plain(variant):
    rng = np.random.default_rng(32)
    full = (1 << 256) - 1
    xs = [0, full, full, 1] + _ints(rng, N - 4, 1 << 256)
    ys = [full, full, 1, 0] + _ints(rng, N - 4, 1 << 256)
    a = fl.tensor(fl.ints_to_limbs(xs), "cpu")
    b = fl.tensor(fl.ints_to_limbs(ys), "cpu")
    out = mv.limb_product(a, b, variant)
    assert out.shape == (16, N) and out.dtype == torch.int32
    assert torch.equal(out, mv.limb_product_plain(a, b, variant))
    lo, hi = fl.limbs_to_ints(out[:8]), fl.limbs_to_ints(out[8:])
    for i in range(N):
        if variant == "floor":
            prods = [((xs[i] >> 32 * k) & fl.MASK) * ((ys[i] >> 32 * k)
                     & fl.MASK) for k in range(8)]
            assert lo[i] == sum((v & fl.MASK) << 32 * k
                                for k, v in enumerate(prods))
            assert hi[i] == sum((v >> 32) << 32 * k
                                for k, v in enumerate(prods))
        else:
            assert lo[i] + (hi[i] << 256) == xs[i] * ys[i]
    with pytest.raises(ValueError):
        mv.limb_product(a, b, "roll")
