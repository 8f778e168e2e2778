"""The port's CPhadL (legosnark_tpu_torch.gadgets.lipmaa) at n = 8.

Fast tier: keygen, the commitments and pi against tests/oracle.py's
affine arithmetic on host-computed scalars, for the trapdoors chi and
gamma drawn from keygen's seed; verify true, and false for a proof of
c != a o b; the commitments' G2 legs well formed. Slow tier: keygen,
commit and prove equal to the JAX package's, element for element.
"""
import numpy as np
import pytest
import torch

import oracle

from legosnark_tpu_torch import convert
from legosnark_tpu_torch.curve import bn254
from legosnark_tpu_torch.curve import pairing as pr
from legosnark_tpu_torch.curve.group import point_map
from legosnark_tpu_torch.fields import limb as fl
from legosnark_tpu_torch.gadgets import lipmaa
from legosnark_tpu_torch.utils import rand as lrand

# The plain path runs many small torch ops; idle intra-op threads spin and
# starve the other test processes, so the port's tests use one thread.
torch.set_num_threads(1)

R = bn254.R
FR = bn254.FR
N = 8
SEED = 9


def mont(ints):
    return fl.tensor(FR.to_mont_ints(ints), "cpu")


def trapdoor_scalars(n, seed):
    """chi, gamma as keygen draws them; Z(chi) and every l_i(chi)."""
    rng = np.random.default_rng(seed ^ 0x11BA)
    chi, gamma = lrand.rand_fr_int(rng), lrand.rand_fr_int(rng)
    w = bn254.fr_two_adic_root(n.bit_length() - 1)
    z = (pow(chi, n, R) - 1) % R
    lag = [z * pow(w, i, R) * pow(n * (chi - pow(w, i, R)), -1, R) % R
           for i in range(n)]
    return chi, gamma, z, lag


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(31)
    a = lrand.rand_fr_ints(rng, N)
    b = lrand.rand_fr_ints(rng, N)
    c = [x * y % R for x, y in zip(a, b)]
    ds = lrand.rand_fr_ints(rng, 3)
    key = lipmaa.keygen(N, SEED, "cpu")
    # the three commitments as rows of one call ([3, ..] batches)
    both = lipmaa.commit(key.interp, torch.stack([mont(v) for v in (a, b, c)]),
                         torch.stack([mont([r]) for r in ds]))
    comms = [lipmaa.InterpComm(*(point_map(lambda x, i=i: x[i], p)
                                 for p in both)) for i in range(3)]
    pi = lipmaa.prove(key, mont(a), mont(b), mont(c), mont(ds))
    return {"vals": (a, b, c), "ds": ds, "key": key, "comms": comms,
            "pi": pi}


def test_keygen_equals_oracle(run):
    key = run["key"]
    chi, gamma, z, lag = trapdoor_scalars(N, SEED)
    ik = key.interp
    assert convert.to_ints(ik.lag_g1) == [oracle.g1_mul(oracle.G1, x)
                                          for x in lag]
    assert convert.to_ints(ik.lag_kg2, g2=True) == \
        [oracle.g2_mul(oracle.G2, gamma * x) for x in lag]
    assert convert.to_ints(ik.z_g1) == [oracle.g1_mul(oracle.G1, z)]
    assert convert.to_ints(ik.z_kg2, g2=True) == \
        [oracle.g2_mul(oracle.G2, gamma * z)]
    assert convert.to_ints(key.chi_pows) == \
        [oracle.g1_mul(oracle.G1, pow(chi, i, R)) for i in range(N + 1)]


def test_commit_and_prove_equal_oracle(run):
    """c = s G1 and kc = gamma s G2 for s = sum_i v_i l_i(chi) + r Z(chi);
    pi = H(chi) G1 with H(chi) = (s_a s_b - s_c) / Z(chi)."""
    _, gamma, z, lag = trapdoor_scalars(N, SEED)
    s = [(sum(v * x for v, x in zip(vals, lag)) + r * z) % R
         for vals, r in zip(run["vals"], run["ds"])]
    for cm, sv in zip(run["comms"], s):
        assert convert.to_ints(cm.c) == [oracle.g1_mul(oracle.G1, sv)]
        assert convert.to_ints(cm.kc, g2=True) == \
            [oracle.g2_mul(oracle.G2, gamma * sv)]
    h = (s[0] * s[1] - s[2]) * pow(z, -1, R) % R
    assert convert.to_ints(run["pi"]) == [oracle.g1_mul(oracle.G1, h)]


def test_verify_and_commitment_checks(run):
    key, (ca, cb, cc) = run["key"], run["comms"]
    assert bool(lipmaa.verify(key, ca, cb, cc, run["pi"]))
    # well-formedness of every commitment, and of none with a foreign kc
    mixed = lipmaa.InterpComm(ca.c, cb.kc)
    groups = [g for cm in (ca, cb, cc, mixed)
              for g in lipmaa.commit_pairings(key.interp, cm)]
    assert pr.pairing_checks(groups).tolist() == [True, True, True, False]


def test_proof_of_a_wrong_product_fails(run):
    key, (ca, cb, _) = run["key"], run["comms"]
    a, b, c = run["vals"]
    c_bad = [(c[0] + 1) % R] + c[1:]
    ds = run["ds"]
    cc_bad = lipmaa.commit(key.interp, mont(c_bad), mont(ds[2:]))
    pi_bad = lipmaa.prove(key, mont(a), mont(b), mont(c_bad), mont(ds))
    assert not bool(lipmaa.verify(key, ca, cb, cc_bad, pi_bad))
    # and the honest pi does not verify against the wrong c's commitment
    assert not bool(lipmaa.verify(key, ca, cb, cc_bad, run["pi"]))


@pytest.mark.slow
def test_keygen_commit_prove_equal_jax(run):
    """The JAX package's keygen, commitments and pi for the same seed and
    inputs, element for element; the port's commit and prove also run on
    the JAX key carried over by `convert`."""
    import jax.numpy as jnp
    from legosnark_tpu.curve import bn254 as jbn
    from legosnark_tpu.curve.group import (g1_to_oracle_batch,
                                           g2_to_oracle_batch)
    from legosnark_tpu.gadgets import lipmaa as jlip

    def jm(ints):
        return jnp.asarray(jbn.FR.to_mont_ints(ints))

    jkey = jlip.keygen(N, seed=SEED)
    key, jik, ik = run["key"], jkey.interp, run["key"].interp
    assert convert.to_ints(key.chi_pows) == g1_to_oracle_batch(jkey.chi_pows)
    assert convert.to_ints(ik.lag_g1) == g1_to_oracle_batch(jik.lag_g1)
    assert convert.to_ints(ik.z_g1) == g1_to_oracle_batch(jik.z_g1)
    assert convert.to_ints(ik.lag_kg2, g2=True) == \
        g2_to_oracle_batch(jik.lag_kg2)
    assert convert.to_ints(ik.z_kg2, g2=True) == g2_to_oracle_batch(jik.z_kg2)

    tkey = convert.hadlkey_from_jax(jkey, "cpu")
    ds, vals = run["ds"], run["vals"]
    for v, r, mine in zip(vals, ds, run["comms"]):
        jc = jlip.commit(jik, jm(v), jm([r]))
        got = lipmaa.commit(tkey.interp, mont(v), mont([r]))
        for cm in (got, mine):
            assert convert.to_ints(cm.c) == g1_to_oracle_batch(jc.c)
            assert convert.to_ints(cm.kc, g2=True) == \
                g2_to_oracle_batch(jc.kc)
    jpi = jlip.prove(jkey, *(jm(v) for v in vals), jm(ds))
    got = lipmaa.prove(tkey, *(mont(v) for v in vals), mont(ds))
    assert convert.to_ints(got) == convert.to_ints(run["pi"]) == \
        g1_to_oracle_batch(jpi)
