"""Port field arithmetic (legosnark_tpu_torch.fields) against the JAX
package and Python bigints, exact on canonical integers.

The same numpy-seeded integers go to both packages; each side's output is
read back as canonical integers (the limb layouts differ: 8 x 32-bit with
R = 2^256 here, 20 x 13-bit with R = 2^260 there).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from legosnark_tpu.curve import bn254 as jbn
from legosnark_tpu.fields import limb as jfl
from legosnark_tpu.fields import pallas_limb

from legosnark_tpu_torch import convert
from legosnark_tpu_torch.curve import bn254
from legosnark_tpu_torch.fields import cuda_limb
from legosnark_tpu_torch.fields import limb as fl

# The plain path runs many small torch ops; idle intra-op threads spin and
# starve the other test processes, so the port's tests use one thread.
torch.set_num_threads(1)

SPECS = [(bn254.FR, jbn.FR), (bn254.FQ, jbn.FQ)]
IDS = ["Fr", "Fq"]


def rand_ints(rng, p, n):
    return [int.from_bytes(rng.bytes(40), "little") % p for _ in range(n)]


def port_raw(xs):
    """Raw limbs (any representative below 2^256) as a CPU tensor."""
    return fl.tensor(fl.ints_to_limbs(xs), "cpu")


def port_vals(spec, t):
    """Canonical values of port Montgomery limbs."""
    return [int(v) for v in convert.to_ints(t, spec).reshape(-1)]


def jax_vals(jspec, a):
    return [jspec.from_mont_limbs(np.asarray(a)[..., :, i])
            for i in range(np.asarray(a).shape[-1])]


def operands(spec, seed):
    """Montgomery representatives on the port side: random values, the
    edges 0, p-1, p, 2p-1 and all-ones limb runs (2^224-1, 2^192-1,
    2^256-1-(2^32-1)*2^224 style chains below 2p)."""
    p = spec.p
    rng = np.random.default_rng(seed)
    edge_a = [0, 1, p - 1, p, 2 * p - 1, (1 << 224) - 1, (1 << 192) - 1,
              2 * p - 1, 0]
    edge_b = [2 * p - 1, p - 1, 2 * p - 1, 1, 2 * p - 1, (1 << 224) - 1,
              p, 0, 0]
    xs = rand_ints(rng, 2 * p, 24) + edge_a
    ys = rand_ints(rng, 2 * p, 24) + edge_b
    return xs, ys


@pytest.mark.parametrize("spec,jspec", SPECS, ids=IDS)
def test_ops_match_jax_and_ints(spec, jspec):
    p = spec.p
    rinv = pow(spec.R, -1, p)
    xs, ys = operands(spec, 11)
    a, b = port_raw(xs), port_raw(ys)
    # the canonical values the port's representatives stand for
    va = [x * rinv % p for x in xs]
    vb = [y * rinv % p for y in ys]
    ja = jnp.asarray(jspec.to_mont_ints(va))
    jb = jnp.asarray(jspec.to_mont_ints(vb))

    cases = {
        "mont_mul": (fl.mont_mul(spec, a, b), jfl.mont_mul(jspec, ja, jb),
                     [x * y % p for x, y in zip(va, vb)]),
        "add": (fl.add(spec, a, b), jfl.add(jspec, ja, jb),
                [(x + y) % p for x, y in zip(va, vb)]),
        "sub": (fl.sub(spec, a, b), jfl.sub(jspec, ja, jb),
                [(x - y) % p for x, y in zip(va, vb)]),
        "neg": (fl.neg(spec, b), jfl.neg(jspec, jb), [(-y) % p for y in vb]),
    }
    for name, (got, jgot, want) in cases.items():
        assert port_vals(spec, got) == want, name
        assert jax_vals(jspec, jgot) == want, name
        raw = fl.limbs_to_ints(got)
        assert all(int(v) < 2 * p for v in raw), f"{name} stays below 2p"

    # from_mont gives canonical standard form
    std = [int(v) for v in fl.limbs_to_ints(fl.from_mont(spec, a))]
    jstd = jfl.limbs_to_ints(np.asarray(jfl.from_mont(jspec, ja)))
    assert std == va == [int(v) for v in jstd]
    # canon maps every value below 4p to its residue
    wide = [x + y for x, y in zip(xs, ys)]
    assert [int(v) for v in fl.limbs_to_ints(fl.canon(spec, port_raw(wide)))] \
        == [w % p for w in wide]


@pytest.mark.parametrize("spec,jspec", SPECS, ids=IDS)
def test_inv_and_pow(spec, jspec):
    p = spec.p
    rng = np.random.default_rng(5)
    xs = rand_ints(rng, p, 4) + [1, p - 1, 0]
    a = fl.tensor(spec.to_mont_ints(xs), "cpu")
    got = port_vals(spec, fl.inv(spec, a))
    assert got == [pow(x, -1, p) if x else 0 for x in xs]
    jgot = jax_vals(jspec, jfl.inv(jspec, jnp.asarray(jspec.to_mont_ints(xs))))
    assert jgot == got
    for e in (0, 1, 2, 5, 1 << 20):
        assert port_vals(spec, fl.mont_pow(spec, a, e)) == \
            [pow(x, e, p) for x in xs]


def test_get_window_straddles_limbs():
    rng = np.random.default_rng(3)
    xs = rand_ints(rng, bn254.R, 6) + [bn254.R - 1, (1 << 253) - 1]
    a = port_raw(xs)
    ja = jnp.asarray(jfl.ints_to_limbs(xs, jbn.FR.nlimbs))
    for start, width in [(0, 17), (17, 17), (221, 17), (238, 17), (30, 5),
                         (31, 2), (64, 31), (250, 8), (256, 4), (252, 17)]:
        got = fl.get_window(bn254.FR, a, start, width).tolist()
        assert got == [(x >> start) & ((1 << width) - 1) for x in xs]
        if width <= 19 and start < 260:
            jw = np.asarray(jfl.get_window(jbn.FR, ja, start, width))
            assert got == [int(v) for v in jw], (start, width)


def test_k1_plain_matches_pallas_interpret():
    """K1's plain version against the Pallas kernel run in interpret mode,
    at a width that is not a multiple of 128 and with a leading batch."""
    rng = np.random.default_rng(91)
    for spec, jspec, shape in ((bn254.FR, jbn.FR, (136,)),
                               (bn254.FQ, jbn.FQ, (2, 4))):
        n = int(np.prod(shape))
        xs = rand_ints(rng, spec.p, n)
        ys = rand_ints(rng, spec.p, n)

        def lead(arr, L):
            arr = np.asarray(arr).reshape(L, *shape)       # [L, ..., V]
            return np.moveaxis(arr, 0, -2) if len(shape) > 1 else arr

        a = fl.tensor(lead(spec.to_mont_ints(xs), 8), "cpu")
        b = fl.tensor(lead(spec.to_mont_ints(ys), 8), "cpu")
        got = cuda_limb.mont_mul_plain(spec, a, b)
        jgot = pallas_limb.mont_mul(
            jspec, jnp.asarray(lead(jspec.to_mont_ints(xs), 20)),
            jnp.asarray(lead(jspec.to_mont_ints(ys), 20)))
        want = [x * y % spec.p for x, y in zip(xs, ys)]
        assert list(convert.to_ints(got, spec).reshape(-1)) == want
        assert list(convert.jax_field_ints(np.asarray(jgot), spec)
                    .reshape(-1)) == want


def test_plain_mont_mul_is_the_cios_value():
    """The plain version returns exactly (a*b + M*p)/R with M in [0, R) —
    the value the CUDA kernel's CIOS loop computes — below 2p."""
    for spec in (bn254.FR, bn254.FQ):
        p, R = spec.p, spec.R
        xs, ys = operands(spec, 23)
        got = fl.limbs_to_ints(cuda_limb.mont_mul_plain(
            spec, port_raw(xs), port_raw(ys)))
        for x, y, g in zip(xs, ys, got):
            m = (-x * y * pow(p, -1, R)) % R
            assert int(g) == (x * y + m * p) // R < 2 * p


def test_convert_loose_limbs_round_trip():
    """JAX Montgomery arrays with loose 13-bit limbs (limb k carrying
    2^13 borrowed from limb k+1) and values up to 3.6p convert exactly."""
    rng = np.random.default_rng(8)
    for spec in (bn254.FR, bn254.FQ):
        p = spec.p
        vals = rand_ints(rng, 3 * p + p // 2, 12) + [0, p, 2 * p + 5]
        limbs = np.asarray(jfl.ints_to_limbs(vals, 20)).astype(np.int64)
        for i in range(limbs.shape[1]):
            for k in range(i % 5, 19, 3):
                if limbs[k + 1, i] > 0:
                    limbs[k + 1, i] -= 1
                    limbs[k, i] += 1 << 13
        assert limbs.max() >= 1 << 13
        jr = pow(1 << 260, -1, p)
        want = [v * jr % p for v in vals]
        assert list(convert.jax_field_ints(limbs.astype(np.uint32), spec)) \
            == want
        port = convert.field_from_jax(limbs.astype(np.uint32), spec)
        assert list(convert.to_ints(torch.from_numpy(port), spec)) == want
        # and with a leading batch axis
        lead = np.stack([limbs, limbs]).astype(np.uint32)
        port2 = convert.field_from_jax(lead, spec)
        assert port2.shape == (2, 8, len(vals))
        assert [list(r) for r in convert.to_ints(torch.from_numpy(port2),
                                                 spec)] == [want, want]
