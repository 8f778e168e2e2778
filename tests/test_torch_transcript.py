"""The port's Fiat-Shamir transcript against the JAX package's.

Fr-only transcripts are field operations over the same constants, so the
same seeded Fr elements give the same permutation outputs and challenges
in both packages, compared exactly as canonical integers. Points are
absorbed in the port's own encoding (affine x mod r, y mod r; identity
(0, 0)), so their challenges are checked for determinism, independence
of the projective representative, and sensitivity to any change.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from legosnark_tpu.curve import bn254 as jbn
from legosnark_tpu.utils import transcript as jtr

from legosnark_tpu_torch import convert
from legosnark_tpu_torch.curve import bn254
from legosnark_tpu_torch.curve.group import (G1, Point, g1_generator,
                                             g1_to_ints)
from legosnark_tpu_torch.fields import limb as fl
from legosnark_tpu_torch.utils import transcript as ttr

# The plain path runs many small torch ops; idle intra-op threads spin and
# starve the other test processes, so the port's tests use one thread.
torch.set_num_threads(1)

R = bn254.R


def seeded_fr(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % R for _ in range(n)]


def jax_ints(x):
    return [int(v) for v in convert.jax_field_ints(np.asarray(x), bn254.FR)]


def port_ints(x):
    return [int(v) for v in convert.to_ints(x).reshape(-1)]


def test_permute_equals_jax():
    ints = seeded_fr(5, 8)
    got = ttr.permute(fl.tensor(bn254.FR.to_mont_ints(ints), "cpu"))
    want = jtr.permute(jnp.asarray(jbn.FR.to_mont_ints(ints)))
    assert port_ints(got) == jax_ints(want)


@pytest.mark.parametrize("width", [1, 5, 8])
def test_fr_challenges_equal_jax(width):
    ints = seeded_fr(6, width)
    jt = jtr.Transcript(label=7)
    jt.absorb_fr(jnp.asarray(jbn.FR.to_mont_ints(ints)))
    tt = ttr.Transcript(label=7, device="cpu")
    tt.absorb_fr(fl.tensor(bn254.FR.to_mont_ints(ints), "cpu"))
    assert port_ints(tt.challenges(4)) == jax_ints(jt.challenges(4))


def _points():
    """[G, identity, 5G] as a projective batch."""
    k = fl.tensor(fl.ints_to_limbs([1, 0, 5]), "cpu")
    return G1.scalar_mul(g1_generator((), "cpu"), k)


def _challenges(p, n=3):
    t = ttr.Transcript(label=9, device="cpu")
    t.absorb_point(p)
    return port_ints(t.challenges(n))


def test_point_encoding_is_affine_mod_r():
    """absorb_point == absorb_fr of (x mod r..., y mod r...) from host
    ints, the identity as (0, 0); a rescaled projective representative
    gives the same challenges."""
    p = _points()
    aff = g1_to_ints(p)
    assert aff[1] is None
    xs = [0 if a is None else a[0] % R for a in aff]
    ys = [0 if a is None else a[1] % R for a in aff]
    t = ttr.Transcript(label=9, device="cpu")
    t.absorb_fr(fl.tensor(bn254.FR.to_mont_ints(xs + ys), "cpu"))
    want = port_ints(t.challenges(3))
    assert _challenges(p) == want
    lam = G1.F.const(123456789, "cpu")
    scaled = Point(*(G1.F.mul(c, lam) for c in p))
    assert _challenges(scaled) == want


def test_tampered_point_changes_every_later_challenge():
    """Mirrors tests/test_transcript_fs.py:28 for the point encoding."""
    p = _points()
    base = _challenges(p)
    assert _challenges(p) == base                    # deterministic
    assert len(set(base)) == 3                       # squeezes chain
    t = ttr.Transcript(label=10, device="cpu")
    t.absorb_point(p)
    assert all(a != b for a, b in zip(port_ints(t.challenges(3)), base))
    bad = Point(*(torch.cat([c[..., :2], d[..., 2:]], dim=-1)
                  for c, d in zip(p, G1.double(p))))  # 5G -> 10G
    assert all(a != b for a, b in zip(_challenges(bad), base))
    swapped = Point(*(c.flip(-1) for c in p))         # order matters
    assert all(a != b for a, b in zip(_challenges(swapped), base))
