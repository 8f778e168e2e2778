"""Pedersen vector commitments with a knowledge leg.

Counterpart of `legosnark_tpu/prototools/commit.py`: a commitment to a
vector v with randomness r is the pair
  c  = <g1s, v> + r h    in G1,
  kc = <g2s, v> + r h2   in G2 (the knowledge leg),
with g1s[i] = s_i G1, g2s[i] = s_i G2, h = s_n G1 and h2 = s_n G2 for
scalars s drawn from the key's seed, so that e(c, g2s[0]) ==
e(g1s[0], kc) holds for every honest commitment (`check_knowledge`).
`keygen(..., benchmark_compat=True)` gives the all-generator key of the
C++ reference's benchmarks.

The blinding r rides as one more column of each MSM (bases ‖ h with
scalars v ‖ r): the same points as the JAX package's MSM plus r h, with
no separate scalar multiplication. Leading axes of the bases and of v
broadcast, so several commitments, also under several keys, run as rows
of one G1 and one G2 MSM.

Layout: Fr vectors [.., 8, m] Montgomery; G1 bases [.., 8, n], G2 bases
[.., 2, 8, n].
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..config import resolve_device
from ..curve import bn254
from ..curve import msm as msm_mod
from ..curve import pairing as pr
from ..curve.group import (FR_OPS, G1, G2, Point, g1_generator, g2_generator,
                           point_concat, point_map)
from ..fields import limb as fl
from ..utils import rand as lrand

FR = bn254.FR


def _cols(p: Point, lo: int, hi: int) -> Point:
    return point_map(lambda x: x[..., lo:hi], p)


class Comm(NamedTuple):
    """A commitment and its knowledge leg."""

    c: Point   # G1
    kc: Point  # G2

    def __add__(self, other: "Comm") -> "Comm":
        return Comm(G1.add(self.c, other.c), G2.add(self.kc, other.kc))

    def __sub__(self, other: "Comm") -> "Comm":
        return Comm(G1.add(self.c, G1.neg(other.c)),
                    G2.add(self.kc, G2.neg(other.kc)))

    def scale(self, b_canonical) -> "Comm":
        """b Comm for a canonical Fr scalar [8, 1]."""
        return Comm(G1.scalar_mul(self.c, b_canonical),
                    G2.scalar_mul(self.kc, b_canonical))


class CommOut(NamedTuple):
    """A commitment with its opening: randomness and message."""

    c: Comm
    r: Any   # Fr Montgomery [8, 1]
    xs: Any  # Fr Montgomery [8, m]

    def __add__(self, other: "CommOut") -> "CommOut":
        return CommOut(self.c + other.c, FR_OPS.add(self.r, other.r),
                       FR_OPS.add(self.xs, other.xs))

    def __sub__(self, other: "CommOut") -> "CommOut":
        return CommOut(self.c - other.c, FR_OPS.sub(self.r, other.r),
                       FR_OPS.sub(self.xs, other.xs))


class CommitmentKey(NamedTuple):
    g1s: Point  # [.., 8, n] G1 bases
    g2s: Point  # [.., 2, 8, n] G2 bases, the same scalars
    h: Point    # blinding base in G1
    h2: Point   # h's G2 mirror (the same scalar), so that the knowledge
    #             leg carries r and the pairing check holds for r != 0


def keygen(n: int, seed: int = 0, benchmark_compat: bool = False,
           return_scalars: bool = False, device=None):
    """A key for vectors of up to n entries. The n + 1 scalars (bases,
    then blinding) are the JAX package's draws for the same seed; every
    G1 point comes from one fixed-base batch multiplication, every G2
    point from another. return_scalars=True also returns the canonical
    scalars [8, n + 1], for relations over these bases that take the
    scalar keygen of `gadgets.subspace`."""
    dev = resolve_device(device)
    if benchmark_compat:
        ck = CommitmentKey(g1_generator((n,), dev), g2_generator((n,), dev),
                           g1_generator((), dev), g2_generator((), dev))
        if return_scalars:
            return ck, fl.tensor(fl.ints_to_limbs([1] * (n + 1)), dev)
        return ck
    rng = np.random.default_rng(seed ^ 0x1E605)
    scal = lrand.rand_fr_canonical(rng, n + 1, dev)
    g1s = msm_mod.batch_scalar_mul(G1, msm_mod.generator_table(G1, dev),
                                   scal, c=8)
    g2s = msm_mod.batch_scalar_mul(G2, msm_mod.generator_table(G2, dev),
                                   scal, c=8)
    ck = CommitmentKey(_cols(g1s, 0, n), _cols(g2s, 0, n),
                       _cols(g1s, n, n + 1), _cols(g2s, n, n + 1))
    return (ck, scal) if return_scalars else ck


def commit(ck: CommitmentKey, v_mont, r_mont=None) -> CommOut:
    """Commit to v [.., 8, m] (Montgomery), m <= n, with randomness
    r [.., 8, 1], or r = 0 when r_mont is None (the C++ reference's
    behaviour). Leading axes of the key and of v and r broadcast: every
    row is one commitment, all in one G1 and one G2 MSM."""
    m = v_mont.shape[-1]
    g1s, g2s = _cols(ck.g1s, 0, m), _cols(ck.g2s, 0, m)
    s = v_mont
    if r_mont is None:
        r_mont = fl.zero(FR, (1,), v_mont.device)
    else:
        g1s, g2s = point_concat([g1s, ck.h]), point_concat([g2s, ck.h2])
        lead = tuple(np.broadcast_shapes(tuple(v_mont.shape[:-2]),
                                         tuple(r_mont.shape[:-2])))
        s = torch.cat([v_mont.expand(lead + v_mont.shape[-2:]),
                       r_mont.expand(lead + r_mont.shape[-2:])], dim=-1)
    s = fl.from_mont(FR, s)
    return CommOut(Comm(msm_mod.msm(G1, g1s, s), msm_mod.msm(G2, g2s, s)),
                   r_mont, v_mont)


def commit_scalar(ck: CommitmentKey, v_mont) -> CommOut:
    """c = v g1s[0], kc = v g2s[0] for one Fr element v [8, 1]."""
    first = Comm(_cols(ck.g1s, 0, 1), _cols(ck.g2s, 0, 1))
    return CommOut(first.scale(fl.from_mont(FR, v_mont)),
                   fl.zero(FR, (1,), v_mont.device), v_mont)


def knowledge_pairings(ck: CommitmentKey, cm: Comm) -> list:
    """e(c, g2s[0]) == e(g1s[0], kc) as one group of pairs for
    `pairing_checks`: e(c, g2s[0]) e(-g1s[0], kc) == 1."""
    return [(point_concat([cm.c, G1.neg(_cols(ck.g1s, 0, 1))]),
             point_concat([_cols(ck.g2s, 0, 1), cm.kc]))]


def check_knowledge(ck: CommitmentKey, cm: Comm):
    """The knowledge leg's well-formedness -> bool []."""
    return pr.pairing_checks(knowledge_pairings(ck, cm)).all()
