"""CPpoly - multilinear polynomial commitment (PST13 style), prover side.

Counterpart of `legosnark_tpu/gadgets/poly.py:58-204`:

  keygen(d):  secret s in Fr^d, alpha in Fr.
              level-j G1 bases  B_j[p] = eq(p, s_{j..d-1}) * G   (2^{d-j} pts)
              alpha-shifted     A_j[p] = alpha * eq(p, s_{j..d-1}) * G
              G2 elements       S_j = s_j * G2,  G2a = alpha * G2
  commit(v):  C = <B_0, v>, Ca = <A_0, v>
  prove(v,r): per round i: quotient table q_i = hi - lo,
              W_i = <B_{i+1}, q_i>, Wa_i = <A_{i+1}, q_i>

Variable convention as in `prototools.mle` (big-endian; round i binds
variable i). Tables are [8, 2^d], points [8, d].
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..curve import bn254
from ..curve import msm as msm_mod
from ..curve.group import (G1, G2, Point, g1_generator, g2_generator,
                           point_concat, point_map, point_stack,
                           to_affine_batch)
from ..fields import limb as fl
from ..prototools import mle
from ..utils import rand as lrand

FR = bn254.FR


class PolyKey(NamedTuple):
    bases: Tuple[Point, ...]     # level j in 0..d: [8, 2^(d-j)] G1 points
    bases_a: Tuple[Point, ...]   # alpha-shifted copies
    g2_s: Point                  # [2, 8, d] G2: s_j * G2
    g2_alpha: Point              # alpha * G2
    g1: Point                    # generator
    g2: Point                    # generator


def poly_d(key: PolyKey) -> int:
    return len(key.bases) - 1


class PolyComm(NamedTuple):
    c: Point    # <B_0, v>
    ca: Point   # alpha leg


class PolyPf(NamedTuple):
    witness: Point    # [8, d] G1 (W_i)
    witnessa: Point   # [8, d] G1 (alpha leg)


def keygen(d: int, seed: int = 0, device=None) -> PolyKey:
    """Structured reference string (s and alpha are discarded on
    return). The draws are those of the JAX package for the same seed."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed ^ 0x9057)
    s_ints = lrand.rand_fr_ints(rng, d)
    alpha_int = lrand.rand_fr_int(rng)
    s_mont = fl.tensor(FR.to_mont_ints(s_ints), dev)       # [8, d]
    alpha = fl.tensor(FR.to_mont_ints([alpha_int]), dev)   # [8, 1]

    table = msm_mod.fixed_base_table(G1, g1_generator((), dev), c=8)
    parts = []
    for j in range(d + 1):
        eqt = mle.mk_beta(s_mont[..., j:])                 # [8, 2^(d-j)]
        parts.append(eqt)
        parts.append(fl.mont_mul(FR, eqt, alpha))
    allv = fl.from_mont(FR, torch.cat(parts, dim=-1))
    pts = msm_mod.batch_scalar_mul(G1, table, allv, c=8)
    pts = to_affine_batch(G1, pts)

    bases, bases_a = [], []
    off = 0
    for j in range(d + 1):
        m = 1 << (d - j)
        bases.append(point_map(lambda x, o=off, k=m: x[..., o : o + k], pts))
        off += m
        bases_a.append(point_map(lambda x, o=off, k=m: x[..., o : o + k], pts))
        off += m

    g2t = msm_mod.fixed_base_table(G2, g2_generator((), dev), c=8)
    sa = torch.cat([fl.from_mont(FR, s_mont), fl.from_mont(FR, alpha)], dim=-1)
    g2_pts = msm_mod.batch_scalar_mul(G2, g2t, sa, c=8)
    g2_s = point_map(lambda x: x[..., :d], g2_pts)
    g2_alpha = point_map(lambda x: x[..., d : d + 1], g2_pts)
    return PolyKey(tuple(bases), tuple(bases_a), g2_s, g2_alpha,
                   g1_generator((), dev), g2_generator((), dev))


def _pair_msm(bases: Point, bases_a: Point, scalars_can):
    """The two legs <bases, v> and <bases_a, v> over shared scalars, run
    as one MSM over the stacked bases."""
    out = msm_mod.msm(G1, point_stack([bases, bases_a]), scalars_can)
    return point_map(lambda a: a[0], out), point_map(lambda a: a[1], out)


def commit(key: PolyKey, v_mont) -> PolyComm:
    """Commit to the 2^d evaluation table."""
    return PolyComm(*_pair_msm(key.bases[0], key.bases_a[0],
                               fl.from_mont(FR, v_mont)))


def compute_answer(key: PolyKey, v_mont, r_mont):
    """ans = v~(r) and its commitment ans*G."""
    ans = mle.eval_mle(v_mont, r_mont)
    return ans, G1.scalar_mul(key.g1, fl.from_mont(FR, ans))


def prove(key: PolyKey, v_mont, r_mont) -> PolyPf:
    """d quotient witnesses by successive folding."""
    ws, was = [], []
    v = v_mont
    for i in range(poly_d(key)):
        half = v.shape[-1] // 2
        q_can = fl.from_mont(FR, fl.sub(FR, v[..., half:], v[..., :half]))
        w, wa = _pair_msm(key.bases[i + 1], key.bases_a[i + 1], q_can)
        ws.append(w)
        was.append(wa)
        v = mle.fold(v, r_mont[..., i : i + 1])
    return PolyPf(point_concat(ws), point_concat(was))
