"""CPpoly - multilinear polynomial commitment (PST13 style).

Counterpart of `legosnark_tpu/gadgets/poly.py:58-204, 309-363`:

  keygen(d):  secret s in Fr^d, alpha in Fr.
              level-j G1 bases  B_j[p] = eq(p, s_{j..d-1}) * G   (2^{d-j} pts)
              alpha-shifted     A_j[p] = alpha * eq(p, s_{j..d-1}) * G
              G2 elements       S_j = s_j * G2,  G2a = alpha * G2
  commit(v):  C = <B_0, v>, Ca = <A_0, v>
  prove(v,r): per round i: quotient table q_i = hi - lo,
              W_i = <B_{i+1}, q_i>, Wa_i = <A_{i+1}, q_i>
  verify:     e(ans*G - C - sum_i r_i W_i, G2) * prod_i e(W_i, S_i) == 1
              (the JAX package's e(ans*G - C, G2) * prod_i e(W_i, S_i -
              r_i*G2) by bilinearity), and for each i on its own
              e(W_i, G2a) == e(Wa_i, G2)
  check_commit: e(C, G2a) == e(Ca, G2)

The verifiers return their pairing equations as groups of pairs
(`commit_pairings`, `verify_pairings`) so that a caller can check the
equations of several openings with one Miller loop and one final
exponentiation (`curve.pairing.pairing_checks`); every equation is still
checked on its own, so no cancellation across equations is possible.

Variable convention as in `prototools.mle` (big-endian; round i binds
variable i). Tables are [8, 2^d], points [8, d].
"""
from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..curve import bn254
from ..curve import msm as msm_mod
from ..curve import pairing as pr
from ..curve.group import (G1, G2, Point, g1_generator, g2_generator,
                           point_concat, point_map, point_stack,
                           to_affine_batch)
from ..fields import limb as fl
from ..prototools import mle
from ..utils import rand as lrand
from ..utils import trace, util

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


def proof_size_group_elements(d: int) -> dict:
    """Proof size of an opening over d variables (`PolyPf::getSize`):
    W_i and its alpha leg per variable."""
    return {"g1": 2 * d, "g2": 0, "fr": 0}


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

    table = msm_mod.generator_table(G1, dev)
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

    g2t = msm_mod.generator_table(G2, dev)
    sa = torch.cat([fl.from_mont(FR, s_mont), fl.from_mont(FR, alpha)], dim=-1)
    g2_pts = msm_mod.batch_scalar_mul(G2, g2t, sa, c=8)
    g2_s = point_map(lambda x: x[..., :d], g2_pts)
    g2_alpha = point_map(lambda x: x[..., d : d + 1], g2_pts)
    return PolyKey(tuple(bases), tuple(bases_a), g2_s, g2_alpha,
                   g1_generator((), dev), g2_generator((), dev))


def _pair_msm(bases: Point, bases_a: Point, scalars_can):
    """The two legs <bases, v> and <bases_a, v> over shared scalars, run
    as one MSM over the stacked bases; scalars [K.., 8, m] give legs
    [K.., 8, 1]."""
    lead = scalars_can.shape[:-2]
    both = point_map(lambda t: t.view(t.shape[:1] + (1,) * len(lead)
                                      + t.shape[1:]),
                     point_stack([bases, bases_a]))
    out = msm_mod.msm(G1, both, scalars_can)
    return point_map(lambda a: a[0], out), point_map(lambda a: a[1], out)


def commit(key: PolyKey, v_mont) -> PolyComm:
    """Commit to the 2^d evaluation table."""
    return PolyComm(*_pair_msm(key.bases[0], key.bases_a[0],
                               fl.from_mont(FR, v_mont)))


def compute_answer(key: PolyKey, v_mont, r_mont):
    """ans = v~(r) and its commitment ans*G."""
    ans = mle.eval_mle(v_mont, r_mont)
    return ans, G1.scalar_mul(key.g1, fl.from_mont(FR, ans))


@trace.spanned("poly.prove")
def prove(key: PolyKey, v_mont, r_mont) -> PolyPf:
    """d quotient witnesses by successive folding. Tables [K.., 8, 2^d]
    and points [K.., 8, d] open K tables at K points with one MSM per
    round, giving witnesses [K.., 8, d] (`unstack` splits them). Each
    call is one span `poly.prove` (`utils/trace`)."""
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


def unstack(pf: PolyPf) -> list:
    """The proofs of a stacked `prove` [K, 8, d], one per table."""
    return [PolyPf(*(point_map(lambda x, i=i: x[i], p) for p in pf))
            for i in range(pf.witness.x.shape[0])]


def srs_path(d: int, seed: int, cache_dir=None) -> Path:
    """The file `keygen_cached` keeps the SRS of (d, seed) in."""
    return Path(cache_dir or util.SRS_CACHE_DIR) / \
        f"pst13_torch_d{d}_s{seed}.npz"


def keygen_cached(d: int, seed: int = 0, cache_dir=None,
                  device=None) -> PolyKey:
    """`keygen` through a disk cache of the SRS (`utils.util`): a second
    call with the same d and seed loads the key instead of rebuilding it.
    The cache lives in `srs_cache/` beside the package unless `cache_dir`
    names another directory; its files carry the port's own names and
    layout, never the JAX package's."""
    dev = resolve_device(device)
    path = srs_path(d, seed, cache_dir)
    if path.exists():
        g = util.load_point_group(path, dev)
        return PolyKey(tuple(g[f"b{j:02d}"] for j in range(d + 1)),
                       tuple(g[f"a{j:02d}"] for j in range(d + 1)),
                       g["g2s"], g["g2a"], g["g1"], g["g2"])
    key = keygen(d, seed, dev)
    group = {"g2s": key.g2_s, "g2a": key.g2_alpha, "g1": key.g1,
             "g2": key.g2}
    for j in range(d + 1):
        group[f"b{j:02d}"] = key.bases[j]
        group[f"a{j:02d}"] = key.bases_a[j]
    util.save_point_group(path, group)
    return key


def commit_pairings(key: PolyKey, cm: PolyComm) -> list:
    """The knowledge equation e(C, G2a) * e(-Ca, G2) == 1 as one group."""
    return [(point_concat([cm.c, G1.neg(cm.ca)]),
             point_concat([key.g2_alpha, key.g2]))]


def verify_pairings(key: PolyKey, cm: PolyComm, ans_commit: Point, r_mont,
                    pf: PolyPf, rw: Point = None) -> list:
    """The opening's pairing equations, as groups of pairs:
      main: e(ans*G - C - sum_i r_i W_i, G2) * prod_i e(W_i, S_i) == 1,
        the JAX package's e(ans*G - C, G2) * prod_i e(W_i, S_i - r_i G2)
        with r_i moved to the G1 side (a batched G1 scalar multiplication
        in place of a G2 one);
      knowledge, one group per i: e(W_i, G2a) * e(-Wa_i, G2) == 1.
    Checking the knowledge equations in one product would allow
    cancellation across i, so each is a group of its own. `rw` is
    sum_i r_i W_i when the caller computed it with other scalar
    multiplications."""
    d = poly_d(key)
    if rw is None:
        rw = G1.sum_reduce(G1.scalar_mul(pf.witness,
                                         fl.from_mont(FR, r_mont)))
    lhs = G1.add(ans_commit, G1.neg(G1.add(cm.c, rw)))
    groups = [(point_concat([lhs, pf.witness]),
               point_concat([key.g2, key.g2_s]))]
    g2p = point_concat([key.g2_alpha, key.g2])
    nwa = G1.neg(pf.witnessa)
    for i in range(d):
        groups.append((point_concat([
            point_map(lambda x, i=i: x[..., i : i + 1], pf.witness),
            point_map(lambda x, i=i: x[..., i : i + 1], nwa)]), g2p))
    return groups


def check_commit(key: PolyKey, cm: PolyComm):
    """Knowledge well-formedness e(C, G2a) == e(Ca, G2) -> bool []."""
    return pr.pairing_checks(commit_pairings(key, cm)).all()


def verify(key: PolyKey, cm: PolyComm, ans_commit: Point, r_mont,
           pf: PolyPf):
    """The opening's main and knowledge equations -> bool []: one Miller
    loop over the 3d + 1 pairs and one final exponentiation of width
    d + 1."""
    return pr.pairing_checks(
        verify_pairings(key, cm, ans_commit, r_mont, pf)).all()
