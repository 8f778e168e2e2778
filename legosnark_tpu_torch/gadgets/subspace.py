"""CPlink - the Kiltz-Wee QA-NIZK subspace argument.

Counterpart of `legosnark_tpu/gadgets/subspace.py`. Proves x = M w for a
public matrix M of G1 points [l, t] and committed x [l]:
  keygen: k in Fr^l and a_hat in Fr from the seed;
          P = M^T k in G1^t, C_i = (k_i a_hat) G2, a = a_hat G2;
  prove:  pi = <P, w>, one G1 MSM of t points;
  verify: prod_i e(x_i, C_i) e(-pi, a) == 1, one product of pairings
          (identity legs count as 1, as the reference skips zeros).

Three keygens, all drawing k and then a_hat from seed ^ 0x5AB5:
  * `keygen(M)`: dense points, identity for a structural zero;
    P = sum_i k_i M[i, :] by scalar multiplications and a tree sum;
  * `keygen_scalar(sM)`: M = sM G1 given as Fr scalars [l, 8, t];
    P_j = (sum_i k_i sM_ij) G1, a field contraction and one fixed-base
    batch multiplication;
  * `keygen_scalar_sparse(sM)`: the same from a column-major sparse sM,
    nnz products per column instead of l.
C and a come from one fixed-base batch multiplication of width l + 1 on
the G2 generator's table, which `curve.msm.generator_table` builds once
per device.

Layout: point batches [l, 8, t] (rows leading), Fr vectors [8, t].
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..curve import bn254
from ..curve import msm as msm_mod
from ..curve import pairing as pr
from ..curve.group import (G1, G2, Point, point_concat, point_map,
                           point_stack)
from ..fields import limb as fl
from ..prototools import mle
from ..utils import rand as lrand
from ..utils import sparse as sp

FR = bn254.FR


class SubspaceKey(NamedTuple):
    P: Point   # [8, t] G1
    C: Point   # [2, 8, l] G2
    a: Point   # [2, 8, 1] G2


def proof_size_group_elements() -> dict:
    """The proof is one G1 element."""
    return {"g1": 1, "g2": 0, "fr": 0}


def _trapdoor(l: int, seed: int):
    rng = np.random.default_rng(seed ^ 0x5AB5)
    k = lrand.rand_fr_ints(rng, l)
    return k, lrand.rand_fr_int(rng)


def _g2_part(k_ints, a_hat: int, device):
    """(C, a): (k_i a_hat) G2 and a_hat G2 in one batch multiplication."""
    s = [x * a_hat % bn254.R for x in k_ints] + [a_hat]
    pts = msm_mod.batch_scalar_mul(G2, msm_mod.generator_table(G2, device),
                                   fl.tensor(fl.ints_to_limbs(s), device), c=8)
    l = len(k_ints)
    return (point_map(lambda x: x[..., :l], pts),
            point_map(lambda x: x[..., l:], pts))


def _from_scalars(p_mont, k_ints, a_hat) -> SubspaceKey:
    """The key for P_j = p_j G1, p [8, t] Montgomery."""
    dev = p_mont.device
    P = msm_mod.batch_scalar_mul(G1, msm_mod.generator_table(G1, dev),
                                 fl.from_mont(FR, p_mont), c=8)
    return SubspaceKey(P, *_g2_part(k_ints, a_hat, dev))


def keygen(M: Point, seed: int = 0) -> SubspaceKey:
    """M: [l, 8, t] G1 points (identity for a structural zero)."""
    l, dev = M.x.shape[0], M.x.device
    k_ints, a_hat = _trapdoor(l, seed)
    k_rows = fl.tensor(fl.ints_to_limbs(k_ints), dev).T[:, :, None]
    P = msm_mod.tree_reduce_leading(G1, G1.scalar_mul(M, k_rows))
    return SubspaceKey(P, *_g2_part(k_ints, a_hat, dev))


def keygen_scalar(sM_mont, seed: int = 0) -> SubspaceKey:
    """sM [l, 8, t] Montgomery scalars with M = sM G1."""
    k_ints, a_hat = _trapdoor(sM_mont.shape[0], seed)
    k_rows = fl.tensor(FR.to_mont_ints(k_ints), sM_mont.device).T[:, :, None]
    p = mle.field_sum_leading(fl.mont_mul(FR, sM_mont, k_rows))
    return _from_scalars(p, k_ints, a_hat)


def keygen_scalar_sparse(sM: sp.SparseMatrix, seed: int = 0) -> SubspaceKey:
    """sM a column-major `SparseMatrix` of Montgomery values whose
    positions index the l = sM.nrows rows."""
    k_ints, a_hat = _trapdoor(sM.nrows, seed)
    k = fl.tensor(FR.to_mont_ints(k_ints), sM.values.device)      # [8, l]
    cols = sp.sparse_inner_product(k, sp.SparseVec(sM.values, sM.positions))
    return _from_scalars(cols[..., 0].T, k_ints, a_hat)           # [8, t]


def prove(key: SubspaceKey, w_mont) -> Point:
    """pi = <P, w>, w [8, t'] Montgomery with t' <= t (the missing
    entries are zero)."""
    t = w_mont.shape[-1]
    return msm_mod.msm(G1, point_map(lambda x: x[..., :t], key.P),
                       fl.from_mont(FR, w_mont))


def verify_pairings(key: SubspaceKey, x: Point, pi: Point) -> list:
    """The verification equation as one group of pairs for
    `pairing_checks`: x ‖ -pi against C ‖ a."""
    return [(point_concat([x, G1.neg(pi)]), point_concat([key.C, key.a]))]


def verify(key: SubspaceKey, x: Point, pi: Point):
    """x: [8, l] commitment points -> bool []."""
    return pr.pairing_checks(verify_pairings(key, x, pi)).all()


def make_linking_relation(h: Point, f: Point, bases_h: Point,
                          bases_f: Point) -> Point:
    """The 2 x (2 + N) relation of two commitments to one vector u,

        [ h  0  g_1 ... g_N ]
        [ 0  f  f_1 ... f_N ]

    for the witness w = (r_h, r_f, u) and x = (c_H, c_F) -> [2, 8, 2 + N]."""
    idg = G1.identity((1,), h.x.device)
    return point_stack([point_concat([h, idg, bases_h]),
                        point_concat([idg, f, bases_f])])
