"""Sparse vectors and matrices, and sparse MSMs.

Counterpart of `legosnark_tpu/utils/sparse.py`. A sparse vector is its
values [.., 8, nnz] (Fr limbs, or a point batch) and their positions
[nnz], with a fixed nnz: padding entries carry the value zero, so they
add nothing (a zero scalar has only zero digits). A column-major sparse
matrix holds one such vector per column, [ncols, 8, nnz_max] and
[ncols, nnz_max].

Leading axes of the positions batch every operation: `matvec_g1` runs
all columns of a matrix as rows of one MSM, and `sparse_inner_product`
all columns as one product and one sum.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..config import resolve_device
from ..curve import bn254
from ..curve import msm as msm_mod
from ..curve.group import G1, CurveOps, Point, point_map
from ..fields import limb as fl
from ..prototools import mle

FR = bn254.FR


class SparseVec(NamedTuple):
    values: Any     # [.., 8, nnz] Fr limbs, or a point batch
    positions: Any  # [.., nnz] int64


def _take(x, positions):
    """x [E.., n] at positions [T.., k] along the last axis ->
    [T.., E.., k]."""
    t = positions.dim() - 1
    return x.movedim(-1, 0)[positions].movedim(t, -1)


def from_dense_scalars(v_can, nnz: int | None = None) -> SparseVec:
    """The nonzero entries of canonical scalars [8, n], padded with zeros
    to nnz entries when nnz is given."""
    v = v_can.cpu().numpy()
    pos = np.nonzero(~(v == 0).all(axis=-2))[0]
    vals = v[..., pos]
    if nnz is not None:
        pad = nnz - pos.shape[0]
        if pad < 0:
            raise ValueError(f"{pos.shape[0]} nonzeros exceed nnz {nnz}")
        vals = np.concatenate(
            [vals, np.zeros(v.shape[:-1] + (pad,), v.dtype)], axis=-1)
        pos = np.concatenate([pos, np.zeros((pad,), pos.dtype)])
    dev = v_can.device
    return SparseVec(torch.from_numpy(np.ascontiguousarray(vals)).to(dev),
                     torch.from_numpy(pos.astype(np.int64)).to(dev))


def sparse_msm_scalars(C: CurveOps, points: Point, sv: SparseVec,
                       c: int | None = None) -> Point:
    """sum_k values_k points[positions_k]: dense bases, sparse canonical
    scalars; only the touched bases enter the MSM."""
    touched = point_map(lambda x: _take(x, sv.positions), points)
    return msm_mod.msm(C, touched, sv.values, c=c)


def sparse_msm_points(C: CurveOps, sv_points: SparseVec, exps_can,
                      c: int | None = None) -> Point:
    """sum_k exps[positions_k] values_k: sparse bases, dense canonical
    scalars [8, n]."""
    return msm_mod.msm(C, sv_points.values,
                       _take(exps_can, sv_points.positions), c=c)


def sparse_inner_product(dense_mont, sv: SparseVec):
    """<dense, sparse> over Fr, both Montgomery -> [.., 8, 1]."""
    return mle.field_sum(fl.mont_mul(FR, _take(dense_mont, sv.positions),
                                     sv.values))


class SparseMatrix(NamedTuple):
    """Column-major: one sparse vector per column."""

    values: Any     # [ncols, 8, nnz_max]
    positions: Any  # [ncols, nnz_max] row indices
    nrows: int


def insert_as_col_major(entries, nrows: int, ncols: int, nnz_max: int,
                        mont: bool = False, device=None) -> SparseMatrix:
    """entries = [(row, col, int value)]. mont=True stores Montgomery
    values (for `sparse_inner_product`), the default canonical ones (for
    the sparse MSMs)."""
    dev = resolve_device(device)
    ints = np.zeros((ncols, nnz_max), dtype=object)
    pos = np.zeros((ncols, nnz_max), dtype=np.int64)
    fill = [0] * ncols
    for r, c_, v in entries:
        k = fill[c_]
        if k >= nnz_max:
            raise ValueError(f"column {c_} has more than {nnz_max} entries")
        ints[c_, k] = FR.to_mont_int(v) if mont else v % bn254.R
        pos[c_, k] = r
        fill[c_] += 1
    vals = fl.ints_to_limbs(ints.reshape(-1))               # [8, ncols*nnz]
    vals = np.moveaxis(vals.reshape(fl.NLIMBS, ncols, nnz_max), 0, 1)
    return SparseMatrix(fl.tensor(np.ascontiguousarray(vals), dev),
                        torch.from_numpy(pos).to(dev), nrows)


def matvec_g1(M: SparseMatrix, points: Point) -> Point:
    """P_j = sum_k M[pos_k, j] points[pos_k] for every column j, as rows
    of one MSM -> [ncols, 8, 1]."""
    touched = point_map(lambda x: _take(x, M.positions), points)
    return msm_mod.msm(G1, touched, M.values, c=4)
