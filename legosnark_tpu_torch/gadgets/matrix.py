"""CPmmp - matrix-multiplication CP-SNARK, honest-verifier prover.

Counterpart of `legosnark_tpu/gadgets/matrix.py:51-128, 200-209`.
Relation C = A*B for n x n matrices committed as n^2-entry MLEs (2d
variables, d = log n):
  1. challenges r, s in Fr^d;
  2. t = C~(row=r, col=s) (C is public: the verifier recomputes it);
  3. sumcheck over d variables on ta[p] = A~(r, p), tb[p] = B~(p, s),
     proving t = sum_p ta[p] * tb[p];
  4. CPpoly openings of the original A at (r || rho) and B at (rho || s).

Matrices are [n, 8, n] (rows leading, columns on the vector axis); the
flattened MLE index is row*n + col, so evaluation points concatenate as
(row point || col point).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..curve.group import Point
from ..prototools import mle
from ..utils import rand as lrand
from . import poly as cppoly
from . import sumcheck as cpsc


class MatKey(NamedTuple):
    n: int
    d: int                  # log2 n
    poly_key: Any           # PolyKey with 2d variables (for A, B, C)


class MatProof(NamedTuple):
    r: Any                  # [8, d] row challenges
    s: Any                  # [8, d] col challenges
    t_comm: Point           # commitment to the claimed product eval
    sc_proof: Any           # SumcheckProof
    c_ans_comm: Point       # answer commitment for C (in clear: t_comm)
    c_poly_pf: Any          # CPpoly proof for committed C (None in clear)


def keygen(n: int, seed: int = 0, device=None) -> MatKey:
    d = int(n).bit_length() - 1
    if 1 << d != n:
        raise ValueError("n must be a power of two")
    return MatKey(n, d, cppoly.keygen(2 * d, seed, device))


def flatten_matrix(M_mont):
    """[n, 8, n] -> [8, n^2] row-major MLE table (index = row*n + col)."""
    n = M_mont.shape[0]
    return M_mont.movedim(0, -2).reshape(M_mont.shape[1:-1] + (n * n,))


def commit_matrix(key: MatKey, M_mont) -> cppoly.PolyComm:
    """Commit an [n, 8, n] matrix as its flattened 2d-variable MLE."""
    return cppoly.commit(key.poly_key, flatten_matrix(M_mont))


def prove_output_in_clear(key: MatKey, A_mont, B_mont, C_mont, r_mont,
                          s_mont, nonces, challenges,
                          hv_rand) -> MatProof:
    """C is public, so no CPpoly proof for it. `challenges` [8, d] are the
    sumcheck rounds' (rho) and `hv_rand` holds 'eq_e' and 'prd_e'."""
    ta = mle.matrix_mle_fold(A_mont, mle.mk_beta(r_mont))
    tb = mle.matrix_mle_fold(_transpose(B_mont), mle.mk_beta(s_mont))
    sc_pf, z0 = cpsc.prove(
        key.poly_key, torch.stack([ta, tb]), {**nonces, **hv_rand},
        challenges,
        open_points=(torch.cat([r_mont, challenges], dim=-1),  # A(r||rho)
                     torch.cat([challenges, s_mont], dim=-1)),  # B(rho||s)
        open_tables=(flatten_matrix(A_mont), flatten_matrix(B_mont)))
    t_comm = cpsc.commit_scalar(key.poly_key.g1, z0)
    return MatProof(r=r_mont, s=s_mont, t_comm=t_comm, sc_proof=sc_pf,
                    c_ans_comm=t_comm, c_poly_pf=None)


def _transpose(M):
    """[n, 8, n] matrix transpose, the limb axis kept at -2."""
    return M.permute(2, 1, 0)


def make_nonces(d: int, seed: int = 0, device=None) -> dict:
    rng = np.random.default_rng(seed ^ 0x3A7B)
    return {"eq_k": lrand.rand_fr_mont(rng, d, device),
            "prd_b": lrand.rand_fr_mont(rng, 5, device)}
