"""CPmmp - matrix-multiplication CP-SNARK.

Counterpart of `legosnark_tpu/gadgets/matrix.py:51-209, 287-332`.
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

Modes: honest-verifier (`prove_output_in_clear`, `prove` with injected
challenges, verified with the same challenges) and Fiat-Shamir
(`prove_*_fs` / `verify_*_fs`: r and s come from a transcript seeded
with the input commitments, and in the in-clear mode with C itself).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..curve.group import Point, point_concat
from ..prototools import mle
from ..utils import rand as lrand
from ..utils.transcript import Transcript
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


def proof_size_group_elements(key: MatKey) -> dict:
    """Proof size (`MatPf::getSize`): the degree-2 sumcheck's, plus
    t_comm, the answer commitment for C and two openings over 2d
    variables; r and s in Fr."""
    sc = cpsc.proof_size_group_elements(key.d, 2)
    return {"g1": sc["g1"] + 2 + 2 * 2 * key.d, "g2": sc["g2"],
            "fr": sc["fr"] + 2 * key.d}


def _log2(n: int) -> int:
    d = int(n).bit_length() - 1
    if 1 << d != n:
        raise ValueError("n must be a power of two")
    return d


def keygen(n: int, seed: int = 0, device=None) -> MatKey:
    d = _log2(n)
    return MatKey(n, d, cppoly.keygen(2 * d, seed, device))


def keygen_cached(n: int, seed: int = 0, cache_dir=None,
                  device=None) -> MatKey:
    """`keygen` through the SRS disk cache (`poly.keygen_cached`)."""
    d = _log2(n)
    return MatKey(n, d, cppoly.keygen_cached(2 * d, seed, cache_dir, device))


def flatten_matrix(M_mont):
    """[n, 8, n] -> [8, n^2] row-major MLE table (index = row*n + col)."""
    n = M_mont.shape[0]
    return M_mont.movedim(0, -2).reshape(M_mont.shape[1:-1] + (n * n,))


def commit_matrix(key: MatKey, M_mont) -> cppoly.PolyComm:
    """Commit an [n, 8, n] matrix as its flattened 2d-variable MLE."""
    return cppoly.commit(key.poly_key, flatten_matrix(M_mont))


def _open_points_fn(r_mont, s_mont):
    """Round challenges rho -> the opening points A(r || rho), B(rho || s)."""
    return lambda rho: (torch.cat([r_mont, rho], dim=-1),
                        torch.cat([rho, s_mont], dim=-1))


def prove_output_in_clear(key: MatKey, A_mont, B_mont, C_mont, r_mont,
                          s_mont, nonces, challenges=None, hv_rand=None,
                          transcript=None) -> MatProof:
    """C is public, so no CPpoly proof for it. Honest-verifier mode:
    `challenges` [8, d] are the sumcheck rounds' (rho) and `hv_rand`
    holds 'eq_e' and 'prd_e'; Fiat-Shamir mode: a `transcript` instead."""
    ta = mle.matrix_mle_fold(A_mont, mle.mk_beta(r_mont))
    tb = mle.matrix_mle_fold(_transpose(B_mont), mle.mk_beta(s_mont))
    sc_pf, _, t_comm, _ = cpsc.prove(
        key.poly_key, torch.stack([ta, tb]), {**nonces, **(hv_rand or {})},
        _open_points_fn(r_mont, s_mont),
        (flatten_matrix(A_mont), flatten_matrix(B_mont)),
        challenges=challenges, transcript=transcript)
    return MatProof(r=r_mont, s=s_mont, t_comm=t_comm, sc_proof=sc_pf,
                    c_ans_comm=t_comm, c_poly_pf=None)


def eval_public_output(C_mont, r_mont, s_mont):
    """The verifier's O(n^2) evaluation of the public output's MLE at
    (r || s): 2d folds of the flattened C."""
    return mle.eval_mle(flatten_matrix(C_mont),
                        torch.cat([r_mont, s_mont], dim=-1))


def verify_output_in_clear(key: MatKey, a_comm, b_comm, C_mont,
                           proof: MatProof, r_mont=None, s_mont=None,
                           hv_rand=None, transcript=None):
    """The verifier evaluates the public C's MLE itself and requires the
    sumcheck to be rooted at exactly that value (t_comm = t*G) -> bool []."""
    r_mont = proof.r if r_mont is None else r_mont
    s_mont = proof.s if s_mont is None else s_mont
    return cpsc.verify(key.poly_key, proof.t_comm, (a_comm, b_comm),
                       proof.sc_proof, _open_points_fn(r_mont, s_mont),
                       rand=hv_rand, transcript=transcript,
                       z0_mont=eval_public_output(C_mont, r_mont, s_mont))


def prove(key: MatKey, A_mont, B_mont, C_mont, r_mont, s_mont, nonces,
          challenges=None, hv_rand=None, transcript=None) -> MatProof:
    """Committed-output variant: also opens the committed C at (r || s)."""
    base = prove_output_in_clear(key, A_mont, B_mont, C_mont, r_mont, s_mont,
                                 nonces, challenges, hv_rand, transcript)
    c_flat = flatten_matrix(C_mont)
    rs_point = torch.cat([r_mont, s_mont], dim=-1)
    _, t_ans_comm = cppoly.compute_answer(key.poly_key, c_flat, rs_point)
    c_pf = cppoly.prove(key.poly_key, c_flat, rs_point)
    return base._replace(c_ans_comm=t_ans_comm, c_poly_pf=c_pf)


def verify(key: MatKey, a_comm, b_comm, c_comm, proof: MatProof,
           r_mont=None, s_mont=None, hv_rand=None, transcript=None):
    """Committed-output verify -> bool []: C's opening at (r || s) roots
    the sumcheck, and is checked with the sumcheck's own openings."""
    r_mont = proof.r if r_mont is None else r_mont
    s_mont = proof.s if s_mont is None else s_mont
    rs_point = torch.cat([r_mont, s_mont], dim=-1)
    return cpsc.verify(key.poly_key, proof.c_ans_comm, (a_comm, b_comm),
                       proof.sc_proof, _open_points_fn(r_mont, s_mont),
                       rand=hv_rand, transcript=transcript,
                       extra_openings=((c_comm, proof.c_ans_comm, rs_point,
                                        proof.c_poly_pf),))


def _transpose(M):
    """[n, 8, n] matrix transpose, the limb axis kept at -2."""
    return M.permute(2, 1, 0)


def make_nonces(d: int, seed: int = 0, device=None) -> dict:
    rng = np.random.default_rng(seed ^ 0x3A7B)
    return {"eq_k": lrand.rand_fr_mont(rng, d, device),
            "prd_b": lrand.rand_fr_mont(rng, 5, device)}


# ---------------------------------------------------------------------------
# Fiat-Shamir wrappers
# ---------------------------------------------------------------------------


def _seed_transcript(a_comm, b_comm, extra=None) -> Transcript:
    """Label "MMRC", then each input commitment's (C, Ca) in one absorb."""
    tr = Transcript(label=0x4D4D5243, device=a_comm.c.x.device)
    for cm in (a_comm, b_comm) + ((extra,) if extra is not None else ()):
        tr.absorb_point(point_concat([cm.c, cm.ca]))
    return tr


def _fs_in_clear(a_comm, b_comm, C_mont, d: int):
    tr = _seed_transcript(a_comm, b_comm)
    tr.absorb_fr(flatten_matrix(C_mont))       # the public output binds r, s
    return tr, tr.challenges(d), tr.challenges(d)


def prove_output_in_clear_fs(key: MatKey, A_mont, B_mont, C_mont, a_comm,
                             b_comm, nonces=None) -> MatProof:
    if nonces is None:
        nonces = make_nonces(key.d, device=A_mont.device)
    tr, r, s = _fs_in_clear(a_comm, b_comm, C_mont, key.d)
    return prove_output_in_clear(key, A_mont, B_mont, C_mont, r, s, nonces,
                                 transcript=tr)


def verify_output_in_clear_fs(key: MatKey, a_comm, b_comm, C_mont,
                              proof: MatProof):
    tr, r, s = _fs_in_clear(a_comm, b_comm, C_mont, key.d)
    return verify_output_in_clear(key, a_comm, b_comm, C_mont, proof,
                                  r_mont=r, s_mont=s, transcript=tr)


def prove_fs(key: MatKey, A_mont, B_mont, C_mont, a_comm, b_comm, c_comm,
             nonces=None) -> MatProof:
    if nonces is None:
        nonces = make_nonces(key.d, device=A_mont.device)
    tr = _seed_transcript(a_comm, b_comm, extra=c_comm)
    r, s = tr.challenges(key.d), tr.challenges(key.d)
    return prove(key, A_mont, B_mont, C_mont, r, s, nonces, transcript=tr)


def verify_fs(key: MatKey, a_comm, b_comm, c_comm, proof: MatProof):
    tr = _seed_transcript(a_comm, b_comm, extra=c_comm)
    r, s = tr.challenges(key.d), tr.challenges(key.d)
    return verify(key, a_comm, b_comm, c_comm, proof, r_mont=r, s_mont=s,
                  transcript=tr)
