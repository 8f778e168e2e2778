"""CPhad - Hadamard-product CP-SNARK (sumcheck-based).

Counterpart of `legosnark_tpu/gadgets/hadamard.py:41-196`. Relation:
c = a o b for committed n-vectors (MLEs of d = log2 n variables):
  1. a challenge rho in Fr^d;
  2. a CPpoly opening of the committed c at rho, the claim t = c~(rho);
  3. a sumcheck proving t = sum_p eq(rho, p) * a[p] * b[p] (the weight
     table `mle.mk_beta(rho)`, degree-3 rounds), with CPpoly openings of
     a and b at the round challenges; the verifier evaluates
     beta(rho, r) in closed form (`mle.eval_beta_point`).

The verifier checks c's opening and knowledge equation together with the
sumcheck's openings, in its one `pairing_checks` call.

Modes: honest-verifier (`prove`/`verify`: rho, the round challenges and
the sigma challenges are given) and Fiat-Shamir (`prove_fs`/`verify_fs`,
the default of the example: rho and every later challenge come from a
transcript seeded with the three input commitments).

Layout: vectors [8, n]; challenge lists [8, d].
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


class HadKey(NamedTuple):
    n: int
    d: int
    poly_key: Any           # PolyKey with d variables


class HadProof(NamedTuple):
    rho: Any                # [8, d]
    t_ans_comm: Point       # CPpoly answer commitment to c~(rho)
    c_poly_pf: Any          # CPpoly proof for c at rho
    sc_proof: Any           # SumcheckProof (degree 3)


def proof_size_group_elements(key: HadKey) -> dict:
    """Proof size (`hadamardsc.h:32-45`): the sumcheck's, plus t's
    commitment, c's opening and rho."""
    sc = cpsc.proof_size_group_elements(key.d, 3)
    return {"g1": sc["g1"] + 1 + 2 * key.d, "g2": sc["g2"],
            "fr": sc["fr"] + key.d}


def _log2(n: int) -> int:
    d = int(n).bit_length() - 1
    if 1 << d != n:
        raise ValueError("n must be a power of two")
    return d


def keygen(n: int, seed: int = 0, device=None) -> HadKey:
    d = _log2(n)
    return HadKey(n, d, cppoly.keygen(d, seed, device))


def keygen_cached(n: int, seed: int = 0, cache_dir=None,
                  device=None) -> HadKey:
    """`keygen` through the SRS disk cache (`poly.keygen_cached`)."""
    d = _log2(n)
    return HadKey(n, d, cppoly.keygen_cached(d, seed, cache_dir, device))


def commit_vec(key: HadKey, v_mont) -> cppoly.PolyComm:
    return cppoly.commit(key.poly_key, v_mont)


def make_nonces(d: int, seed: int = 0, device=None) -> dict:
    """Prover sigma nonces, the JAX package's draws for the same seed."""
    rng = np.random.default_rng(seed ^ 0xA0CE5)
    return {"eq_k": lrand.rand_fr_mont(rng, d, device),
            "prd_b": lrand.rand_fr_mont(rng, 5, device)}


def _same_point(r):
    """The sumcheck opens a and b at its own round challenges."""
    return r, r


def _prove(key: HadKey, a_mont, b_mont, c_mont, rho, rand, challenges=None,
           transcript=None) -> HadProof:
    _, t_comm = cppoly.compute_answer(key.poly_key, c_mont, rho)
    if transcript is not None:
        transcript.absorb_point(t_comm)
    # c's opening at rho is proved with the sumcheck's openings of a and b
    sc_pf, _, _, (c_pf,) = cpsc.prove(
        key.poly_key, torch.stack([a_mont, b_mont]), rand, _same_point,
        (a_mont, b_mont), challenges=challenges, transcript=transcript,
        beta_table=mle.mk_beta(rho), extra_openings=((c_mont, rho),))
    return HadProof(rho=rho, t_ans_comm=t_comm, c_poly_pf=c_pf,
                    sc_proof=sc_pf)


def _verify(key: HadKey, a_comm, b_comm, c_comm, proof: HadProof, rho,
            rand=None, transcript=None):
    return cpsc.verify(
        key.poly_key, proof.t_ans_comm, (a_comm, b_comm), proof.sc_proof,
        _same_point, rand=rand, transcript=transcript,
        extra_openings=((c_comm, proof.t_ans_comm, rho, proof.c_poly_pf),),
        beta_point_fn=lambda r: mle.eval_beta_point(rho, r))


def prove(key: HadKey, a_mont, b_mont, c_mont, rho_mont, challenges,
          sigma_rand) -> HadProof:
    """Honest-verifier mode: rho [8, d], the round `challenges` [8, d] and
    `sigma_rand` ('eq_k', 'prd_b' nonces and 'eq_e', 'prd_e' challenges)
    are given."""
    return _prove(key, a_mont, b_mont, c_mont, rho_mont, sigma_rand,
                  challenges=challenges)


def verify(key: HadKey, a_comm, b_comm, c_comm, proof: HadProof,
           sigma_rand):
    """Honest-verifier verify -> bool [], with the proof's rho and round
    challenges and the sigma challenges 'eq_e', 'prd_e'."""
    return _verify(key, a_comm, b_comm, c_comm, proof, proof.rho,
                   rand=sigma_rand)


def _seed_transcript(a_comm, b_comm, c_comm) -> Transcript:
    """Label "HADM", then each input commitment's (C, Ca) in one absorb."""
    tr = Transcript(label=0x4841444D, device=a_comm.c.x.device)
    for cm in (a_comm, b_comm, c_comm):
        tr.absorb_point(point_concat([cm.c, cm.ca]))
    return tr


def prove_fs(key: HadKey, a_mont, b_mont, c_mont, a_comm, b_comm, c_comm,
             nonces=None) -> HadProof:
    """Fiat-Shamir prove: rho after the input commitments, t's commitment
    absorbed before the sumcheck, whose challenges all come from the
    transcript."""
    if nonces is None:
        nonces = make_nonces(key.d, device=a_mont.device)
    tr = _seed_transcript(a_comm, b_comm, c_comm)
    return _prove(key, a_mont, b_mont, c_mont, tr.challenges(key.d), nonces,
                  transcript=tr)


def verify_fs(key: HadKey, a_comm, b_comm, c_comm, proof: HadProof):
    """Fiat-Shamir verify -> bool []: rho and every later challenge are
    recomputed (the proof's rho and r are not read)."""
    tr = _seed_transcript(a_comm, b_comm, c_comm)
    rho = tr.challenges(key.d)
    tr.absorb_point(proof.t_ans_comm)
    return _verify(key, a_comm, b_comm, c_comm, proof, rho, transcript=tr)
