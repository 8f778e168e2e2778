"""CPmmp sessions: commit A and B, prove C = A*B with C public, verify.

Set-up: `matrix.keygen_cached` (the SRS from the checkout's
`srs_cache/`), then a pool of statements, each with A and B drawn on the
device from the seed and the statement's index (canonical limbs below
2^253) and C = A*B by the port's `mle.matmul_mont`. The traffic's `mode`
picks Fiat-Shamir (`prove_output_in_clear_fs` / `verify_output_in_clear_fs`)
or honest-verifier (`prove_output_in_clear` / `verify_output_in_clear`,
the challenges drawn from the proof's seed), driven as
`examples/matrixsc.run` drives them. Every proof takes the nonces of its
own seed (`matrix.make_nonces`).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from legosnark_tpu_torch.curve import bn254
from legosnark_tpu_torch.curve.group import G1, Point, point_map
from legosnark_tpu_torch.fields import limb as fl
from legosnark_tpu_torch.gadgets import matrix as cpmat
from legosnark_tpu_torch.prototools import mle

from portbench import harness
from portbench.reference import _bn254 as hb
from portbench.reference import cpmmp_1024 as ref

FR = bn254.FR


def _mont(ints, device):
    return fl.tensor(FR.to_mont_ints(ints), device)


def _canonical_matrix(gen, n: int, device) -> torch.Tensor:
    """[n, 8, n] canonical Fr limbs below 2^253, one draw on the device."""
    w = torch.randint(0, 1 << 32, (n, fl.NLIMBS, n), generator=gen,
                      dtype=torch.int64, device=device)
    w[:, -1] &= (1 << 29) - 1
    return fl.narrow(w)


class Session:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.dev = torch.device(device)
        self.fs = traffic["mode"] == "fs"
        self.n = n = cfg["n"]
        self.d = n.bit_length() - 1
        self.seed = seed
        self.srs_seed = cfg["srs_seed"]
        self.key = cpmat.keygen_cached(n, seed=self.srs_seed,
                                       cache_dir=cfg.get("srs_cache_dir"),
                                       device=self.dev)
        self.pool = []
        for i in range(traffic["pool"]):
            gen = torch.Generator(device=self.dev)
            gen.manual_seed(harness.derive(seed, "statement", i))
            A = _canonical_matrix(gen, n, self.dev)
            B = _canonical_matrix(gen, n, self.dev)
            Am, Bm = fl.to_mont(FR, A), fl.to_mont(FR, B)
            self.pool.append({"A": A, "B": B, "Am": Am, "Bm": Bm,
                              "C": mle.matmul_mont(Am, Bm)})

    def _challenges(self, k: int) -> dict:
        """The honest verifier's challenges of proof k, as ints."""
        rng = np.random.default_rng(harness.derive(self.seed, "hv", k))
        d = self.d
        return {"chal": hb.fr_draws(rng, d), "eq_e": hb.fr_draws(rng, d),
                "prd_e": hb.fr_draws(rng, 1), "r": hb.fr_draws(rng, d),
                "s": hb.fr_draws(rng, d)}

    def warm(self) -> None:
        """One statement through all three phases, outside the window."""
        cm = self.commit(-1)
        self.verify(-1, cm, self.prove(-1, cm))

    def commit(self, k: int):
        st = self.pool[k % len(self.pool)]
        return (cpmat.commit_matrix(self.key, st["Am"]),
                cpmat.commit_matrix(self.key, st["Bm"]))

    def prove(self, k: int, cm):
        st = self.pool[k % len(self.pool)]
        nonces = cpmat.make_nonces(self.d, seed=harness.derive(
            self.seed, "nonces", k), device=self.dev)
        if self.fs:
            return cpmat.prove_output_in_clear_fs(
                self.key, st["Am"], st["Bm"], st["C"], cm[0], cm[1], nonces)
        ch = {key: _mont(v, self.dev) for key, v in self._challenges(k).items()}
        return cpmat.prove_output_in_clear(
            self.key, st["Am"], st["Bm"], st["C"], ch["r"], ch["s"], nonces,
            challenges=ch["chal"],
            hv_rand={"eq_e": ch["eq_e"], "prd_e": ch["prd_e"]})

    def verify(self, k: int, cm, pf) -> bool:
        C = self.pool[k % len(self.pool)]["C"]
        if self.fs:
            ok = cpmat.verify_output_in_clear_fs(self.key, cm[0], cm[1], C, pf)
        else:
            ch = self._challenges(k)
            ok = cpmat.verify_output_in_clear(
                self.key, cm[0], cm[1], C, pf,
                hv_rand={"eq_e": _mont(ch["eq_e"], self.dev),
                         "prd_e": _mont(ch["prd_e"], self.dev)})
        return bool(ok)

    def tampered(self, rec):
        """The record's proof with A's first opening witness W_0 moved to
        the end: only the pairing equations can reject it."""
        sc = rec.proof.sc_proof
        w = sc.poly_pfs[0]
        bad = w._replace(witness=Point(*(t.roll(1, -1) for t in w.witness)))
        return rec.proof._replace(sc_proof=sc._replace(
            poly_pfs=(bad,) + tuple(sc.poly_pfs[1:])))

    def release(self) -> None:
        self.key = None
        for st in self.pool:
            st["Am"] = st["Bm"] = None

    def check(self, rec) -> list:
        """The reference's findings on one record: the names of the values
        and equations it could not confirm (empty when the proof is the
        honest one)."""
        st = self.pool[rec.k % len(self.pool)]
        pf, sc = rec.proof, rec.proof.sc_proof
        out = {"a_c": rec.commit[0].c, "a_ca": rec.commit[0].ca,
               "b_c": rec.commit[1].c, "b_ca": rec.commit[1].ca,
               "r": pf.r, "s": pf.s, "t_comm": pf.t_comm,
               "h_comms": sc.h_comms, "sc_r": sc.r, "eq_a": sc.eq_proofs.a,
               "eq_z": sc.eq_proofs.z, "ans_comms": sc.ans_comms,
               "finals": sc.finals,
               "openings": [(p.witness, p.witnessa) for p in sc.poly_pfs],
               "prd": sc.prd_proof._asdict()}
        inputs = {"A": st["A"], "B": st["B"], "C": st["C"], "n": self.n,
                  "srs_seed": self.srs_seed,
                  "freivalds_seed": harness.derive(self.seed, "freivalds",
                                                   rec.k),
                  "hv": None if self.fs else self._challenges(rec.k)}
        return ref.check(inputs, out)


# ---------------------------------------------------------------------------
# planted faults: the controls run on the chip and the tests' broken paths
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _patched(obj, name, fn):
    old = getattr(obj, name)
    setattr(obj, name, fn(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def transcript_half_output():
    """The control of the Fiat-Shamir cell: the transcript of r and s
    absorbs only the first half of the public output C, so the challenges
    no longer bind all of C. Prover and verifier agree with each other."""
    def wrap(old):
        def fs_in_clear(a_comm, b_comm, C_mont, d):
            tr = cpmat._seed_transcript(a_comm, b_comm)
            flat = cpmat.flatten_matrix(C_mont)
            tr.absorb_fr(flat[..., : flat.shape[-1] // 2])
            return tr, tr.challenges(d), tr.challenges(d)
        return fs_in_clear
    return _patched(cpmat, "_fs_in_clear", wrap)


def verifier_without_pairings():
    """The control of the honest-verifier cell: the sumcheck verifier's
    pairing stage (every CPpoly opening and knowledge equation) always
    passes."""
    from legosnark_tpu_torch.curve import pairing as pr

    def wrap(old):
        def pairing_checks(groups):
            return torch.ones(len(groups), dtype=torch.bool,
                              device=groups[0][0].x.device)
        return pairing_checks
    return _patched(pr, "pairing_checks", wrap)


def fold_unchanged():
    """A step that returns its state unchanged: the sumcheck's fold keeps
    the lower half of the table instead of binding the challenge."""
    def wrap(old):
        def fold(v, r):
            return v[..., : v.shape[-1] // 2]
        return fold
    return _patched(mle, "fold", wrap)


def msm_half_batch():
    """Half of the batch left out: every MSM sums only its first half of
    points and scalars."""
    from legosnark_tpu_torch.curve import msm as msm_mod

    def wrap(old):
        def msm(C, points, scalars, *a, **kw):
            h = max(1, scalars.shape[-1] // 2)
            return old(C, point_map(lambda t: t[..., :h], points),
                       scalars[..., :h], *a, **kw)
        return msm
    return _patched(msm_mod, "msm", wrap)


def answer_altered():
    """An answer altered where it is produced: t_comm, the commitment to
    the claimed product, moves by one generator."""
    def wrap(old):
        def prove_output_in_clear(*a, **kw):
            pf = old(*a, **kw)
            g = pf.t_comm
            return pf._replace(t_comm=G1.add(g, G1.double(g)))
        return prove_output_in_clear
    return _patched(cpmat, "prove_output_in_clear", wrap)


CONTROLS = {"transcript_half_output": transcript_half_output,
            "verifier_without_pairings": verifier_without_pairings}
FAULTS = {"fold_unchanged": fold_unchanged, "msm_half_batch": msm_half_batch,
          "answer_altered": answer_altered}
