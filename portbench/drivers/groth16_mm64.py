"""Groth16 sessions on the n x n matmul R1CS: the witness commitment
(`commit_emul`), prove, verify.

Set-up: `groth16.matmul_r1cs(n)` and `groth16.setup` (seed from the
configuration), the bases of the emulated commitment (one fixed-base batch
of scalars drawn from the run's seed) and a pool of statements: A and B
drawn from the seed and the statement's index, the witness from the
R1CS's `assign`, its private wires as limbs on the device. A proof takes
the seed of its index (`groth16.prove(..., seed=)`), as
`examples/legogrothmatrix.run` drives the phases.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from legosnark_tpu_torch.curve import msm as msm_mod
from legosnark_tpu_torch.curve.group import G1, G2, g2_generator
from legosnark_tpu_torch.fields import limb as fl
from legosnark_tpu_torch.gadgets import groth16
from legosnark_tpu_torch.prototools import ntt

from portbench import harness
from portbench.reference import _bn254 as hb
from portbench.reference import groth16_mm64 as ref


class Session:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.dev = torch.device(device)
        self.n = n = cfg["n"]
        self.seed = seed
        self.setup_seed = cfg["setup_seed"]
        self.r1cs, assign = groth16.matmul_r1cs(n)
        self.pk, self.vk = groth16.setup(self.r1cs, seed=self.setup_seed,
                                         device=self.dev)
        npub = self.r1cs.num_public + 1
        self.base_scalars = hb.fr_draws(np.random.default_rng(
            harness.derive(seed, "bases")), self.r1cs.num_vars - npub)
        self.bases = msm_mod.batch_scalar_mul(
            G1, msm_mod.generator_table(G1, self.dev),
            fl.tensor(fl.ints_to_limbs(self.base_scalars), self.dev), c=8)
        self.pool = []
        for i in range(traffic["pool"]):
            rng = np.random.default_rng(harness.derive(seed, "statement", i))
            A = [hb.fr_draws(rng, n) for _ in range(n)]
            B = [hb.fr_draws(rng, n) for _ in range(n)]
            z, _ = assign(A, B)
            self.pool.append({
                "A": A, "B": B, "z": z,
                "public": z[1:npub],
                "wit": fl.tensor(fl.ints_to_limbs(z[npub:]), self.dev)})

    def _st(self, k: int) -> dict:
        return self.pool[k % len(self.pool)]

    def prove_seed(self, k: int) -> int:
        return harness.derive(self.seed, "prove", k)

    def warm(self) -> None:
        cm = self.commit(-1)
        self.verify(-1, cm, self.prove(-1, cm))

    def commit(self, k: int):
        return msm_mod.msm(G1, self.bases, self._st(k)["wit"])

    def prove(self, k: int, cm):
        return groth16.prove(self.pk, self.r1cs, self._st(k)["z"],
                             seed=self.prove_seed(k))

    def verify(self, k: int, cm, pf) -> bool:
        return bool(groth16.verify(self.vk, self._st(k)["public"], pf))

    def tampered(self, rec):
        """The record's proof with B moved by the G2 generator."""
        pf = rec.proof
        return groth16.Proof(pf.a, G2.add(pf.b, g2_generator((), self.dev)),
                             pf.c)

    def release(self) -> None:
        self.pk = self.vk = self.bases = None
        for st in self.pool:
            st["wit"] = None

    def check(self, rec) -> list:
        if not hasattr(self, "_trapdoor"):
            self._trapdoor = ref.Trapdoor(self.n, self.setup_seed)
        st = self._st(rec.k)
        pf = rec.proof
        return ref.check(
            self._trapdoor,
            {"A": st["A"], "B": st["B"], "prove_seed": self.prove_seed(rec.k),
             "base_scalars": self.base_scalars},
            {"a": pf.a, "b": pf.b, "c": pf.c, "commit": rec.commit,
             "public": st["public"]})


# ---------------------------------------------------------------------------
# planted faults: the control run on the chip and the tests' broken paths
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _patched(obj, name, fn):
    old = getattr(obj, name)
    setattr(obj, name, fn(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def unblinded_prover():
    """The control: the prover's r and s are zero, so the proof still
    verifies but no longer hides the witness (zero knowledge broken)."""
    def wrap(old):
        def prove(pk, r1cs, z, seed=1):
            import legosnark_tpu_torch.utils.rand as lrand

            real = lrand.rand_fr_int
            lrand.rand_fr_int = lambda rng: 0
            try:
                return old(pk, r1cs, z, seed=seed)
            finally:
                lrand.rand_fr_int = real
        return prove
    return _patched(groth16, "prove", wrap)


def ntt_unchanged():
    """A step that returns its state unchanged: the inverse NTT of H's
    pipeline hands back its input."""
    return _patched(ntt, "intt", lambda old: lambda x, *a, **kw: x)


def msm_half_batch():
    """Half of the batch left out: every G1 and G2 MSM sums only the first
    half of its points and scalars."""
    from legosnark_tpu_torch.curve.group import point_map

    def wrap(old):
        def msm(C, points, scalars, *a, **kw):
            h = max(1, scalars.shape[-1] // 2)
            return old(C, point_map(lambda t: t[..., :h], points),
                       scalars[..., :h], *a, **kw)
        return msm
    return _patched(msm_mod, "msm", wrap)


def answer_altered():
    """An answer altered where it is produced: the proof's C doubled."""
    def wrap(old):
        def prove(*a, **kw):
            pf = old(*a, **kw)
            return groth16.Proof(pf.a, pf.b, G1.double(pf.c))
        return prove
    return _patched(groth16, "prove", wrap)


CONTROLS = {"unblinded_prover": unblinded_prover}
FAULTS = {"ntt_unchanged": ntt_unchanged, "msm_half_batch": msm_half_batch,
          "answer_altered": answer_altered}
