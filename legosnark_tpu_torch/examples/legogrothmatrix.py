"""Groth16 matmul baseline: the `legogrothmatrix` example.

Counterpart of `legosnark_tpu/examples/legogrothmatrix.py`. Builds the
R1CS of C = A*B for n x n matrices as inner-product constraint chains
(n^3 constraints, `groth16.matmul_r1cs`), checks that the witness
satisfies it, and runs Groth16's setup, prover and verifier
(`gadgets.groth16`). Like the JAX example it also times the extra G1 MSM
that committing the witness wires would add in a commit-and-prove
composition (`commit_emul`). Data: rng 67 + n draws A, then B, then the
emulated commitment's base scalars; setup and prove use seed n.

Prints one `##` line per phase, then the proof size and VERIFY OK or
VERIFY FAIL (exit code 1).

Usage: python -m legosnark_tpu_torch.examples.legogrothmatrix [MIN_N]
       [MAX_N] [--cpu]     (n doubles from MIN_N up to MAX_N)
"""
from __future__ import annotations

import sys

import numpy as np

from ..config import resolve_device
from ..curve import bn254
from ..curve import msm as msm_mod
from ..curve.group import G1
from ..fields import limb as fl
from ..gadgets import groth16
from ..utils import benchmark as bm
from ..utils import rand as lrand

R = bn254.R
PHASES = ("keygen", "prove", "verify", "commit_emul")


def run(n: int, device=None) -> dict:
    """Groth16 on the n x n matmul R1CS -> the R1CS, witness z, keys,
    proof, public inputs, `ok`, `proof_size` and the phase `times` in
    seconds."""
    dev = resolve_device(device)
    timer = bm.Benchmarkable(f"groth16_n{n}")

    rng = np.random.default_rng(67 + n)
    r1cs, assign = groth16.matmul_r1cs(n)
    A = [[lrand.rand_fr_int(rng) for _ in range(n)] for _ in range(n)]
    B = [[lrand.rand_fr_int(rng) for _ in range(n)] for _ in range(n)]
    z, _ = assign(A, B)
    for a, b, c in zip(*(groth16.sparse_matvec(rows, z)
                         for rows in (r1cs.A, r1cs.B, r1cs.C))):
        assert a * b % R == c, "R1CS unsatisfied"

    with timer.phase("keygen") as out:
        pk, vk = groth16.setup(r1cs, seed=n, device=dev)
        out.append(pk)
    with timer.phase("prove") as out:
        pf = groth16.prove(pk, r1cs, z, seed=n)
        out.append(pf)
    public = z[1 : r1cs.num_public + 1]
    with timer.phase("verify"):
        ok = bool(groth16.verify(vk, public, pf))

    # the MSM that commits the witness wires in a commit-and-prove
    # composition, on bases drawn from the same rng
    npub = r1cs.num_public + 1
    wit = fl.tensor(fl.ints_to_limbs(z[npub:]), dev)
    bases = msm_mod.batch_scalar_mul(
        G1, msm_mod.generator_table(G1, dev), fl.tensor(fl.ints_to_limbs(
            lrand.rand_fr_ints(rng, wit.shape[-1])), dev), c=8)
    with timer.phase("commit_emul") as out:
        out.append(msm_mod.msm(G1, bases, wit))

    sizes = groth16.proof_size_group_elements()
    print(f"=== Groth16 matmul n={n}x{n} ({len(r1cs.A)} constraints, "
          f"{r1cs.num_vars} vars) on {dev} ===")
    for name in PHASES:
        bm.print_bm(f"groth16_{name}_n{n}", timer.timing_micros(name))
    print(f"## proof size: {sizes['g1']} G1 + {sizes['g2']} G2")
    print(f"VERIFY {'OK' if ok else 'FAIL'}", flush=True)
    return {"n": n, "r1cs": r1cs, "z": z, "pk": pk, "vk": vk, "pf": pf,
            "public": public, "ok": ok, "proof_size": sizes,
            "times": timer.seconds()}


def main(argv):
    device = "cpu" if "--cpu" in argv else None
    argv = [a for a in argv if a != "--cpu"]
    min_n = int(argv[0]) if argv else 2
    max_n = int(argv[1]) if len(argv) > 1 else min_n
    n = min_n
    while n <= max_n:
        if not run(n, device=device)["ok"]:
            raise SystemExit(1)
        n *= 2


if __name__ == "__main__":
    main(sys.argv[1:])
