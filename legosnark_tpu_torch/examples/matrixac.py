"""CPAC example: an n x n matrix product as an arithmetic circuit.

Counterpart of `legosnark_tpu/examples/matrixac.py`: C = A B becomes n^3
multiplication gates o_ikj = a_ik b_kj and n^2 linear constraints
sum_k o_ikj = c_ij with C public, proved with CPAC (`gadgets.arithcirc`).
Data from seed 0xAC0 + n (A, then B, then the commitments' randomness),
keygen seed 7. A proof for wires with one output flipped must be
rejected.

Prints one `## AC <phase> Time` line per phase, the proof size and
`VERIFY OK|FAIL, tamper rejected|ACCEPTED`; exits 1 unless the proof
verifies and the tampered one does not.

Usage: python -m legosnark_tpu_torch.examples.matrixac [n] [--cpu]
"""
from __future__ import annotations

import sys

import numpy as np

from ..config import resolve_device
from ..curve import bn254
from ..fields import limb as fl
from ..gadgets import arithcirc
from ..utils import rand as lrand
from ..utils.benchmark import Benchmarkable

FR = bn254.FR
R = bn254.R
PHASES = ("keygen", "prove", "verify")


def build_matmul_rel(n: int, rng) -> tuple:
    """(relation, l, r, o) as ints: gates l = (a_ik), r = (b_kj) over all
    (i, k, j); each constraint sums the gate products into a public c_ij."""
    A = [[lrand.rand_fr_int(rng) for _ in range(n)] for _ in range(n)]
    B = [[lrand.rand_fr_int(rng) for _ in range(n)] for _ in range(n)]
    C = [[sum(A[i][k] * B[k][j] for k in range(n)) % R for j in range(n)]
         for i in range(n)]
    gates = [(i, k, j) for i in range(n) for k in range(n) for j in range(n)]
    ng = len(gates)
    l = [A[i][k] for i, k, _ in gates]
    r = [B[k][j] for _, k, j in gates]
    o = [x * y % R for x, y in zip(l, r)]
    W = np.zeros((n * n, 3 * ng), dtype=object)
    t = []
    for row, (i, j) in enumerate((i, j) for i in range(n) for j in range(n)):
        for g, (gi, _, gj) in enumerate(gates):
            if gi == i and gj == j:
                W[row, 2 * ng + g] = 1          # + o_ikj
        t.append(C[i][j])
    return arithcirc.ACRel(n=ng, W=W, t=t), l, r, o


def run(n: int = 2, device=None) -> dict:
    """CPAC for an n x n product -> relation, wires, key, proof, `ok`,
    `tamper_rejected` and the phase `times` in seconds."""
    dev = resolve_device(device)
    timer = Benchmarkable(f"matrixac_{n}")
    rng = np.random.default_rng(0xAC0 + n)
    rel, l, r, o = build_matmul_rel(n, rng)

    def mont(xs):
        return fl.tensor(FR.to_mont_ints(xs), dev)

    with timer.phase("keygen") as out:
        key = arithcirc.keygen(rel, seed=7, device=dev)
        out.append(key)
    ds = lrand.rand_fr_mont(rng, 3, dev)
    with timer.phase("prove") as out:
        pf = arithcirc.prove(key, mont(l), mont(r), mont(o), ds)
        out.append(pf)
    with timer.phase("verify") as out:
        ok = bool(arithcirc.verify(key, pf))

    o_bad = [(o[0] + 1) % R] + o[1:]
    pf_bad = arithcirc.prove(key, mont(l), mont(r), mont(o_bad), ds)
    rejected = not bool(arithcirc.verify(key, pf_bad))

    for phase in PHASES:
        us = timer.timing_micros(phase)
        print(f"## AC {phase} Time: {us:.0f} micros ({us / 1e6:.3f} s)")
    sizes = arithcirc.proof_size_group_elements()
    print(f"## AC proof size: {sizes['g1']} G1 + {sizes['g2']} G2 + "
          f"{sizes['fr']} Fr")
    print(f"matrixac n={n} (gates={rel.n}) on {dev}: VERIFY "
          f"{'OK' if ok else 'FAIL'}, tamper "
          f"{'rejected' if rejected else 'ACCEPTED'}", flush=True)
    return {"rel": rel, "wires": (l, r, o), "ds": ds, "key": key,
            "proof": pf, "ok": ok, "tamper_rejected": rejected,
            "proof_size": sizes, "times": timer.seconds()}


def main(argv):
    device = "cpu" if "--cpu" in argv else None
    argv = [a for a in argv if a != "--cpu"]
    res = run(int(argv[0]) if argv else 2, device=device)
    if not (res["ok"] and res["tamper_rejected"]):
        raise SystemExit(1)


if __name__ == "__main__":
    main(sys.argv[1:])
