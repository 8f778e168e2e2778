"""CPlink example: two commitments to one vector, linked.

Counterpart of `legosnark_tpu/examples/cplink.py`. Commits one vector u
of N = 2^LOG_N entries under two independent `prototools.commit` keys
(seeds 1 and 2) through `gadgets.snark`'s input flow, builds the
2 x (2N + 2) linking relation [h 0 g_1..g_N ; 0 f f_1..f_N] as a sparse
column-major matrix of the keys' scalars, runs the subspace argument with
the sparse scalar keygen (seed 7), and verifies the proof together with
both commitments' knowledge legs, all in one product-of-pairings check.
Data: u from seed 23 (31 random bytes per entry), then r_H and r_F.

Prints one `##` line per phase, the proof size and VERIFY OK or VERIFY
FAIL (exit code 1).

Usage: python -m legosnark_tpu_torch.examples.cplink [LOG_N] [--cpu]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import resolve_device
from ..curve import bn254
from ..curve import pairing as pr
from ..curve.group import point_concat
from ..fields import limb as fl
from ..gadgets import snark, subspace
from ..prototools import commit as cs
from ..utils import benchmark as bm
from ..utils import sparse as sp

FR = bn254.FR
R = bn254.R
PHASES = ("ck_keygen", "commit", "keygen", "prove", "verify")


def run(log_n: int, device=None) -> dict:
    """CPlink at N = 2^log_n -> keys, commitments, relation, proof, `ok`,
    `proof_size` and the phase `times` in seconds."""
    dev = resolve_device(device)
    n = 1 << log_n
    timer = bm.Benchmarkable(f"cplink_{log_n}")
    rng = np.random.default_rng(23)

    with timer.phase("ck_keygen") as out:
        ck_h, s_h = cs.keygen(n, seed=1, return_scalars=True, device=dev)
        ck_f, s_f = cs.keygen(n, seed=2, return_scalars=True, device=dev)
        out.append((ck_h, ck_f))
    sh_ints = [int(v) for v in fl.limbs_to_ints(s_h.cpu())]
    sf_ints = [int(v) for v in fl.limbs_to_ints(s_f.cpu())]

    u_ints = [int.from_bytes(rng.bytes(31), "little") % R for _ in range(n)]
    u = fl.tensor(FR.to_mont_ints(u_ints), dev)
    with timer.phase("commit") as out:
        # u under both keys, r_H then r_F: rows of one G1 and one G2 MSM
        (pin_h, vin_h), (pin_f, vin_f) = snark.init_each(
            [ck_h, ck_f], (), [u], rng)
        out.append((vin_h, vin_f))

    # [ h 0 g_1..g_N ; 0 f f_1..f_N ]: two nonzeros per base column; the
    # JAX package's t = 2N + 2 leaves the last N columns empty
    t = 2 * n + 2
    entries = [(0, 0, sh_ints[n]), (1, 1, sf_ints[n])]
    for j in range(n):
        entries.append((0, 2 + j, sh_ints[j]))
        entries.append((1, 2 + j, sf_ints[j]))
    sM = sp.insert_as_col_major(entries, nrows=2, ncols=t, nnz_max=2,
                                mont=True, device=dev)
    with timer.phase("keygen") as out:
        key = subspace.keygen_scalar_sparse(sM, seed=7)
        out.append(key)

    cH, cF = vin_h.comm_in[0], vin_f.comm_in[0]
    w = torch.cat([pin_h.comm_slot[0].r, pin_f.comm_slot[0].r, u], dim=-1)
    with timer.phase("prove") as out:
        pi = subspace.prove(key, w)
        out.append(pi)

    x = point_concat([cH.c, cF.c])
    with timer.phase("verify") as out:
        ok = bool(pr.pairing_checks(
            subspace.verify_pairings(key, x, pi)
            + cs.knowledge_pairings(ck_h, cH)
            + cs.knowledge_pairings(ck_f, cF)).all())

    sizes = subspace.proof_size_group_elements()
    print(f"=== CPlink N=2^{log_n} on {dev} ===")
    for phase in PHASES:
        bm.print_bm(f"cplink_{phase}", timer.timing_micros(phase))
    print(f"## proof size: {sizes['g1']} G1 + {sizes['g2']} G2 + "
          f"{sizes['fr']} Fr")
    print(f"VERIFY {'OK' if ok else 'FAIL'}", flush=True)
    return {"n": n, "ck_h": ck_h, "ck_f": ck_f, "u": u, "u_ints": u_ints,
            "pin_h": pin_h, "pin_f": pin_f, "vin_h": vin_h, "vin_f": vin_f,
            "sM": sM, "key": key, "w": w, "x": x, "pi": pi, "ok": ok,
            "proof_size": sizes, "times": timer.seconds()}


def main(argv):
    device = "cpu" if "--cpu" in argv else None
    argv = [a for a in argv if a != "--cpu"]
    log_n = int(argv[0]) if argv else 4
    if not run(log_n, device=device)["ok"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main(sys.argv[1:])
