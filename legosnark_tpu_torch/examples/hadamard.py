"""Hadamard example: both Hadamard-product schemes on u o u = u^2.

Counterpart of `legosnark_tpu/examples/hadamard.py`. For each d, with
n = 2^d: `hadlipmaa` runs CPhadL (keygen, the commitments of u, u and
u^2, prove, verify) on data drawn from seed 41 + d, then `hadsc` runs
CPhad in the Fiat-Shamir mode (keygen, the commitments of u and u^2,
prove, verify) on data drawn from seed 31 + d; both keygens take seed d.
Prints one `##` line of seconds per phase (`utils.benchmark`: a host clock
around work that ends in `torch.cuda.synchronize()` or reads a verdict) and
`VERIFY lipmaa OK|FAIL | hadsc OK|FAIL`; exits 1 on a FAIL.

Usage: python -m legosnark_tpu_torch.examples.hadamard [MIN_D] [MAX_D]
       [--cpu]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import resolve_device
from ..curve import bn254
from ..curve.group import point_map
from ..fields import limb as fl
from ..gadgets import hadamard as cphad
from ..gadgets import lipmaa
from ..utils import rand as lrand
from ..utils.benchmark import Benchmarkable

FR = bn254.FR
PHASES = ("lip_keygen", "lip_commit", "lip_prove", "lip_verify",
          "had_keygen", "had_commit", "had_prove", "had_verify")


def vec_pair(rng, n, device):
    """(u, u^2) as Montgomery [8, n] tensors."""
    u = lrand.rand_fr_ints(rng, n)
    sq = [x * x % bn254.R for x in u]
    return (fl.tensor(FR.to_mont_ints(u), device),
            fl.tensor(FR.to_mont_ints(sq), device))


def hadlipmaa(d: int, dev, timer: Benchmarkable) -> dict:
    n = 1 << d
    rng = np.random.default_rng(41 + d)
    um, sqm = vec_pair(rng, n, dev)
    with timer.phase("lip_keygen") as out:
        key = lipmaa.keygen(n, d, dev)
        out.append(key)
    ds = lrand.rand_fr_mont(rng, 3, dev)      # the commitments' r: d1, d2, d3
    with timer.phase("lip_commit") as out:
        # the three commitments in one call: [3, ..] rows of u, u, u^2
        cms = lipmaa.commit(key.interp, torch.stack([um, um, sqm]),
                            ds.T[:, :, None])
        out.append(cms)
    ca, cb, cc = (lipmaa.InterpComm(*(point_map(lambda x, i=i: x[i], p)
                                      for p in cms)) for i in range(3))
    with timer.phase("lip_prove") as out:
        pi = lipmaa.prove(key, um, um, sqm, ds)
        out.append(pi)
    with timer.phase("lip_verify"):
        ok = bool(lipmaa.verify(key, ca, cb, cc, pi))
    return {"u": um, "sq": sqm, "key": key, "ds": ds, "comms": (ca, cb, cc),
            "pi": pi, "ok": ok}


def hadsc(d: int, dev, timer: Benchmarkable) -> dict:
    n = 1 << d
    rng = np.random.default_rng(31 + d)
    um, sqm = vec_pair(rng, n, dev)
    with timer.phase("had_keygen") as out:
        key = cphad.keygen(n, d, dev)
        out.append(key)
    with timer.phase("had_commit") as out:
        a_cm, c_cm = (cphad.commit_vec(key, v) for v in (um, sqm))
        out.append((a_cm, c_cm))
    nonces = cphad.make_nonces(d, seed=d, device=dev)
    with timer.phase("had_prove") as out:
        pf = cphad.prove_fs(key, um, um, sqm, a_cm, a_cm, c_cm, nonces)
        out.append(pf)
    with timer.phase("had_verify"):
        ok = bool(cphad.verify_fs(key, a_cm, a_cm, c_cm, pf))
    return {"u": um, "sq": sqm, "key": key, "nonces": nonces,
            "comms": (a_cm, c_cm), "proof": pf, "ok": ok}


def run(d: int, device=None) -> dict:
    """Both schemes at n = 2^d -> {'lipmaa': ..., 'hadsc': ..., 'times',
    'ok'}: each scheme's data, key, commitments, proof and verdict."""
    dev = resolve_device(device)
    timer = Benchmarkable(f"hadamard_{d}")
    lip = hadlipmaa(d, dev, timer)
    had = hadsc(d, dev, timer)
    times = timer.seconds()
    print(f"=== Hadamard d={d} (n={1 << d}) on {dev} ===")
    for phase in PHASES:
        print(f"## {phase}_d{d}: {times[phase]:.3f}s", flush=True)
    print(f"VERIFY lipmaa {'OK' if lip['ok'] else 'FAIL'} | "
          f"hadsc {'OK' if had['ok'] else 'FAIL'}", flush=True)
    return {"lipmaa": lip, "hadsc": had, "times": times,
            "ok": lip["ok"] and had["ok"]}


def main(argv):
    device = "cpu" if "--cpu" in argv else None
    argv = [a for a in argv if a != "--cpu"]
    min_d = int(argv[0]) if argv else 3
    max_d = int(argv[1]) if len(argv) > 1 else min_d
    for d in range(min_d, max_d + 1):
        if not run(d, device=device)["ok"]:
            raise SystemExit(1)


if __name__ == "__main__":
    main(sys.argv[1:])
