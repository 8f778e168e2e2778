"""Hadamard example: both Hadamard-product schemes on u o u = u^2.

Counterpart of `legosnark_tpu/examples/hadamard.py`. For each d, with
n = 2^d: `hadlipmaa` runs CPhadL (keygen, the commitments of u, u and
u^2, prove, verify) on data drawn from seed 41 + d, then `hadsc` runs
CPhad in the Fiat-Shamir mode (keygen, the commitments of u and u^2,
prove, verify) on data drawn from seed 31 + d; both keygens take seed d.
Prints one `##` line of seconds per phase (a host clock around work that
ends in `torch.cuda.synchronize()` or reads a verdict) and
`VERIFY lipmaa OK|FAIL | hadsc OK|FAIL`; exits 1 on a FAIL.

Usage: python -m legosnark_tpu_torch.examples.hadamard [MIN_D] [MAX_D]
       [--cpu]
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..config import resolve_device
from ..curve import bn254
from ..curve.group import point_map
from ..fields import limb as fl
from ..gadgets import hadamard as cphad
from ..gadgets import lipmaa
from ..utils import rand as lrand

FR = bn254.FR
PHASES = ("lip_keygen", "lip_commit", "lip_prove", "lip_verify",
          "had_keygen", "had_commit", "had_prove", "had_verify")


def vec_pair(rng, n, device):
    """(u, u^2) as Montgomery [8, n] tensors."""
    u = lrand.rand_fr_ints(rng, n)
    sq = [x * x % bn254.R for x in u]
    return (fl.tensor(FR.to_mont_ints(u), device),
            fl.tensor(FR.to_mont_ints(sq), device))


class _Timer:
    """Seconds per phase, each ending in a device synchronization."""

    def __init__(self, device):
        self.device = device
        self.times = {}

    def __call__(self, name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.times[name] = time.perf_counter() - t0
        return out


def hadlipmaa(d: int, timer: _Timer) -> dict:
    dev = timer.device
    n = 1 << d
    rng = np.random.default_rng(41 + d)
    um, sqm = vec_pair(rng, n, dev)
    key = timer("lip_keygen", lipmaa.keygen, n, d, dev)
    ds = lrand.rand_fr_mont(rng, 3, dev)      # the commitments' r: d1, d2, d3
    # the three commitments in one call: [3, ..] rows of u, u, u^2
    cms = timer("lip_commit", lipmaa.commit, key.interp,
                torch.stack([um, um, sqm]), ds.T[:, :, None])
    ca, cb, cc = (lipmaa.InterpComm(*(point_map(lambda x, i=i: x[i], p)
                                      for p in cms)) for i in range(3))
    pi = timer("lip_prove", lipmaa.prove, key, um, um, sqm, ds)
    ok = timer("lip_verify", lambda: bool(lipmaa.verify(key, ca, cb, cc, pi)))
    return {"u": um, "sq": sqm, "key": key, "ds": ds, "comms": (ca, cb, cc),
            "pi": pi, "ok": ok}


def hadsc(d: int, timer: _Timer) -> dict:
    dev = timer.device
    n = 1 << d
    rng = np.random.default_rng(31 + d)
    um, sqm = vec_pair(rng, n, dev)
    key = timer("had_keygen", cphad.keygen, n, d, dev)
    a_cm, c_cm = timer("had_commit", lambda: [
        cphad.commit_vec(key, v) for v in (um, sqm)])
    nonces = cphad.make_nonces(d, seed=d, device=dev)
    pf = timer("had_prove", cphad.prove_fs, key, um, um, sqm, a_cm, a_cm,
               c_cm, nonces)
    ok = timer("had_verify", lambda: bool(
        cphad.verify_fs(key, a_cm, a_cm, c_cm, pf)))
    return {"u": um, "sq": sqm, "key": key, "nonces": nonces,
            "comms": (a_cm, c_cm), "proof": pf, "ok": ok}


def run(d: int, device=None) -> dict:
    """Both schemes at n = 2^d -> {'lipmaa': ..., 'hadsc': ..., 'times',
    'ok'}: each scheme's data, key, commitments, proof and verdict."""
    timer = _Timer(resolve_device(device))
    lip = hadlipmaa(d, timer)
    had = hadsc(d, timer)
    print(f"=== Hadamard d={d} (n={1 << d}) on {timer.device} ===")
    for phase in PHASES:
        print(f"## {phase}_d{d}: {timer.times[phase]:.3f}s", flush=True)
    print(f"VERIFY lipmaa {'OK' if lip['ok'] else 'FAIL'} | "
          f"hadsc {'OK' if had['ok'] else 'FAIL'}", flush=True)
    return {"lipmaa": lip, "hadsc": had, "times": timer.times,
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
