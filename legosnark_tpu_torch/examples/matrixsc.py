"""CPmmp example: data, keygen, commit, prove, verify.

Counterpart of `legosnark_tpu/examples/matrixsc.py:77-208`. Builds random
n x n A, B with C = A*B from the same seed and in the same draw order as
the JAX example (at n >= 16 through `rand_fr_limbs_fast` and
`mle.matmul_mont` on the device, below through host ints), then runs
keygen (seed 1), commits A and B, proves that C = A*B with C public, and
verifies. Fiat-Shamir is the default: r, s and every sumcheck challenge
come from the transcript. `--hv` selects the honest-verifier mode, whose
challenges are drawn from the seed after keygen, as in the JAX example.
Prints `##` timings, the proof size and VERIFY OK or VERIFY FAIL (exit
code 1).

Usage: python -m legosnark_tpu_torch.examples.matrixsc [MIN_D] [MAX_D]
       [--hv] [--cpu]   (n = 2^D per dimension)
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..config import resolve_device
from ..curve import bn254
from ..fields import limb as fl
from ..gadgets import matrix as cpmat
from ..prototools import mle
from ..utils import rand as lrand

FR = bn254.FR

#: from this n on, the inputs are sampled by limbs and C = A*B runs on
#: the device; below, host ints give the known answer
_DEVICE_DATA_MIN_N = 16


def rand_fr_mat(rng, n, device):
    """[n, 8, n] random Montgomery matrix and its int rows."""
    rows = [[lrand.rand_fr_int(rng) for _ in range(n)] for _ in range(n)]
    arr = np.stack([FR.to_mont_ints(row) for row in rows])
    return fl.tensor(arr, device), rows


def rand_fr_mat_fast(rng, n, device):
    """[n, 8, n] random Montgomery matrix from limb sampling."""
    limbs = lrand.rand_fr_limbs_fast(rng, n * n)           # [8, n*n]
    arr = np.moveaxis(limbs.reshape(limbs.shape[0], n, n), 1, 0)
    return fl.to_mont(FR, fl.tensor(arr, device))


def matmul_mod(A, B):
    """Host int matmul mod r."""
    return [[sum(a * b for a, b in zip(row, col)) % bn254.R
             for col in zip(*B)] for row in A]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_data(rng, n: int, device):
    """A, B and C = A*B as [n, 8, n] Montgomery matrices, in the JAX
    example's draws, and the seconds of C = A*B on the device (None where
    host ints computed C)."""
    if n < _DEVICE_DATA_MIN_N:
        Am, A = rand_fr_mat(rng, n, device)
        Bm, B = rand_fr_mat(rng, n, device)
        C = matmul_mod(A, B)
        return Am, Bm, fl.tensor(np.stack([FR.to_mont_ints(row) for row in C]),
                                 device), None
    Am = rand_fr_mat_fast(rng, n, device)
    Bm = rand_fr_mat_fast(rng, n, device)
    _sync(device)
    t0 = time.perf_counter()
    Cm = mle.matmul_mont(Am, Bm)
    _sync(device)
    return Am, Bm, Cm, time.perf_counter() - t0


def run(d: int, device=None, fs: bool = True) -> dict:
    """CPmmp at n = 2^d, Fiat-Shamir unless fs=False; returns inputs, key,
    commitments, proof, the challenges, `ok`, `proof_size` (group and
    field elements) and the phase times in seconds (`verify_s` among
    them)."""
    dev = resolve_device(device)
    n = 1 << d
    rng = np.random.default_rng(17 + d)
    times = {}

    t0 = time.perf_counter()
    Am, Bm, Cm, matmul_s = make_data(rng, n, dev)
    if matmul_s is not None:
        times["matmul_s"] = matmul_s
        print(f"## C=A*B on device: {matmul_s:.2f}s", flush=True)
    times["data_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    key = cpmat.keygen(n, seed=1, device=dev)
    _sync(dev)
    times["keygen_s"] = time.perf_counter() - t0

    nonces = cpmat.make_nonces(d, seed=d, device=dev)
    out = {"n": n, "A": Am, "B": Bm, "C": Cm, "key": key, "nonces": nonces}
    if not fs:
        out["chal"] = lrand.rand_fr_mont(rng, d, dev)
        out["hv"] = {"eq_e": lrand.rand_fr_mont(rng, d, dev),
                     "prd_e": lrand.rand_fr_mont(rng, 1, dev)}
        out["r"] = lrand.rand_fr_mont(rng, d, dev)
        out["s"] = lrand.rand_fr_mont(rng, d, dev)

    t0 = time.perf_counter()
    a_cm = cpmat.commit_matrix(key, Am)
    b_cm = cpmat.commit_matrix(key, Bm)
    _sync(dev)
    times["commit_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if fs:
        pf = cpmat.prove_output_in_clear_fs(key, Am, Bm, Cm, a_cm, b_cm,
                                            nonces)
    else:
        pf = cpmat.prove_output_in_clear(
            key, Am, Bm, Cm, out["r"], out["s"], nonces,
            challenges=out["chal"], hv_rand=out["hv"])
    _sync(dev)
    times["prove_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if fs:
        ok = cpmat.verify_output_in_clear_fs(key, a_cm, b_cm, Cm, pf)
    else:
        ok = cpmat.verify_output_in_clear(key, a_cm, b_cm, Cm, pf,
                                          hv_rand=out["hv"])
    ok = bool(ok)                      # reads the result: a sync
    times["verify_s"] = time.perf_counter() - t0

    mode = "fiat-shamir" if fs else "honest-verifier"
    sizes = cpmat.proof_size_group_elements(key)
    print(f"=== CPmmp n={n}x{n} (d={d}) {mode} on {dev} ===")
    for phase in ("data", "keygen", "commit", "prove", "verify"):
        print(f"## matrix_{phase}_d{d}: {times[phase + '_s']:.3f}s", flush=True)
    print(f"## proof size: {sizes['g1']} G1 + {sizes['g2']} G2 + "
          f"{sizes['fr']} Fr")
    print(f"VERIFY {'OK' if ok else 'FAIL'}", flush=True)
    out.update({"a_comm": a_cm, "b_comm": b_cm, "proof": pf, "ok": ok,
                "times": times, "proof_size": sizes})
    return out


def main(argv):
    flags = {"--cpu", "--hv"}
    device = "cpu" if "--cpu" in argv else None
    fs = "--hv" not in argv
    argv = [a for a in argv if a not in flags]
    min_d = int(argv[0]) if argv else 2
    max_d = int(argv[1]) if len(argv) > 1 else min_d
    for d in range(min_d, max_d + 1):
        if not run(d, device=device, fs=fs)["ok"]:
            raise SystemExit(1)


if __name__ == "__main__":
    main(sys.argv[1:])
