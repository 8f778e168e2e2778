"""CPmmp example, honest-verifier mode: data, keygen, commit, prove.

Counterpart of the `fs=False` branch of `legosnark_tpu/examples/
matrixsc.py:77-174`. Builds random n x n A, B with C = A*B from the same
seed and in the same draw order as the JAX example (at n >= 16 through
`rand_fr_limbs_fast` and `mle.matmul_mont` on the device, below through
host ints), then runs keygen (seed 1), commits A and B and proves, and
prints `##` timings. Verification needs the pairing, which this package
does not have yet.

Usage: python -m legosnark_tpu_torch.examples.matrixsc [MIN_D] [MAX_D]
       [--cpu]   (n = 2^D per dimension)
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


def run(d: int, device=None) -> dict:
    """CPmmp at n = 2^d; returns inputs, key, commitments, proof, the
    challenges and the phase times in seconds."""
    dev = resolve_device(device)
    n = 1 << d
    rng = np.random.default_rng(17 + d)
    times = {}

    t0 = time.perf_counter()
    if n >= _DEVICE_DATA_MIN_N:
        Am = rand_fr_mat_fast(rng, n, dev)
        Bm = rand_fr_mat_fast(rng, n, dev)
        _sync(dev)
        t1 = time.perf_counter()
        Cm = mle.matmul_mont(Am, Bm)
        _sync(dev)
        times["matmul_s"] = time.perf_counter() - t1
        print(f"## C=A*B on device: {times['matmul_s']:.2f}s", flush=True)
    else:
        Am, A = rand_fr_mat(rng, n, dev)
        Bm, B = rand_fr_mat(rng, n, dev)
        C = matmul_mod(A, B)
        Cm = fl.tensor(np.stack([FR.to_mont_ints(row) for row in C]), dev)
    times["data_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    key = cpmat.keygen(n, seed=1, device=dev)
    _sync(dev)
    times["keygen_s"] = time.perf_counter() - t0

    nonces = cpmat.make_nonces(d, seed=d, device=dev)
    chal = lrand.rand_fr_mont(rng, d, dev)
    hv = {"eq_e": lrand.rand_fr_mont(rng, d, dev),
          "prd_e": lrand.rand_fr_mont(rng, 1, dev)}
    r = lrand.rand_fr_mont(rng, d, dev)
    s = lrand.rand_fr_mont(rng, d, dev)

    t0 = time.perf_counter()
    a_cm = cpmat.commit_matrix(key, Am)
    b_cm = cpmat.commit_matrix(key, Bm)
    _sync(dev)
    times["commit_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    pf = cpmat.prove_output_in_clear(key, Am, Bm, Cm, r, s, nonces,
                                     challenges=chal, hv_rand=hv)
    _sync(dev)
    times["prove_s"] = time.perf_counter() - t0

    print(f"=== CPmmp n={n}x{n} (d={d}) honest-verifier on {dev} ===")
    for phase in ("data", "keygen", "commit", "prove"):
        print(f"## matrix_{phase}_d{d}: {times[phase + '_s']:.3f}s", flush=True)
    print("## verify: needs the pairing, not in this package yet")
    return {"n": n, "A": Am, "B": Bm, "C": Cm, "key": key, "a_comm": a_cm,
            "b_comm": b_cm, "proof": pf, "nonces": nonces, "chal": chal,
            "hv": hv, "r": r, "s": s, "times": times}


def main(argv):
    device = "cpu" if "--cpu" in argv else None
    argv = [a for a in argv if a != "--cpu"]
    min_d = int(argv[0]) if argv else 2
    max_d = int(argv[1]) if len(argv) > 1 else min_d
    for d in range(min_d, max_d + 1):
        run(d, device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
