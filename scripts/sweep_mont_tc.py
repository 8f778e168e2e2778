#!/usr/bin/env python3
"""P1b (`legosnark_tpu_torch/csrc/mont_tc.cu`) against another checkout's
P1b, with K1 (`csrc/mont_mul.cu`) beside both, on one card: device times
at 2^20 elements.

This tree's P1b and K1 run through their wrappers
(`probes.mont_variants.mont_mul_tc`, `fields.cuda_limb.mont_mul`). The
other checkout is only read: its `mont_tc.cu` and the headers beside it
are copied into `build/sweep_tc/<pid>/` and built there by one `nvcc`,
and it is fed the [96, 32] byte Toeplitz table of the first design
(`toeplitz_bytes`). Both P1b must equal K1 on Fr and Fq at 2^20 (random
values in [0, 2p) and the edge values). Times: device ms per call
(`utils.bench.launch_us`), three rounds in alternating order.

Usage: python3 scripts/sweep_mont_tc.py --parent CHECKOUT
(needs one CUDA card)
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

N = 1 << 20
ROUNDS = 3


def _build_parent(kernels, checkout: str):
    """The checkout's lsk_mont_mul_tc, built from copies of its sources."""
    csrc = os.path.join(checkout, "legosnark_tpu_torch", "csrc")
    work = kernels.BUILD_DIR.parent / "sweep_tc" / str(os.getpid())
    work.mkdir(parents=True, exist_ok=True)
    for name in os.listdir(csrc):
        if name == "mont_tc.cu" or name.endswith(".cuh"):
            shutil.copy(os.path.join(csrc, name), work / name)
    lib = work / "libmont_tc_parent.so"
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                           str(lib), str(work / "mont_tc.cu")],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the parent's mont_tc.cu:\n{log}")
    info = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"# ptxas parent P1b: {'; '.join(info)}")
    fn = ctypes.CDLL(str(lib)).lsk_mont_mul_tc
    fn.argtypes = kernels._SIGNATURES["lsk_mont_mul_tc"]
    fn.restype = ctypes.c_int
    return fn


def main(argv) -> int:
    import numpy as np
    import torch

    if "--parent" not in argv:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("sweep_mont_tc: no CUDA device", file=sys.stderr)
        return 2
    from legosnark_tpu_torch import kernels
    from legosnark_tpu_torch.curve import bn254
    from legosnark_tpu_torch.fields import cuda_limb
    from legosnark_tpu_torch.fields import limb as fl
    from legosnark_tpu_torch.probes import mont_variants as mv
    from legosnark_tpu_torch.utils.bench import (edge_ints, launch_us,
                                                 rand_below, word_err)

    parent_fn = _build_parent(kernels, argv[argv.index("--parent") + 1])
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def parent(spec, a, b):
        out = torch.empty_like(a)
        err = parent_fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                        a.shape[-1], a.numel() // fl.NLIMBS,
                        mv._toeplitz(spec.p, dev).data_ptr(), stream)
        if err:
            raise RuntimeError(f"parent P1b launch failed ({err})")
        return out

    fns = {"K1": cuda_limb.mont_mul, "P1b": mv.mont_mul_tc,
           "parent P1b": parent}
    rng = np.random.default_rng(7)
    ok = True
    for spec in (bn254.FR, bn254.FQ):
        p = spec.p
        xs = edge_ints(p) + rand_below(rng, N - 7, 2 * p)
        ys = edge_ints(p)[::-1] + rand_below(rng, N - 7, 2 * p)
        a = fl.tensor(fl.ints_to_limbs(xs), dev)
        b = fl.tensor(fl.ints_to_limbs(ys), dev)
        k1 = cuda_limb.mont_mul(spec, a, b)
        for name in ("P1b", "parent P1b"):
            err = word_err(fns[name](spec, a, b), k1)
            ok &= err == 0
            print(f"# {name} {spec.name}: max_abs_err against K1 {err}")
        if spec is bn254.FR:
            fr = (a, b)
    a, b = fr
    times = {name: [] for name in fns}
    for rnd in range(ROUNDS):
        for name in (list(fns) if rnd % 2 == 0 else list(fns)[::-1]):
            times[name].append(launch_us(
                lambda: fns[name](bn254.FR, a, b), dev)[0] / 1e3)
    for name, ts in times.items():
        print(f"# {name} 2^20 Fr device ms: " + " ".join(f"{t:.4f}" for t in ts))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
