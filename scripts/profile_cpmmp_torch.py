#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's CPmmp prover, phase by phase.

Runs the honest-verifier CPmmp path of `legosnark_tpu_torch` at n = 2^D
on one GPU (data and C = A*B, keygen, commit, prove; the same draws as
`legosnark_tpu_torch/examples/matrixsc.py`), each phase under
`torch.profiler`, and reports per phase: wall seconds, device-busy
seconds (the union of kernel intervals on the card), the device's idle
share, the launches of the port's kernels, and the kernels that took
most device time; the last line is the whole report as JSON.

Usage: python3 scripts/profile_cpmmp_torch.py [D]   (default 10)
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from legosnark_tpu_torch import kernels  # noqa: E402
from legosnark_tpu_torch.examples import matrixsc  # noqa: E402
from legosnark_tpu_torch.gadgets import matrix as cpmat  # noqa: E402
from legosnark_tpu_torch.prototools import mle  # noqa: E402
from legosnark_tpu_torch.utils import rand as lrand  # noqa: E402


def busy_seconds(prof) -> tuple[float, dict]:
    """Union of device kernel intervals (s) and device time by kernel name."""
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t0, t1 = ev.time_range.start, ev.time_range.end
        spans.append((t0, t1))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (t1 - t0) / 1e6
    spans.sort()
    total, cur0, cur1 = 0.0, None, None
    for t0, t1 in spans:
        if cur1 is None or t0 > cur1:
            if cur1 is not None:
                total += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    if cur1 is not None:
        total += cur1 - cur0
    return total / 1e6, by_name


def phase(name, fn, report):
    kernels.reset_launches()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, by_name = busy_seconds(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    report[name] = {"wall_s": wall, "device_busy_s": busy,
                    "idle_share": 1 - busy / wall if wall else None,
                    "launches": dict(kernels.launches),
                    "top_kernels_s": dict(top)}
    print(f"## {name}: wall {wall:.3f}s busy {busy:.3f}s idle "
          f"{report[name]['idle_share']:.3f} launches "
          f"{json.dumps(report[name]['launches'])}", flush=True)
    for k, v in top:
        print(f"##   {v:8.4f}s {k[:90]}", flush=True)
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("profile_cpmmp_torch: no CUDA device", file=sys.stderr)
        return 2
    d = int(argv[0]) if argv else 10
    n = 1 << d
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"# {smi}", flush=True)
    kernels.build()
    report = {"card": smi, "n": n}
    rng = np.random.default_rng(17 + d)

    def data():
        A = matrixsc.rand_fr_mat_fast(rng, n, dev)
        B = matrixsc.rand_fr_mat_fast(rng, n, dev)
        return A, B, mle.matmul_mont(A, B)

    A, B, C = phase("data", data, report)
    key = phase("keygen", lambda: cpmat.keygen(n, seed=1, device=dev), report)
    nonces = cpmat.make_nonces(d, seed=d, device=dev)
    chal = lrand.rand_fr_mont(rng, d, dev)
    hv = {"eq_e": lrand.rand_fr_mont(rng, d, dev),
          "prd_e": lrand.rand_fr_mont(rng, 1, dev)}
    r = lrand.rand_fr_mont(rng, d, dev)
    s = lrand.rand_fr_mont(rng, d, dev)
    phase("commit", lambda: (cpmat.commit_matrix(key, A),
                             cpmat.commit_matrix(key, B)), report)
    phase("prove", lambda: cpmat.prove_output_in_clear(
        key, A, B, C, r, s, nonces, challenges=chal, hv_rand=hv), report)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
