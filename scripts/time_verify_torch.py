#!/usr/bin/env python3
"""Seconds of the PyTorch port's honest-verifier CPmmp verify at n = 1024,
five times in one process, on one GPU.

Runs `examples.matrixsc.run(10, fs=False)` once (data, keygen, commit,
prove, verify), then times `gadgets.matrix.verify_output_in_clear` on its
proof five more times, each ending in the verdict. Prints one JSON line:
the checkout's name, the example's phase seconds, the five verify seconds
and the kernel launches of the last verify.

Usage: python3 scripts/time_verify_torch.py [CHECKOUT]
CHECKOUT is a directory holding `legosnark_tpu_torch/` (default: this
repo), so that one copy of the script times two checkouts in turn.
"""
from __future__ import annotations

import json
import os
import sys
import time

REPS = 5


def main(argv) -> int:
    root = os.path.abspath(argv[0] if argv else
                           os.path.dirname(os.path.dirname(__file__)))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("time_verify_torch: no CUDA device", file=sys.stderr)
        return 2
    from legosnark_tpu_torch import kernels
    from legosnark_tpu_torch.examples import matrixsc
    from legosnark_tpu_torch.gadgets import matrix as cpmat

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    res = matrixsc.run(10, device=dev, fs=False)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    ts = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        ok = bool(cpmat.verify_output_in_clear(
            res["key"], res["a_comm"], res["b_comm"], res["C"],
            res["proof"], hv_rand=res["hv"]))
        ts.append(time.perf_counter() - t0)
        if not ok:
            print("time_verify_torch: the proof did not verify",
                  file=sys.stderr)
            return 1
    print(json.dumps({
        "checkout": os.path.basename(root),
        "times": {k: round(v, 3) for k, v in res["times"].items()},
        "verify_s": [round(t, 3) for t in ts],
        "launches": dict(kernels.launches), "setup_s": round(setup, 1)}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
