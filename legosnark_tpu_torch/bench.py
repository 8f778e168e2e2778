"""G1 MSM throughput, the north-star metric of `BASELINE.json`.

Counterpart of `bench.py` and `scripts/bench_one.py`. Inputs are distinct:
scalars s_i drawn by `rand_fr_limbs_fast`, and points k_i * G made from a
second scalar vector by one fixed-base batch multiplication (c = 8), then
made affine, the bases libff's `multi_exp_with_mixed_addition` works on.
The MSM is timed by the host clock around work that ends in
`torch.cuda.synchronize`: two untimed calls (the first one's seconds are
reported as `first_call_s`), then `reps` timed calls.

Prints one JSON line per size, {"metric", "value", "unit", "first_call_s",
"vs_baseline"}, and as the last line the headline {"metric", "value",
"unit", "vs_baseline"} of the largest size.

vs_baseline is the rate over BASELINE_POINTS_PER_SEC: the reference
publishes no numbers (BASELINE.md), so the anchor is the measured order of
magnitude of libff's OpenMP `multiExpMA` on a multicore server CPU for 2^20
points, ~1e6 points/s.

Usage: python -m legosnark_tpu_torch.bench [--quick] [--cpu] [LOG_N C REPS]
  default 2^18 and 2^20 at c = 16 with 3 reps; --quick 2^8 at c = 6 with 2
  reps; LOG_N C REPS one size (C defaults to 16 and REPS to 3)
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from .config import resolve_device
from .curve import msm
from .curve.group import G1, to_affine_batch
from .fields import limb as fl
from .utils import rand as lrand

BASELINE_POINTS_PER_SEC = 1.0e6
DEFAULT_SIZES = ((18, 16, 3), (20, 16, 3))
QUICK_SIZES = ((8, 6, 2),)
#: LOG_N, C, REPS of a single size where the command line leaves them out
ONE_SIZE = (20, 16, 3)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_msm(log_n: int, c: int, reps: int, device=None) -> dict:
    """The MSM of 2^log_n distinct points at window c -> {'points_per_sec',
    'first_call_s', 'seconds' (mean of the timed calls), 'out' (the last
    call's point), 'k' and 's' (the points' discrete logs and the scalars
    as host ints: out = (sum k_i s_i) G)}."""
    dev = resolve_device(device)
    n = 1 << log_n
    rng = np.random.default_rng(0)
    s_np = lrand.rand_fr_limbs_fast(rng, n)
    k_np = lrand.rand_fr_limbs_fast(rng, n)
    scalars = fl.tensor(s_np, dev)
    points = msm.batch_scalar_mul(G1, msm.generator_table(G1, dev),
                                  fl.tensor(k_np, dev), c=8)
    points = to_affine_batch(G1, points)
    _sync(dev)

    def call():
        out = msm.msm(G1, points, scalars, c=c)
        _sync(dev)
        return out

    t0 = time.perf_counter()
    call()
    first_call_s = time.perf_counter() - t0
    call()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = call()
    dt = (time.perf_counter() - t0) / reps
    return {"points_per_sec": n / dt, "first_call_s": first_call_s,
            "seconds": dt, "out": out, "k": list(fl.limbs_to_ints(k_np)),
            "s": list(fl.limbs_to_ints(s_np))}


def size_line(log_n: int, res: dict) -> dict:
    """The per-size line of `bench.py`, with `first_call_s` in place of
    `compile_s`."""
    pps = res["points_per_sec"]
    return {"metric": f"g1_msm_points_per_sec_2e{log_n}",
            "value": round(pps, 1), "unit": "points/sec",
            "first_call_s": round(res["first_call_s"], 3),
            "vs_baseline": round(pps / BASELINE_POINTS_PER_SEC, 4)}


def headline(results: dict) -> dict:
    """The last line: the rate of the largest size that ran."""
    top = max(results)
    pps = results[top]["points_per_sec"]
    return {"metric": f"g1_msm_points_per_sec_2e{top}",
            "value": round(pps, 1), "unit": "points/sec",
            "vs_baseline": round(pps / BASELINE_POINTS_PER_SEC, 4)}


def main(argv) -> dict:
    """Runs the sizes the arguments name and prints their lines; returns
    {log_n: run_msm's result}."""
    device = "cpu" if "--cpu" in argv else None
    dev = resolve_device(device)
    args = [int(a) for a in argv if a not in ("--cpu", "--quick")]
    if args:
        sizes = (tuple(args) + ONE_SIZE[len(args):],)
    else:
        sizes = QUICK_SIZES if "--quick" in argv else DEFAULT_SIZES
    results = {}
    for log_n, c, reps in sizes:
        results[log_n] = run_msm(log_n, c, reps, dev)
        print(json.dumps(size_line(log_n, results[log_n])), flush=True)
    print(json.dumps(headline(results)), flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
