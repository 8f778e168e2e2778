"""Run one cell of the port's benchmark and print its result line.

Usage (from the root of a checkout, on a machine with the cell's cards):

    python3 portbench/run.py --workload cpmmp_1024.fs --seed 7 \
        --seconds 51 --trace 0

Finds the cell in `BENCHMARK.json`, sets up its sessions (kernels from
`build/kernels/`, the SRS from `srs_cache/`, both inside the checkout),
runs the closed-loop window, checks a sample of the window's statements
against the plain reference and prints one JSON object as the last line
of standard output: the cell's end-to-end metrics with `--trace 0`, its
per-layer metrics with `--trace 1`. The numbers compared for `correct`
end standard error, each beside its limit, and end the result line under
`compared`. `--control NAME` plants one of the driver's controls under
the timed path (never used by the benchmark's own runs).
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache of the program inside the checkout, at a fixed path
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"
# one process with one compute thread: the port's host work is a single
# dispatch thread, and idle OpenMP workers only contend with it
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, str(ROOT))


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None)
    args = ap.parse_args(argv)

    if not (ROOT / "legosnark_tpu_torch").is_dir():
        print("portbench: the port (legosnark_tpu_torch/) is not in this "
              "checkout", file=sys.stderr)
        return 2
    import torch

    from portbench import harness

    torch.set_num_threads(1)

    spec = harness.load_spec()
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}.get(
        args.workload)
    if chips is None:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), t_process=T_PROCESS,
                           control=args.control)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    for name, c in out["compared"].items():
        print(f"portbench: {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
