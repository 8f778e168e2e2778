"""Run a cell several times, one process per run, and report each metric's
median and quartile spread (the distance between the first and third
quartiles of `statistics.quantiles(values, n=4)`, as a share of the
median): the numbers a bound is set from.

Usage: python3 portbench/spread.py WORKLOAD SECONDS TRACE SEED [SEED ...]
       [--out FILE] [--control NAME]

Each run's result line and the tail of its standard error go to FILE
(JSON lines; default `chiprun_out/spread.jsonl`).
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values: list):
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else None


def main(argv) -> int:
    opts = {"--out": str(ROOT / "chiprun_out" / "spread.jsonl"),
            "--control": None}
    for opt in opts:
        if opt in argv:
            i = argv.index(opt)
            opts[opt] = argv[i + 1]
            argv = argv[:i] + argv[i + 2:]
    out = Path(opts["--out"])
    control = ["--control", opts["--control"]] if opts["--control"] else []
    workload, seconds, trace, seeds = argv[0], argv[1], argv[2], argv[3:]
    out.parent.mkdir(parents=True, exist_ok=True)
    values, ok = {}, []
    for seed in seeds:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
             workload, "--seed", seed, "--seconds", seconds, "--trace", trace,
             *control],
            capture_output=True, text=True, cwd=ROOT)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        res = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
        with out.open("a") as f:
            f.write(json.dumps({"workload": workload, "seed": seed,
                                "rc": proc.returncode, "wall_s": wall,
                                "result": res,
                                "stderr": proc.stderr[-3000:]}) + "\n")
        print(f"# {workload} seed {seed} rc {proc.returncode} wall "
              f"{wall:.1f}s correct {res and res['correct']}", flush=True)
        if res is None:
            print(proc.stderr[-3000:], flush=True)
            continue
        ok.append(res["correct"])
        print(f"#   {json.dumps(res['metrics'])} compared "
              f"{json.dumps(res['compared'])} statements "
              f"{len(res['statements']['per_statement_s'])}", flush=True)
        for name, m in res["metrics"].items():
            values.setdefault(name, []).append(m["value"])
    for name, vs in values.items():
        print(f"## {workload} {name}: median {statistics.median(vs)!r} "
              f"spread {spread(vs)!r} values {vs!r}", flush=True)
    print(f"## {workload} correct {sum(ok)} of {len(seeds)}", flush=True)
    return 0 if ok and all(ok) and len(ok) == len(seeds) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
