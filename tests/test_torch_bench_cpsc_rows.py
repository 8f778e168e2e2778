"""The rows of `legosnark_tpu_torch.bench_gadgets.main` for CPsc at
`--scale 1/8` (2 variables) on the plain path: keygen (a miss in a fresh
SRS directory), then commit, prove and verify each as a cold and a warm
call, with the keys `bench_gadgets.py` recorded (BENCH_GADGETS.json) and
verify true. `test_torch_bench_cpsc.py` holds the proof against host
ints and the tampers; this file runs the bench's cold and warm pair of
calls, the costly part, on a test worker of its own.
"""
import json
import pathlib

import torch

from legosnark_tpu_torch import bench_gadgets as bg

# The plain path runs many small torch ops; idle intra-op threads spin and
# starve the other test processes, so the port's tests use one thread.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCALE = "1/8"          # max(2, round(16 / 8)) = 2 variables


def test_cpsc_rows_carry_the_jax_benchmarks_keys_and_verify(tmp_path):
    out = tmp_path / "rows.json"
    with torch.inference_mode():
        res = bg.main(["cpsc", "--scale", SCALE, "--cpu", "--out", str(out),
                       "--srs-cache", str(tmp_path / "srs")])
    rows = json.loads(out.read_text())
    jax_rows = json.loads((ROOT / "BENCH_GADGETS.json").read_text())
    want = {r["phase"]: set(r) for r in jax_rows if r["config"] == "cpsc_16var"}
    assert {r["config"] for r in rows} == {"cpsc_2var"} == set(res)
    assert {r["phase"]: set(r) for r in rows} == want
    assert [r["phase"] for r in rows] == ["keygen", "commit", "prove", "verify"]
    assert rows[0]["srs_cache_hit"] is False
    assert rows[-1]["ok"] is True and res["cpsc_2var"]["ok"]
