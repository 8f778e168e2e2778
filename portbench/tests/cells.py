"""Shared pieces of the cell tests: a tiny CPU session per cell and the
check of a result line's schema."""
from __future__ import annotations

import json

import torch

from portbench import harness

SEED = 2**31 + 12345
#: the cells' configurations cut to what a CPU test can hold
TINY = {"cpmmp_1024": {"n": 4}, "groth16_mm64": {"n": 2}}


def tiny_session(workload: str, cache_dir):
    cell = harness.find_cell(harness.load_spec(), workload)
    override = {**TINY[cell.config["name"]], "srs_cache_dir": str(cache_dir)}
    return cell, override, harness.setup(cell, SEED, torch.device("cpu"),
                                         override)


def run(workload: str, cell, override, session, **kw) -> dict:
    return harness.run_cell(workload, SEED, 0.01, False, device="cpu",
                            config_override=override, session=session, **kw)


def check_line(out: dict, cell, traced: bool = False) -> None:
    """The result line's keys as the benchmark's contract names them."""
    line = json.loads(json.dumps(out))
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "compared"
    assert isinstance(line["correct"], bool) and line["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    want = {m["name"] for m in (cell.per_layer if traced else cell.end_to_end)}
    if not traced:
        assert set(line["metrics"]) == want
    on_card = line["device"]["platform"] == "gpu"
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"}
        assert m["value"] > 0 or (name == "peak_gib" and not on_card)
    for c in line["compared"].values():
        assert set(c) == {"value", "limit"}

#: the control each cell is held to
CONTROL = {"cpmmp_1024.fs": "transcript_half_output",
           "cpmmp_1024.hv": "verifier_without_pairings",
           "groth16_mm64.session": "unblinded_prover"}
