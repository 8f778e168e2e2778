"""One short run of a cell on the card through `run.py` itself: the
result line's schema and `correct`. Needs a CUDA card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import cells


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (portbench runs on the card only)")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_run_py_on_the_card(card, trace):
    proc = subprocess.run(
        [sys.executable, str(harness.ROOT / "portbench" / "run.py"),
         "--workload", "cpmmp_1024.hv", "--seed", str(cells.SEED),
         "--seconds", "1", "--trace", str(trace)],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    cell = harness.find_cell(harness.load_spec(), "cpmmp_1024.hv")
    cells.check_line(out, cell, traced=bool(trace))
    assert out["correct"] and out["device"]["platform"] == "gpu"
    if trace:
        assert out["device"]["busy_s"] > 0
