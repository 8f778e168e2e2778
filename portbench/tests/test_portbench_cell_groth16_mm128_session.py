"""The cell `groth16_mm128.session` at a tiny size on the CPU (n = 2), with
a window budget that splits prove's three MSMs into chunks, as n = 128's
own budget does on the card: an honest run is correct and its line keeps
the contract's schema; each fault the cell can have (the dropped chunk
among them), planted under the timed path, and the cell's control make
`correct` false. The budget is `curve.msm.WINDOW_BUDGET` forced to eight
G2 windows of its MSM. About 9 minutes on 8 CPU cores:
`python -m pytest portbench/tests/test_portbench_cell_groth16_mm128_session.py`."""
from __future__ import annotations

import pytest
import torch

from legosnark_tpu_torch import config
from legosnark_tpu_torch.curve import bn254, msm
from legosnark_tpu_torch.curve.group import G1, G2

from portbench import harness
from portbench.tests import cells

WORKLOAD = "groth16_mm128.session"
TINY = {"n": 2}


def _chunks(session) -> list:
    """Chunks of prove's three MSMs under the budget in force."""
    pk = session.pk
    cols = pk.a_query.x.shape[-1] + 1                 # z | r, z | s
    c_cols = pk.l_query.x.shape[-1] + pk.h_query.x.shape[-1] + 3
    out = []
    for C, lead, m in ((G1, (2,), cols), (G2, (), cols), (G1, (), c_cols)):
        W = -(-(bn254.FR.bits + 1) // config.default_window(m))
        out.append(-(-W // msm.windows_per_chunk(C, W, lead, m)))
    return out


@pytest.fixture(scope="module")
def tiny():
    cell = harness.find_cell(harness.load_spec(), WORKLOAD)
    with pytest.MonkeyPatch.context() as mp:
        session = harness.setup(cell, cells.SEED, torch.device("cpu"), TINY)
        cols = session.pk.a_query.x.shape[-1] + 1
        mp.setattr(msm, "WINDOW_BUDGET", 8 * msm.window_bytes(G2, (), cols))
        assert min(_chunks(session)) > 1
        yield cell, TINY, session


def test_honest_run_is_correct(tiny):
    cell, override, session = tiny
    out = cells.run(WORKLOAD, cell, override, session)
    cells.check_line(out, cell)
    assert out["correct"], out["compared"]
    assert out["failed"] == 0


def test_faults_make_correct_false(tiny):
    cell, override, session = tiny
    assert "chunk_dropped" in cell.driver.FAULTS
    for name, fault in cell.driver.FAULTS.items():
        out = cells.run(WORKLOAD, cell, override, session, faults=[fault])
        assert not out["correct"], (name, out["compared"])


def test_control_makes_correct_false(tiny):
    cell, override, session = tiny
    out = cells.run(WORKLOAD, cell, override, session,
                    control="unblinded_prover")
    assert not out["correct"], out["compared"]
