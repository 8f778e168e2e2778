"""The cell `cpmmp_1024.hv` at a tiny size on the CPU: an honest run is correct
and its line keeps the contract's schema; each fault the cell can have,
planted under the timed path, and the cell's control make `correct`
false."""
from __future__ import annotations

import pytest

from portbench.tests import cells

WORKLOAD = "cpmmp_1024.hv"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return cells.tiny_session(WORKLOAD, tmp_path_factory.mktemp("srs"))


def test_honest_run_is_correct(tiny):
    cell, override, session = tiny
    out = cells.run(WORKLOAD, cell, override, session)
    cells.check_line(out, cell)
    assert out["correct"], out["compared"]
    assert out["failed"] == 0


def test_faults_make_correct_false(tiny):
    cell, override, session = tiny
    for name, fault in cell.driver.FAULTS.items():
        out = cells.run(WORKLOAD, cell, override, session, faults=[fault])
        assert not out["correct"], (name, out["compared"])


def test_control_makes_correct_false(tiny):
    cell, override, session = tiny
    out = cells.run(WORKLOAD, cell, override, session,
                    control=cells.CONTROL[WORKLOAD])
    assert not out["correct"], out["compared"]
