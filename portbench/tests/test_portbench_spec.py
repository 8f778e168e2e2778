"""The spec and the files it names: every cell, configuration, traffic
mix, driver, reference and metric reader is found by its name, and the
spec keeps to the benchmark's contract."""
from __future__ import annotations

import json
import re

import pytest

from portbench import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 << 10


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cell = harness.find_cell(SPEC, w["name"])
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and NAME.match(w["name"])
    assert len(w["why"]) <= 200
    assert hasattr(cell.driver, "Session") and cell.driver.CONTROLS
    assert (harness.ROOT / "portbench" / "reference"
            / f"{w['config']}.py").exists()
    assert {"pool", "sample"} <= set(cell.traffic)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_configs(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("portbench/configs/")
    cfg = json.loads((harness.ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert any(w["config"] == c["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("m", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metrics(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    else:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        reader = harness.load_reader(m["name"])
        assert callable(reader.read)
    if m["name"].endswith("_roofline") or ".roofline" in m["name"] \
            or "_roofline." in m["name"]:
        assert m["unit"] == "%"


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_where_read(m):
    """A per-layer metric is read only in cells that report the end-to-end
    metric it moves, and each cell that reports a metric has a reader."""
    e2e = {e["name"]: e for e in SPEC["end_to_end"]}[m["moves"]]
    cells = {w["name"] for w in SPEC["workloads"]}
    read = set(m.get("workloads", cells))
    assert read <= cells
    assert read <= set(e2e.get("workloads", cells))
