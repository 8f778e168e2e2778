"""The traced run's arithmetic on synthetic intervals, and the G1 bounds
against `chip_smoke.py`'s numbers at 2^20."""
from __future__ import annotations

import pytest

from portbench import harness, roofline, trace


def test_union_and_gaps():
    ivs = [(0, 10, "a"), (5, 20, "b"), (30, 40, "c"), (45, 50, "d")]
    busy, gaps = trace.union_ns(ivs)
    assert busy == 20 + 10 + 5
    assert sorted(gaps) == [(5, "c"), (10, "b")]


def test_union_nested_and_empty():
    assert trace.union_ns([]) == (0, [])
    assert trace.union_ns([(0, 100, "a"), (10, 20, "b")])[0] == 100


class _Span:
    def __init__(self, host, busy, by_name=None, launches=()):
        self.host_s, self.busy_s = host, busy
        self.by_name = by_name or {}
        self.g1_launches = list(launches)
        self.gaps = [(host - busy, "k")]


def _run(spans_by_phase):
    rec = harness.Record(0)
    rec.traces = spans_by_phase
    rec.seconds = {p: s.host_s for p, s in spans_by_phase.items()}
    rec.launches = {p: {} for p in spans_by_phase}
    return trace.Run([rec])


def test_idle_share():
    run = _run({"commit": _Span(1.0, 0.5), "prove": _Span(3.0, 0.5),
                "verify": _Span(2.0, 0.2)})
    assert run.idle_share(("commit", "prove")) == pytest.approx(0.75)
    assert run.idle_share(("verify",)) == pytest.approx(0.9)
    assert run.busy_s() == pytest.approx(1.2)
    assert run.traced_s() == pytest.approx(6.0)


def test_no_device_time_gives_no_idle_share():
    run = _run({"verify": _Span(2.0, 0.0)})
    assert run.idle_share(("verify",)) is None


def test_roofline_bounds_at_2e20():
    n = 1 << 20
    assert roofline.least_seconds("g1_add", n) * 1e3 == pytest.approx(
        0.2317, abs=5e-5)
    assert roofline.least_seconds("g1_double", n) * 1e3 == pytest.approx(
        0.1489, abs=5e-5)
    assert roofline.least_seconds("g1_double", n, 17) == pytest.approx(
        17 * roofline.least_seconds("g1_double", n))


def test_g1_roofline_reader():
    n = 1 << 20
    least = roofline.least_seconds("g1_add", n)
    span = _Span(1.0, 0.5, {"g1_add_kernel(unsigned int const*)": 2 * least,
                            "mont_mul_kernel": 1.0},
                 [("g1_add", n, 1)])
    run = _run({"commit": span, "prove": _Span(1.0, 0.1)})
    value = harness.load_reader("g1_roofline.prove").read(run)
    assert value == pytest.approx(50.0)
    assert harness.load_reader("g1_roofline.prove").read(
        _run({"prove": _Span(1.0, 0.1)})) is None


def test_breakdown_shape():
    run = _run({"prove": _Span(1.0, 0.5, {"k%d" % i: i for i in range(12)})})
    b = run.breakdown()
    assert len(b["device_ops"]) == 10 and b["device_ops"][0] == ["k11", 11]
    assert b["idle_gaps"][0][1] == pytest.approx(0.5)


@pytest.mark.parametrize("name", ["commit_s", "idle.prove", "idle.verify",
                                  "k1_launches.verify", "g1_roofline.prove"])
def test_fs_readers_read_as_their_originals(name):
    n = 1 << 20
    least = roofline.least_seconds("g1_add", n)
    run = _run({"commit": _Span(1.0, 0.5, {"g1_add_kernel": 2 * least},
                                [("g1_add", n, 1)]),
                "prove": _Span(3.0, 0.5), "verify": _Span(2.0, 0.2)})
    run.records[0].launches["verify"] = {"mont_mul": 7}
    want = harness.load_reader(name).read(run)
    assert want is not None
    assert harness.load_reader(f"{name}.fs").read(run) == want


def test_fs_phase_seconds():
    run = _run({"commit": _Span(1.0, 0.5), "prove": _Span(3.0, 0.5),
                "verify": _Span(2.0, 0.2)})
    assert harness.load_reader("prove_s.fs").read(run) == pytest.approx(4.0)
    assert harness.load_reader("verify_s.fs").read(run) == pytest.approx(2.0)
    assert harness.load_reader("prove_s.fs").read(trace.Run([])) is None
