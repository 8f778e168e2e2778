"""The port's spans and counters (`utils/trace.py`) on the CPU, and one
card case for their clock.

* Off, `span` hands out the shared no-op and nothing is recorded.
* On, spans nest with parent ids, self time is the span's length less
  its children's, the rise of K1-K3's launch counters and the span
  counters are recorded per span, and `spanned` and
  `Benchmarkable.phase` open spans.
* `kernels.count` records exact widths and K3's `times`.
* The transcript, the NTT, the MSM and the fixed-base batch emit their
  spans and chunk counters at small sizes, and their challenges and
  outputs are bit-identical with tracing on and off. (The pairing, sumcheck, sigma and Groth16 spans are held on the
  module fixtures of `test_torch_verify.py` and `test_torch_groth16.py`,
  which run traced.)
* On a card (`requires_cuda`): a span around one lone K1 launch and a
  synchronize holds the kernel's profiler interval to within 50 us, 20
  times out of 20. This file imports nothing of JAX:
      python -m pytest tests/test_torch_trace.py --noconftest -m requires_cuda
"""
import time

import pytest
import torch

from legosnark_tpu_torch import kernels
from legosnark_tpu_torch.curve import bn254, msm
from legosnark_tpu_torch.curve.group import G1, g1_generator
from legosnark_tpu_torch.fields import limb as fl
from legosnark_tpu_torch.prototools import ntt
from legosnark_tpu_torch.utils import trace
from legosnark_tpu_torch.utils.benchmark import Benchmarkable
from legosnark_tpu_torch.utils.transcript import Transcript

# The plain path runs many small torch ops; idle intra-op threads spin and
# starve the other test processes, so the port's tests use one thread.
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture
def traced():
    """Tracing on for the test's body; its spans are drained after."""
    trace.drain()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.drain()


def _traced_call(fn):
    """(fn(), the spans it opened) with tracing on."""
    trace.drain()
    trace.enable()
    try:
        out = fn()
    finally:
        trace.disable()
    return out, trace.drain()


def test_off_hands_out_the_shared_noop_and_records_nothing():
    trace.disable()
    trace.drain()
    s = trace.span("x", size=3)
    assert s is trace.OFF and trace.span("y") is trace.OFF
    with s as inner:
        assert inner is trace.OFF
        trace.count("c")
    a = fl.tensor(bn254.FR.to_mont_ints([1, 2, 3, 4]), CPU)
    ntt.ntt(a)
    assert trace.span("z") is trace.OFF and trace.drain() == []


def test_nesting_parent_ids_and_self_time(traced):
    with trace.span("outer", k=1) as outer:
        time.sleep(0.02)
        with trace.span("inner.a") as a:
            time.sleep(0.03)
        with trace.span("inner.b") as b:
            with trace.span("leaf") as leaf:
                time.sleep(0.01)
    spans = trace.drain()
    assert [s.name for s in spans] == ["outer", "inner.a", "inner.b", "leaf"]
    assert outer.parent is None and outer.attrs == {"k": 1}
    assert a.parent == b.parent == outer.id and leaf.parent == b.id
    assert a.start_ns >= outer.start_ns and a.end_ns <= b.start_ns
    assert leaf.end_ns <= b.end_ns <= outer.end_ns
    # on the CPU a span's seconds are its host length
    assert outer.device_s is None and outer.seconds == outer.host_s
    assert outer.self_s == pytest.approx(outer.seconds - a.seconds
                                         - b.seconds)
    assert 0.015 < outer.self_s < outer.seconds - 0.035
    assert b.self_s == pytest.approx(b.seconds - leaf.seconds)
    assert leaf.self_s == leaf.seconds >= 0.01


def test_launch_rise_and_counters_per_span(traced):
    kernels.count("mont_mul", 5)
    with trace.span("outer") as outer:
        kernels.count("mont_mul", 8)
        trace.count("mimc.permute")
        with trace.span("inner") as inner:
            kernels.count("g1_double", 4, 3)
            kernels.count("g2_double", 1, 17)
            kernels.count("mont_mul", 1)
            kernels.count("pairing_miller", 4)
            trace.count("mimc.permute", 2)
        kernels.count("g1_add", 2)
        kernels.count("g2_add", 6)
        kernels.count("g2_add", 3)
        kernels.count("pairing_final_exp", 1)
    trace.count("mimc.permute")          # no span open: dropped
    assert inner.launches == {"mont_mul": 1, "g1_add": 0, "g1_double": 1,
                              "g2_add": 0, "g2_double": 1,
                              "pairing_miller": 1, "pairing_final_exp": 0}
    assert outer.launches == {"mont_mul": 2, "g1_add": 1, "g1_double": 1,
                              "g2_add": 2, "g2_double": 1,
                              "pairing_miller": 1, "pairing_final_exp": 1}
    assert inner.counts == {"mimc.permute": 2}
    assert outer.counts == {"mimc.permute": 3}
    kernels.reset_launches()


def test_count_records_exact_widths_and_times():
    kernels.reset_launches()
    for total, times in ((1, 1), (3, 1), (3, 1), (1000, 1), (1025, 1)):
        kernels.count("mont_mul", total, times)
    kernels.count("g1_double", 7, 16)
    kernels.count("g1_double", 7, 1)
    assert kernels.launch_widths["mont_mul"] == {
        (1, 1): 1, (3, 1): 2, (1000, 1): 1, (1025, 1): 1}
    assert kernels.launch_widths["g1_double"] == {(7, 16): 1, (7, 1): 1}
    assert kernels.launches == {"mont_mul": 5, "g1_double": 2}
    kernels.reset_launches()


def test_spanned_and_benchmark_phases(traced):
    @trace.spanned("work")
    def work(x):
        return x + 1

    timer = Benchmarkable("t")
    with timer.phase("prove") as out:
        out.append(torch.zeros(2))
        assert work(1) == 2
    prove, w = trace.drain()
    assert (prove.name, w.name, w.parent) == ("prove", "work", prove.id)
    assert timer.timing_micros("prove") > 0
    trace.disable()
    assert work(2) == 3 and trace.drain() == []


def test_transcript_spans_and_challenges_on_and_off():
    def run():
        tr = Transcript(label=7, device=CPU)
        tr.absorb_fr(fl.tensor(bn254.FR.to_mont_ints([3, 5]), CPU))
        tr.absorb_point(g1_generator((1,), CPU))
        return torch.cat([tr.challenge(), tr.challenges(2)], dim=-1)

    off = run()
    on, spans = _traced_call(run)
    assert torch.equal(on, off)
    # absorb_point absorbs through the same sponge: one span, not two
    assert [(s.name, s.attrs, s.counts, s.parent) for s in spans] == [
        ("transcript.absorb", {"lanes": 2}, {"mimc.permute": 3}, None),
        ("transcript.absorb", {"lanes": 2}, {"mimc.permute": 3}, None),
        ("transcript.squeeze", {"challenges": 1}, {"mimc.permute": 1}, None),
        ("transcript.squeeze", {"challenges": 2}, {"mimc.permute": 2}, None)]


def test_ntt_spans_once_per_transform_and_outputs_on_and_off():
    a = fl.tensor(bn254.FR.to_mont_ints([1, 2, 3, 4, 5, 6, 7, 8]), CPU)
    a = torch.stack([a, a.flip(-1)])                    # [2, 8, 8]

    def run():
        return (ntt.ntt(a), ntt.intt(a), ntt.coset_ntt(a), ntt.coset_intt(a))

    off = run()
    on, spans = _traced_call(run)
    assert all(torch.equal(x, y) for x, y in zip(on, off))
    assert [(s.name, s.parent) for s in spans] == [("ntt", None)] * 4
    assert [s.attrs for s in spans] == [
        {"size": 8, "batch": 2, "inverse": inv, "coset": coset}
        for coset in (False, True) for inv in (False, True)]


def test_msm_spans_per_chunk_and_outputs_on_and_off():
    points = g1_generator((2,), CPU)
    points = G1.add(points, G1.double(points))
    scalars = fl.tensor(fl.ints_to_limbs([5, 11]), CPU)

    def run():
        return msm.msm(G1, points, scalars, c=8, window_chunk=16)

    off = run()
    on, spans = _traced_call(run)
    assert all(torch.equal(x, y) for x, y in zip(on, off))
    top, digits, c0, c1, horner = spans
    assert (top.name, top.parent) == ("msm", None)
    assert top.attrs == {"curve": "G1", "rows": 1, "points": 2, "c": 8,
                         "chunks": 2}
    assert [s.name for s in (digits, c0, c1, horner)] == [
        "msm.digits", "msm.chunk", "msm.chunk", "msm.horner"]
    assert {s.parent for s in (digits, c0, c1, horner)} == {top.id}
    assert (c0.attrs, c1.attrs) == ({"windows": (0, 16)},
                                    {"windows": (16, 32)})
    assert top.counts == {"msm.chunks": 2}
    assert c0.counts == c1.counts == {"msm.chunks": 1}


def test_batch_spans_per_chunk_and_outputs_on_and_off(monkeypatch):
    """A fixed-base batch of 5 scalars in chunks of 2: one `msm.batch`
    span with 3 chunks and 3 counts of `msm.batch_chunks`, and the points
    of the unchunked batch, tracing on or off."""
    table = msm.generator_table(G1, CPU)
    scalars = fl.tensor(fl.ints_to_limbs([3, 5, 7, 11, 13]), CPU)
    whole = msm.batch_scalar_mul(G1, table, scalars)
    monkeypatch.setattr(msm, "BATCH_CHUNK", 2)

    def run():
        return msm.batch_scalar_mul(G1, table, scalars)

    off = run()
    on, spans = _traced_call(run)
    assert all(torch.equal(x, y) and torch.equal(x, w)
               for x, y, w in zip(on, off, whole))
    assert [(s.name, s.attrs, s.counts, s.parent) for s in spans] == [
        ("msm.batch", {"curve": "G1", "scalars": 5, "chunks": 3},
         {"msm.batch_chunks": 3}, None)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.requires_cuda
def test_span_holds_its_kernel_on_the_profiler_clock(cuda):
    """20 of 20 tries: one K1 launch of 2^16 products and a synchronize
    inside a span; the span's host start and end hold the kernel's
    profiler interval to within 50 us, and its device-inclusive length
    holds the kernel's duration."""
    from torch.profiler import ProfilerActivity, profile

    from legosnark_tpu_torch.fields import cuda_limb

    spec = bn254.FR
    a = fl.tensor(fl.ints_to_limbs([(7 * i + 3) % spec.p
                                    for i in range(1 << 16)]), cuda)
    cuda_limb.mont_mul(spec, a, a)                      # build and warm
    torch.cuda.synchronize()
    slack = 50_000
    for _ in range(20):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trace.enable()
            try:
                with trace.span("k1") as s:
                    cuda_limb.mont_mul(spec, a, a)
                    torch.cuda.synchronize()
            finally:
                trace.disable()
        assert trace.drain() == [s]
        kern = [(ev.start_ns(), ev.start_ns() + ev.duration_ns())
                for ev in prof.profiler.kineto_results.events()
                if ev.device_type() == torch.autograd.DeviceType.CUDA
                and "mont_mul" in ev.name()]
        assert len(kern) == 1
        k0, k1 = kern[0]
        assert s.start_ns - slack <= k0 and k1 <= s.end_ns + slack, (
            s.start_ns, s.end_ns, k0, k1)
        assert s.device_s >= (k1 - k0) / 1e9 * 0.9
