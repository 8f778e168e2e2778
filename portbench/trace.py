"""The traced run's device record, read by the per-layer metric readers.

Each phase of each statement runs inside its own `torch.profiler` session
that records the card's activity only (no host operator events, so the
trace stays small and the host path keeps its speed). A phase's kernels
all end inside its session, because every phase ends in
`torch.cuda.synchronize`. So a phase's device busy time is the union of
its kernel intervals, and its idle share is one less that union over the
phase's host-clock length: the arithmetic of
`scripts/profile_cpmmp_torch.py` (`busy_seconds`), copied here.
"""
from __future__ import annotations

import time

#: idle gaps and device operations kept in the result's breakdown
BREAKDOWN = 10


def _kernel_intervals(prof) -> list:
    """[(start_ns, end_ns, name)] of the device activity of a finished
    profiler session, read from its raw results without building the
    parsed event list."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == cuda]


def union_ns(intervals) -> tuple:
    """(busy ns, idle gaps [(ns, name of the kernel before the gap)]) of
    intervals [(start, end, name)]: the length of their union and the
    holes between its pieces."""
    busy, gaps = 0, []
    cur0 = cur1 = None
    last = None
    for t0, t1, name in sorted(intervals):
        if cur1 is None or t0 > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
                gaps.append((t0 - cur1, last))
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
        if t1 >= cur1:
            last = name
    if cur1 is not None:
        busy += cur1 - cur0
    return busy, gaps


class Span:
    """One phase under the profiler: host seconds, device busy seconds,
    device seconds by kernel name and the idle gaps between kernels."""

    def __init__(self, phase: str, dev):
        self.phase = phase
        self.dev = dev
        self.host_s = 0.0
        self.busy_s = 0.0
        self.by_name = {}
        self.gaps = []
        #: [(kernel, points, times)] of every K2 and K3 launch in the span
        self.g1_launches = []
        self._prof = None
        self._saved = None

    def _log_g1(self):
        """Wrap the port's K2/K3 wrappers (`curve/cuda_group`) so that each
        launch's width and `times` are logged: `kernels.launch_widths`
        keeps only power-of-two buckets and no `times`."""
        from legosnark_tpu_torch.curve import cuda_group as cg

        add, dbl = cg.add_points, cg.double_point
        log = self.g1_launches

        def add_points(p, q):
            if p[0].device.type == "cuda":
                log.append(("g1_add", p[0].numel() // 8, 1))
            return add(p, q)

        def double_point(p, times: int = 1):
            if p[0].device.type == "cuda":
                log.append(("g1_double", p[0].numel() // 8, times))
            return dbl(p, times)

        cg.add_points, cg.double_point = add_points, double_point
        self._saved = (cg, add, dbl)

    def __enter__(self):
        if self.dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            self._log_g1()
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.host_s = time.perf_counter() - self._t0
        if self._prof is None:
            return False
        cg, add, dbl = self._saved
        cg.add_points, cg.double_point = add, dbl
        self._prof.__exit__(*exc)
        ivs = _kernel_intervals(self._prof)
        self._prof = None
        for t0, t1, name in ivs:
            self.by_name[name] = self.by_name.get(name, 0.0) + (t1 - t0) / 1e9
        busy, gaps = union_ns(ivs)
        self.busy_s = busy / 1e9
        self.gaps = sorted(((g / 1e9, n) for g, n in gaps), reverse=True)[
            :BREAKDOWN]
        return False


class Run:
    """The traced window's statements, for the readers."""

    def __init__(self, records):
        self.records = records

    def spans(self, phases) -> list:
        return [r.traces[p] for r in self.records for p in phases
                if p in r.traces]

    def idle_share(self, phases):
        """1 - (device busy) / (host length) over the phases' spans, or
        None where the profiler saw no device time."""
        spans = self.spans(phases)
        busy = sum(s.busy_s for s in spans)
        host = sum(s.host_s for s in spans)
        if busy <= 0 or host <= 0:
            return None
        return 1.0 - busy / host

    def device_seconds(self, phases, prefixes) -> float:
        """Device seconds of the kernels whose names start with one of
        `prefixes`, over the phases' spans."""
        return sum(v for s in self.spans(phases)
                   for name, v in s.by_name.items()
                   if name.startswith(tuple(prefixes)))

    def busy_s(self) -> float:
        return sum(s.busy_s for s in self.spans(("commit", "prove",
                                                 "verify")))

    def traced_s(self) -> float:
        return sum(s.host_s for s in self.spans(("commit", "prove",
                                                 "verify")))

    def breakdown(self) -> dict:
        by_name = {}
        gaps = []
        for r in self.records:
            for p, s in r.traces.items():
                for name, v in s.by_name.items():
                    by_name[name] = by_name.get(name, 0.0) + v
                gaps += [(g, f"{p}, statement {r.k}, after "
                          f"{(n or '?')[:60]}") for g, n in s.gaps]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN]
        gaps = sorted(gaps, reverse=True)[:BREAKDOWN]
        return {"device_ops": [[n[:120], v] for n, v in top],
                "idle_gaps": [[n, g] for g, n in gaps]}
