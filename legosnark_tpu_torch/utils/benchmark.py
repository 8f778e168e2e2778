"""Phase timings of the example programs.

Counterpart of `legosnark_tpu/utils/benchmark.py`: a registry of named
phase timings (`Benchmark`), phase bracketing (`Benchmarkable.phase`, or
`start_benchmark`/`stop_benchmark`), slaves that write into their
parent's registry, relabelling of another object's timing, the
`##`-tagged print lines, and `time_function`/`run_and_average`. Work on
the card runs asynchronously, so a phase ends with
`torch.cuda.synchronize` on the device of every tensor the body appends
to the yielded list, and its time is the host clock around body and
fence.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import torch

from . import trace


def _devices(value: Any, out: set) -> set:
    """The CUDA devices of the tensors in a nest of tuples and lists."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            out.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _devices(v, out)
    return out


def _fence(value: Any) -> None:
    for dev in _devices(value, set()):
        torch.cuda.synchronize(dev)


class Benchmark:
    """Timing registry: micros keyed by object id, then phase."""

    def __init__(self):
        self.timings: Dict[str, Dict[str, float]] = defaultdict(dict)

    def record(self, obj_id: str, phase: str, micros: float) -> None:
        self.timings[obj_id][phase] = micros

    def get(self, obj_id: str, phase: str) -> float:
        return self.timings[obj_id][phase]

    def copy_timing(self, src_obj: str, src_phase: str, dst_obj: str,
                    dst_phase: str) -> None:
        self.record(dst_obj, dst_phase, self.get(src_obj, src_phase))


class Benchmarkable:
    """Phase bracketing into a `Benchmark` registry."""

    def __init__(self, obj_id: str, benchmark: Optional[Benchmark] = None):
        self.obj_id = obj_id
        self.benchmark = benchmark or Benchmark()
        self._starts: Dict[str, float] = {}

    def add_benchmark_slave(self, slave: "Benchmarkable") -> None:
        """The slave (a sub-gadget) records into this object's registry."""
        slave.set_benchmark(self.benchmark)

    def set_benchmark(self, benchmark: Benchmark) -> None:
        self.benchmark = benchmark

    def start_benchmark(self, phase: str) -> None:
        self._starts[phase] = time.perf_counter()

    def stop_benchmark(self, phase: str, fence: Any = None) -> float:
        """Records and returns the micros since `start_benchmark(phase)`,
        after waiting for the CUDA tensors in `fence`."""
        _fence(fence)
        micros = (time.perf_counter() - self._starts.pop(phase)) * 1e6
        self.benchmark.record(self.obj_id, phase, micros)
        return micros

    @contextlib.contextmanager
    def phase(self, name: str):
        """Times the body; the tensors it appends to the yielded list are
        waited for before the clock stops. The body and the wait are also
        one span `name` of `utils/trace`."""
        out: list = []
        with trace.span(name):
            self.start_benchmark(name)
            yield out
            self.stop_benchmark(name, out)

    def timing_micros(self, phase: str) -> float:
        return self.benchmark.get(self.obj_id, phase)

    def apply_benchmark_from(self, other: "Benchmarkable", src_phase: str,
                             dst_phase: str) -> None:
        """Record `other`'s timing of src_phase as this object's dst_phase."""
        self.benchmark.record(self.obj_id, dst_phase,
                              other.benchmark.get(other.obj_id, src_phase))

    def seconds(self) -> Dict[str, float]:
        """Every phase of this object, in seconds."""
        return {k: v / 1e6
                for k, v in self.benchmark.timings[self.obj_id].items()}


def fmt_time(micros: float) -> str:
    return f"{micros:.0f} us ({micros / 1e6:.3f} s)"


def print_bm(tag: str, micros: float) -> None:
    """One grep-able `##` line."""
    print(f"## {tag}: {fmt_time(micros)}", flush=True)


def time_function(fn, *args, fence: bool = True, **kwargs):
    """(fn(*args, **kwargs), micros), waiting for the CUDA tensors of the
    result (in nested tuples and lists) unless fence=False."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if fence:
        _fence(out)
    return out, (time.perf_counter() - t0) * 1e6


def run_and_average(fn, *args, n: int = 3, **kwargs):
    """(last result, mean micros) over n calls of `time_function`."""
    total, out = 0.0, None
    for _ in range(n):
        out, micros = time_function(fn, *args, **kwargs)
        total += micros
    return out, total / n


def now() -> float:
    """Monotonic seconds."""
    return time.perf_counter()
