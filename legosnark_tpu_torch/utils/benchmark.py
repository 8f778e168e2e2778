"""Phase timings of the example programs.

Counterpart of `legosnark_tpu/utils/benchmark.py`: a registry of named
phase timings (`Benchmark`), a context manager that brackets a phase
(`Benchmarkable.phase`) and the `##`-tagged print lines. Work on the card
runs asynchronously, so a phase ends with `torch.cuda.synchronize` on the
device of every tensor the body appends to the yielded list, and its time
is the host clock around body and fence.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import torch


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


class Benchmarkable:
    """Phase bracketing into a `Benchmark` registry."""

    def __init__(self, obj_id: str, benchmark: Optional[Benchmark] = None):
        self.obj_id = obj_id
        self.benchmark = benchmark or Benchmark()

    @contextlib.contextmanager
    def phase(self, name: str):
        """Times the body; the tensors it appends to the yielded list are
        waited for before the clock stops."""
        out: list = []
        t0 = time.perf_counter()
        yield out
        _fence(out)
        self.benchmark.record(self.obj_id, name,
                              (time.perf_counter() - t0) * 1e6)

    def timing_micros(self, phase: str) -> float:
        return self.benchmark.get(self.obj_id, phase)

    def seconds(self) -> Dict[str, float]:
        """Every phase of this object, in seconds."""
        return {k: v / 1e6
                for k, v in self.benchmark.timings[self.obj_id].items()}


def fmt_time(micros: float) -> str:
    return f"{micros:.0f} us ({micros / 1e6:.3f} s)"


def print_bm(tag: str, micros: float) -> None:
    """One grep-able `##` line."""
    print(f"## {tag}: {fmt_time(micros)}", flush=True)
