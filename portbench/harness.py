"""The benchmark's engine: finds a cell's configuration, traffic, driver,
reference and metric readers by the names in `BENCHMARK.json`, runs the
closed-loop window and builds the result line.

A cell's statements are taken one after another (one prover, one
verifier): statement k commits its inputs, proves and verifies, each
phase fenced by `torch.cuda.synchronize`, and statement k + 1 starts when
k's verdict is read. Statements start while the window is open; the one
running when it closes is finished and counted. After the window the
reference checks a sample of the window's statements drawn from the seed,
and the program verifies one tampered proof.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from portbench import trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules that no run may hold once its window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "legosnark_tpu")
GIB = 1 << 30


def derive(seed: int, *salt) -> int:
    """A 63-bit seed for one purpose and index, from the run's seed."""
    words = [seed % (1 << 64)] + [
        int.from_bytes(s.encode(), "little") if isinstance(s, str)
        else int(s) % (1 << 64) for s in salt]
    a, b = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_module(path: Path, name: str):
    """Import the file at `path` as module `name` (readers and drivers are
    found by the names the spec gives, which need not be identifiers)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """Everything one workload of the spec names, read from its files."""

    name: str
    config: dict
    traffic: dict
    driver: object
    per_layer: list     # spec entries of the per-layer metrics it reports
    end_to_end: list    # spec entries of its end-to-end metrics


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(spec: dict, workload: str) -> Cell:
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the spec has "
                         f"{sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    driver = load_module(HERE / "drivers" / f"{w['config']}.py",
                         f"portbench_driver_{w['config']}")
    return Cell(workload, config, traffic, driver,
                [m for m in spec["per_layer"] if _reports(m, workload)],
                [m for m in spec["end_to_end"] if _reports(m, workload)])


def load_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py",
                       f"portbench_metric_{name}")


@dataclass
class Record:
    """One statement of the window."""

    k: int
    commit: object = None
    proof: object = None
    ok: bool = None
    seconds: dict = field(default_factory=dict)       # phase -> host s
    launches: dict = field(default_factory=dict)      # phase -> {kernel: n}
    traces: dict = field(default_factory=dict)        # phase -> trace.Span
    host: dict = field(default_factory=dict)          # phase -> host clocks


def forbidden_modules() -> list:
    """Top-level names of `sys.modules` that no run may hold, compared
    whole (`legosnark_tpu_torch` is not `legosnark_tpu`)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN_MODULES))


class HostClocks:
    """Where a phase's wall time went on the host, beside its length: the
    dispatch thread's CPU seconds, the machine's stolen seconds over all
    cores (`/proc/stat`) and the seconds inside Python's collector. A
    phase that reads long with little more CPU time was held up; one that
    reads long with as much more CPU time ran slowly."""

    def __init__(self):
        self.gc_s = 0.0
        self._gc_t0 = None

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_s += time.perf_counter() - self._gc_t0
            self._gc_t0 = None

    def __enter__(self):
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on_gc)
        return False

    @staticmethod
    def _steal_s():
        try:
            with open("/proc/stat") as f:
                return int(f.readline().split()[8]) / 100.0
        except (OSError, ValueError, IndexError):
            return None

    def read(self) -> dict:
        return {"cpu_s": time.thread_time(), "steal_s": self._steal_s(),
                "gc_s": self.gc_s}

    @staticmethod
    def delta(a: dict, b: dict) -> dict:
        return {k: None if a[k] is None or b[k] is None else b[k] - a[k]
                for k in a}


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_window(session, seconds: float, traced: bool, dev) -> tuple:
    """The closed loop over `seconds` -> (records, window seconds)."""
    records = []
    clocks = HostClocks()
    t_end = time.perf_counter() + seconds
    t_start = time.perf_counter()
    k = 0
    with clocks:
        while time.perf_counter() < t_end:
            records.append(_statement(session, k, traced, dev, clocks))
            k += 1
    return records, time.perf_counter() - t_start


def _statement(session, k: int, traced: bool, dev, clocks) -> Record:
    """Statement k through commit, prove and verify, each phase fenced."""
    import torch

    from legosnark_tpu_torch import kernels

    rec = Record(k)
    for phase in ("commit", "prove", "verify"):
        before = dict(kernels.launches)
        host0 = clocks.read()
        with (trace.Span(phase, dev) if traced
              else contextlib.nullcontext()) as span:
            t0 = time.perf_counter()
            if phase == "commit":
                rec.commit = session.commit(k)
            elif phase == "prove":
                rec.proof = session.prove(k, rec.commit)
            else:
                rec.ok = session.verify(k, rec.commit, rec.proof)
            _sync(torch, dev)
            rec.seconds[phase] = time.perf_counter() - t0
        rec.launches[phase] = {
            name: n - before.get(name, 0)
            for name, n in kernels.launches.items()
            if n != before.get(name, 0)}
        rec.host[phase] = clocks.delta(host0, clocks.read())
        if span is not None:
            rec.traces[phase] = span
    return rec


def correctness(session, records, seed: int, sample: int,
                release: bool = True) -> list:
    """[(name, value, limit)]: the values and equations of the sampled
    statements that the reference could not confirm, and the verdicts
    that differ from the reference's (every honest statement true, the
    sampled ones as the reference judged them, one tampered proof false).
    The program verifies the tampered proof first and then (with
    `release`) lets go of its state; the reference runs after that."""
    rng = np.random.default_rng(derive(seed, "sample"))
    picks = sorted(rng.choice(len(records), min(sample, len(records)),
                              replace=False).tolist())
    first = records[picks[0]]
    tamper_ok = session.verify(first.k, first.commit, session.tampered(first))
    if release:
        session.release()
    wrong_outputs, wrong_verdicts, findings = 0, int(tamper_ok is not False), []
    for rec in records:
        want = True
        if rec.k in picks:
            found = session.check(rec)
            findings += [f"statement {rec.k}: {f}" for f in found]
            wrong_outputs += len(found)
            want = not found
        wrong_verdicts += rec.ok is not want
    for f in findings[:20]:
        print(f"portbench: reference: {f}", file=sys.stderr)
    return [("wrong_outputs", wrong_outputs, 0),
            ("wrong_verdicts", wrong_verdicts, 0)]


def device_info(torch, dev, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": peak}


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device=None, t_process: float = None, control: str = None,
             faults=(), config_override: dict = None, session=None) -> dict:
    """One run of a cell -> the result object (the last line's content).
    `control` names a control of the driver's `CONTROLS` and `faults` are
    contexts of the driver's `FAULTS`, planted under the window and the
    checks after it; neither is used by the benchmark's own runs. A
    `session` already set up (by `setup`) is used as it is."""
    import torch

    t_process = time.perf_counter() if t_process is None else t_process
    spec = load_spec()
    cell = find_cell(spec, workload)
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    own = session is None
    if own:
        session = setup(cell, seed, dev, config_override)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_process

    with contextlib.ExitStack() as plants:
        if control:
            plants.enter_context(cell.driver.CONTROLS[control]())
        for f in faults:
            plants.enter_context(f())
        records, window_s = run_window(session, seconds, traced, dev)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
            else 0
        compared = correctness(session, records, seed, cell.traffic["sample"],
                               release=own)

    n = len(records)
    e2e = {
        "prove_s": sum(r.seconds["commit"] + r.seconds["prove"]
                       for r in records) / n,
        "verify_s": sum(r.seconds["verify"] for r in records) / n,
        "statement_s": sum(sum(r.seconds.values()) for r in records) / n,
        "peak_gib": peak / GIB,
        "setup_s": setup_s,
    }
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    out = {"correct": all(v <= lim for _, v, lim in compared),
           "attempted": n,
           "failed": sum(r.ok is not True for r in records),
           "metrics": {}, "device": device_info(torch, dev, peak)}
    if traced:
        run = trace.Run(records)
        for m in cell.per_layer:
            value = load_reader(m["name"]).read(run)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value,
                                             "unit": units[m["name"]]}
        out["device"].update(busy_s=run.busy_s(), window_s=run.traced_s())
        out["breakdown"] = run.breakdown()
    else:
        for m in cell.end_to_end:
            out["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                         "unit": units[m["name"]]}
    out["statements"] = {
        "window_s": window_s,
        "per_statement_s": [dict(r.seconds) for r in records],
        "per_statement_host": [dict(r.host) for r in records],
        "median_statement_s": statistics.median(
            sum(r.seconds.values()) for r in records)}
    out["compared"] = {name: {"value": v, "limit": lim}
                       for name, v, lim in compared}
    return out


def setup(cell: Cell, seed: int, dev, config_override: dict = None):
    """The cell's session: the driver's set-up and one warm-up statement
    through all three phases at the cell's own sizes."""
    import torch

    session = cell.driver.Session({**cell.config, **(config_override or {})},
                                  cell.traffic, seed, dev)
    session.warm()
    _sync(torch, dev)
    return session
