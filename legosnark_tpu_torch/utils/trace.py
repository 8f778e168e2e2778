"""Spans and counters inside the port: where a call's time goes.

`span(name, **attrs)` is a context manager around one piece of work at a
layer boundary (the transcript, the pairing, the MSM, the NTT, ...);
`spanned(name)` makes a whole function one span; `count(name)` adds to a
counter of the innermost open span. Tracing is off until `enable()`, and
off, `span` reads one module global and returns the shared no-op `OFF`:
no clock, no CUDA call, nothing recorded. There is no environment switch.

On, each span records its name, id, parent id and attributes; its host
start and end on the clock of `torch.profiler`'s device events
(`now_ns`, Unix nanoseconds), so a span can be laid beside the kernels
of a profiler trace; the rise of `kernels.launches` of K1-K3 and K5-K8
over the span; its counters, its children's included; and, when CUDA is
in use, a pair of `torch.cuda.Event`s recorded at open and close, read
at `drain()` (after the caller's synchronize) as the span's
device-inclusive length: from the stream reaching the span's start to
the end of the last kernel the span enqueued. A span without events
(tracing on the CPU) reports its host length instead.

Spans are held in memory until `drain()`; the program writes and prints
nothing of them. They sit at layer boundaries only, never inside a
kernel wrapper or a per-product, per-round-of-MiMC or per-Miller-step
function: a few hundred per proof.
"""
from __future__ import annotations

import functools
import itertools
import time

import torch

from .. import kernels

#: kernels whose launches a span counts: K1, K2, K3, K5, K6, K7, K8
KERNELS = ("mont_mul", "g1_add", "g1_double", "g2_add", "g2_double",
           "pairing_miller", "pairing_final_exp")

_on = False
_events = False
_open: list = []      # open spans, innermost last
_closed: list = []    # spans closed since the last drain
_ids = itertools.count(1)


def now_ns() -> int:
    """The host clock of the spans: Unix nanoseconds, the clock on which
    `torch.profiler` reports device activity (`kineto_results.events()`,
    `start_ns()`)."""
    return time.time_ns()


class _Off:
    """The span handed out while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class Span:
    """One traced piece of work; after it closes, a record of it."""

    __slots__ = ("name", "id", "parent", "attrs", "counts", "start_ns",
                 "end_ns", "launches", "device_s", "self_s", "_k0", "_ev")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.counts = {}
        self.device_s = self.self_s = None
        self.end_ns = None

    def __enter__(self):
        self.id = next(_ids)
        self.parent = _open[-1].id if _open else None
        _open.append(self)
        L = kernels.launches
        self._k0 = tuple(L[k] for k in KERNELS)
        self._ev = None
        if _events:
            self._ev = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            self._ev[0].record()
        self.start_ns = now_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = now_ns()
        if self._ev is not None:
            self._ev[1].record()
        L = kernels.launches
        self.launches = {k: L[k] - k0 for k, k0 in zip(KERNELS, self._k0)}
        _open.remove(self)
        if _open:
            up = _open[-1].counts
            for k, n in self.counts.items():
                up[k] = up.get(k, 0) + n
        _closed.append(self)
        return False

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def seconds(self) -> float:
        """Device-inclusive seconds, or host seconds without events."""
        return self.host_s if self.device_s is None else self.device_s


def span(name: str, **attrs):
    """A context manager timing its block as span `name`, or `OFF`."""
    if not _on:
        return OFF
    return Span(name, attrs)


def spanned(name: str):
    """Decorator: each call of the function is one span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with Span(name, {}):
                return fn(*args, **kwargs)
        return traced
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` of the innermost open span (and, when it
    closes, of its parents)."""
    if _on and _open:
        c = _open[-1].counts
        c[name] = c.get(name, 0) + n


def enable() -> None:
    """Record spans from now on; with CUDA initialised, with events."""
    global _on, _events
    _events = torch.cuda.is_available() and torch.cuda.is_initialized()
    _on = True


def disable() -> None:
    """Stop recording (spans still open close as usual)."""
    global _on
    _on = False


def drain() -> list:
    """The spans closed since the last drain, in the order they opened,
    with `device_s` read from their events and `self_s` (seconds less
    the seconds of their children); forgets them. Call it after a
    synchronize: it waits for each span's closing event."""
    out = sorted(_closed, key=lambda s: s.id)
    _closed.clear()
    children = {}
    for s in out:
        if s._ev is not None:
            s._ev[1].synchronize()
            s.device_s = s._ev[0].elapsed_time(s._ev[1]) / 1e3
            s._ev = None
        if s.parent is not None:
            children[s.parent] = children.get(s.parent, 0.0) + s.seconds
    for s in out:
        s.self_s = s.seconds - children.get(s.id, 0.0)
    return out
