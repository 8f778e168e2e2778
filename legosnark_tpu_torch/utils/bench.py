"""Helpers for checking and timing kernels against their plain versions:
the word comparison, the timer, the edge values and the random operands
shared by `chip_smoke.py` and the probes."""
from __future__ import annotations

import time

import numpy as np
import torch

from ..fields import limb as fl


def word_err(a, b) -> int:
    """Largest |difference| of two int32 word tensors read as uint32
    (0 means bit-identical)."""
    da, db = fl.widen(a), fl.widen(b)
    return int((da - db).abs().max().item()) if da.numel() else 0


def timed_ms(fn, dev, reps: int) -> float:
    """Mean ms of fn() after one warm-up: CUDA events on the card."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def edge_ints(p: int) -> list:
    """The edge values of the field checks: 0, 1, p - 1, p, 2p - 1 and
    two all-ones patterns."""
    return [0, 1, p - 1, p, 2 * p - 1, (1 << 224) - 1, (1 << 192) - 1]


def rand_below(rng, n: int, bound: int) -> list:
    """n ints uniform-ish in [0, bound) from 320 random bits each."""
    raw = rng.integers(0, 1 << 63, size=(n, 5), dtype=np.int64)
    return [int.from_bytes(r.tobytes(), "little") % bound for r in raw]
