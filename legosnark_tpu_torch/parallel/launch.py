"""Run one function on every rank of a `torch.distributed` world.

`run(fn, devices, backend, *args)` starts one process per entry of
`devices` with `torch.multiprocessing.spawn`. The ranks meet through a
file in a fresh temporary directory (`init_method="file://..."`), so
several worlds can start at once on one machine without a port to agree
on. Each rank pins its device (`torch.cuda.set_device`, before any
collective, so that NCCL and the kernels of `csrc/` share the current
stream), or one thread for the CPU, joins the world and calls
`fn(Rank, *args)`. What `fn` returns, with every tensor turned into a
numpy array, comes back from `run` as one entry per rank. A rank that
raises makes `run` raise; `spawn` then ends the other ranks.

`measured` runs one call on a rank and records its seconds (host clock
between two device synchronisations, after a barrier), the kernel
launches it made (`kernels.launches`) and the bytes its collectives
received (`sharded.collective_bytes`).

`fn` must be importable by name in a fresh interpreter (spawn pickles it
by import path), so it lives in this package, never in a test module.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

from .. import kernels
from . import sharded

#: seconds a collective may wait for the other ranks before its rank fails
TIMEOUT_S = 600.0


class Rank(NamedTuple):
    """What a rank's function gets: its index, the world's size, the
    process group of the world and its device."""

    rank: int
    world: int
    group: object
    device: torch.device


def _host(x):
    """Tensors -> numpy arrays inside tuples (named too), lists and dicts."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_host(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v) for v in x)
    return x


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measured(ctx: Rank, stats: dict, name: str, fn, *args, **kwargs):
    """fn(*args, **kwargs) on this rank; stats[name] gets its seconds, the
    kernel launches it made and the bytes its collectives received."""
    _sync(ctx.device)
    dist.barrier(group=ctx.group)
    kernels.reset_launches()
    sharded.reset_collective_bytes()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _sync(ctx.device)
    stats[name] = {"seconds": time.perf_counter() - t0,
                   "launches": dict(kernels.launches),
                   "collective_bytes": sum(sharded.collective_bytes.values())}
    return out


def _child(rank: int, fn, devices, backend: str, tmp: str, args) -> None:
    # every rank of `run` is on this host: bootstrap over the loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(tmp, "rendezvous"),
        rank=rank, world_size=len(devices),
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
        device_id=device if backend == "nccl" else None)
    try:
        group = sharded.make_group(len(devices))
        out = _host(fn(Rank(rank, len(devices), group, device), *args))
        path = os.path.join(tmp, f"rank{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".tmp", path)
        dist.barrier(group=group)
    finally:
        dist.destroy_process_group()


def run(fn, devices, backend: str, *args) -> list:
    """fn(Rank, *args) on len(devices) ranks, rank r on devices[r], joined
    by `backend` ("nccl" or "gloo"); returns each rank's result with its
    tensors as numpy arrays, in rank order. NCCL takes one card per rank;
    gloo takes any devices, the CPU or cards, also several ranks on one
    card."""
    devices = [str(torch.device(d)) for d in devices]
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend}")
    if backend == "nccl" and (len(set(devices)) != len(devices) or any(
            not d.startswith("cuda") for d in devices)):
        raise ValueError(f"NCCL needs one distinct card per rank: {devices}")
    with tempfile.TemporaryDirectory(prefix="lsk_world_") as tmp:
        torch.multiprocessing.spawn(
            _child, args=(fn, devices, backend, tmp, args),
            nprocs=len(devices), join=True)
        out = []
        for r in range(len(devices)):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
