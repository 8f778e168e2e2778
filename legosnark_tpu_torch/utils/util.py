"""Host-side helpers of the reference's `utils/util.{h,cc}`: `log2ceiled`,
Fr vectors in the reference's text format, and disk storage of points.

Text files (`dump_into_file`, `load_from_file`) hold the count on the
first line, then one canonical decimal integer per line: the same format
as the JAX package's, so a file written by either package loads in the
other.

Point files hold the port's int32 limbs [..., 8, n] in Montgomery form
with R = 2^256. The JAX package's (13-bit limbs, R = 2^260) have the same
keys but another layout, so a point file of one package is not read by
the other. A named collection of point batches (the SRS cache) goes to
one uncompressed `.npz` (point limbs are near-random, so compression only
costs time), written to a temporary file and moved into place, so that a
crash never leaves a truncated key behind.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from ..config import resolve_device
from ..curve import bn254
from ..curve.group import Point
from ..fields import limb as fl

FR = bn254.FR

#: default cache directory (listed in .gitignore)
SRS_CACHE_DIR = Path(__file__).resolve().parents[2] / "srs_cache"


def log2ceiled(n: int) -> int:
    """ceil(log2(n)), 0 for n <= 1."""
    return (n - 1).bit_length() if n > 1 else 0


def dump_into_file(path, v_mont) -> None:
    """Montgomery Fr [8, n] -> text: the count, then one canonical
    integer per line."""
    vals = fl.limbs_to_ints(fl.from_mont(FR, v_mont))
    with open(path, "w") as fh:
        fh.write(f"{len(vals)}\n")
        fh.writelines(f"{int(v)}\n" for v in vals)


def load_from_file(path, device=None):
    """Inverse of `dump_into_file` -> Montgomery Fr [8, n] on `device`."""
    dev = resolve_device(device)
    with open(path) as fh:
        n = int(fh.readline())
        vals = [int(fh.readline()) for _ in range(n)]
    return fl.tensor(FR.to_mont_ints(vals), dev)


def populate_from_file_dist(path, n: int, device=None):
    """n entries from the file's samples, cycling through them."""
    base = load_from_file(path, resolve_device(device))
    return base.repeat(1, -(-n // base.shape[-1]))[..., :n]


def save_point_batch(path, p: Point) -> None:
    """One point batch to a compressed .npz (keys x, y, z) in the port's
    layout: not readable by the JAX package, nor its files here."""
    np.savez_compressed(path, **{c: t.detach().cpu().numpy()
                                 for c, t in zip("xyz", p)})


def load_point_batch(path, device=None) -> Point:
    """Inverse of `save_point_batch` -> a Point on `device`."""
    dev = resolve_device(device)
    with np.load(path) as data:
        return Point(*(torch.from_numpy(data[c]).to(dev) for c in "xyz"))


def save_point_group(path, points: dict) -> None:
    """Write {name: Point} to one .npz at `path`, atomically."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrs = {}
    for name, p in points.items():
        for coord, t in zip("xyz", p):
            arrs[f"{name}__{coord}"] = t.detach().cpu().numpy()
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrs)
    os.replace(tmp, path)


def load_point_group(path, device) -> dict:
    """Inverse of `save_point_group` -> {name: Point} on `device`."""
    with np.load(path) as data:
        names = sorted({k[: -len("__x")] for k in data.files
                        if k.endswith("__x")})
        return {name: Point(*(torch.from_numpy(data[f"{name}__{c}"])
                              .to(device) for c in "xyz"))
                for name in names}
