"""Disk storage of point collections: the SRS cache.

Counterpart of `legosnark_tpu/utils/util.py:69-95`. A named collection of
point batches goes to one uncompressed `.npz` (point limbs are
near-random, so compression only costs time), written to a temporary
file and moved into place, so that a crash never leaves a truncated key
behind. The arrays are the port's int32 limbs [..., 8, n] in Montgomery
form with R = 2^256; the JAX package's files (13-bit limbs, R = 2^260)
have other names and are never read here.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from ..curve.group import Point

#: default cache directory (listed in .gitignore)
SRS_CACHE_DIR = Path(__file__).resolve().parents[2] / "srs_cache"


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
