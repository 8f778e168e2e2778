"""Carry state of the JAX package into the port, and read values out.

The JAX package stores a field element as 20 little-endian 13-bit limbs
`[..., 20, n]` in Montgomery form with R = 2^260. Its Pallas kernels may
leave limbs loose (above 13 bits) and values up to 3.62p, so a value is
read as the plain sum of limb_k * 2^(13k), whatever the limb sizes. The
port stores 8 x 32-bit limbs `[..., 8, n]` with R = 2^256.

Inputs are numpy arrays, or anything `np.asarray` accepts; this module
imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np

from .curve import bn254
from .curve.group import Point, g1_to_ints, g2_to_ints
from .fields import limb as fl
from .fields.limb import FieldSpec

JAX_LIMB_BITS = 13
JAX_NLIMBS = 20
JAX_R = 1 << (JAX_LIMB_BITS * JAX_NLIMBS)


def jax_field_ints(arr, spec: FieldSpec) -> np.ndarray:
    """JAX Montgomery limbs [..., 20, n] -> canonical ints, object [..., n]."""
    a = np.moveaxis(np.asarray(arr).astype(np.int64), -2, -1)   # [..., n, 20]
    flat = a.reshape(-1, a.shape[-1])
    rinv = pow(JAX_R, -1, spec.p)
    out = np.empty((flat.shape[0],), dtype=object)
    for i, row in enumerate(flat):
        v = 0
        for k in range(row.shape[0] - 1, -1, -1):
            v = (v << JAX_LIMB_BITS) + int(row[k])
        out[i] = v * rinv % spec.p
    return out.reshape(a.shape[:-1])


def field_from_jax(arr, spec: FieldSpec) -> np.ndarray:
    """JAX Montgomery limbs [..., 20, n] -> port Montgomery limbs
    [..., 8, n] (int32 numpy)."""
    ints = jax_field_ints(arr, spec)
    flat = [spec.to_mont_int(x) for x in ints.reshape(-1)]
    limbs = fl.ints_to_limbs(flat)                          # [8, N]
    lead = ints.shape
    return np.moveaxis(limbs.reshape((fl.NLIMBS,) + lead), 0, -2).copy()


def point_from_jax(p, device, spec: FieldSpec = bn254.FQ) -> Point:
    """A JAX `Point` (G1 [..., 20, n] or G2 [..., 2, 20, n] coordinates)
    -> a port `Point` of tensors on `device`."""
    return Point(*(fl.tensor(field_from_jax(c, spec), device) for c in p))


def polykey_from_jax(key, device):
    """A JAX `PolyKey` -> the port's `PolyKey`."""
    from .gadgets.poly import PolyKey
    return PolyKey(
        bases=tuple(point_from_jax(b, device) for b in key.bases),
        bases_a=tuple(point_from_jax(b, device) for b in key.bases_a),
        g2_s=point_from_jax(key.g2_s, device),
        g2_alpha=point_from_jax(key.g2_alpha, device),
        g1=point_from_jax(key.g1, device),
        g2=point_from_jax(key.g2, device))


def matkey_from_jax(key, device):
    """A JAX `MatKey` -> the port's `MatKey`."""
    from .gadgets.matrix import MatKey
    return MatKey(key.n, key.d, polykey_from_jax(key.poly_key, device))


def to_ints(x, spec: FieldSpec = bn254.FR, g2: bool = False):
    """Canonical integers of port values: Montgomery limbs [..., 8, n] ->
    object array [..., n]; a `Point` -> flat list of affine (x, y), or
    ((x0, x1), (y0, y1)) with g2=True, and None for the identity."""
    if isinstance(x, Point):
        return g2_to_ints(x) if g2 else g1_to_ints(x)
    ints = fl.limbs_to_ints(x)
    out = np.empty(ints.shape, dtype=object)
    for idx, v in np.ndenumerate(ints):
        out[idx] = spec.from_mont_int(v)
    return out
