"""K2/K3 and K5/K6: the fused G1 and G2 add and double kernels, their
plain versions and wrappers.

K2/K3 are the counterpart of `legosnark_tpu/curve/pallas_group.py`; K5/K6
replace no TPU kernel (the JAX package's G2 law is jnp code). The kernels
are in `csrc/g1.cu` and `csrc/g2.cu`; `add_points_plain` /
`double_point_plain` (G1) and `g2_add_points_plain` /
`g2_double_point_plain` (G2) run the same RCB sequence (`group.rcb_add` /
`rcb_double`) in torch ops on any device, with the plain version of K1
for every product, and agree with the kernels bit for bit: every
intermediate stays in [0, 2p) under the contract of `fields/limb.py`, at
every batch width.

K3 and K6 take `times` >= 1 and double each point that many times in one
launch (the plain versions loop the single doubling).

Dispatch: CPU coordinates take the plain version, CUDA coordinates the
kernel. Coordinates are (x, y, z) int32 tensors of one shape, `[..., 8, n]`
on G1 and `[..., 2, 8, n]` on G2. Each launch is counted in
`kernels.launches` and, by its width (points per launch) and `times`, in
`kernels.launch_widths`: K2/K3 as `g1_add` / `g1_double`, K5/K6 as
`g2_add` / `g2_double`. The G2 wrappers never pass through `add_points` /
`double_point`, which count and log G1 launches only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels
from ..fields.limb import NLIMBS
from ..fields.ops import Fq2Ops, FqOps
from . import bn254
from .group import rcb_add, rcb_double

#: Fq ops that multiply with K1's plain version on every device
FQ_PLAIN = FqOps(bn254.FQ, plain=True)
#: Fq2 ops over them
FQ2_PLAIN = Fq2Ops(FQ_PLAIN)


def add_points_plain(p, q):
    dev = p[0].device
    return tuple(rcb_add(FQ_PLAIN, FQ_PLAIN.const(bn254.B3_G1, dev), p, q))


def _check_times(times: int) -> None:
    if times < 1:
        raise ValueError(f"double_point: times must be >= 1, got {times}")


def double_point_plain(p, times: int = 1):
    _check_times(times)
    b3 = FQ_PLAIN.const(bn254.B3_G1, p[0].device)
    for _ in range(times):
        p = tuple(rcb_double(FQ_PLAIN, b3, p))
    return p


def g2_add_points_plain(p, q):
    dev = p[0].device
    return tuple(rcb_add(FQ2_PLAIN, FQ2_PLAIN.const(bn254.B3_G2, dev), p, q))


def g2_double_point_plain(p, times: int = 1):
    _check_times(times)
    b3 = FQ2_PLAIN.const(bn254.B3_G2, p[0].device)
    for _ in range(times):
        p = tuple(rcb_double(FQ2_PLAIN, b3, p))
    return p


def _limbs(v: int) -> list:
    return [(v >> (32 * k)) & 0xFFFFFFFF for k in range(NLIMBS)]


@functools.lru_cache(None)
def _words(curve: str = "G1"):
    """The constant block: p, 2p, -p^-1 mod 2^32, then b3 in Montgomery
    form (G1: one Fq value; G2: c0, c1 and their sum as `add` forms it,
    the Karatsuba s of b3)."""
    spec = bn254.FQ
    q = spec.p
    w = _limbs(q) + _limbs(2 * q) + [spec.ninv32]
    if curve == "G1":
        return kernels.words(w + _limbs(spec.to_mont_int(bn254.B3_G1)))
    b0, b1 = (spec.to_mont_int(c) for c in bn254.B3_G2)
    s = b0 + b1
    s = s - 2 * q if s >= 2 * q else s
    return kernels.words(w + _limbs(b0) + _limbs(b1) + _limbs(s))


def _check(name, coords, edims):
    """Coordinates [..., 8, n] (edims = 1, G1) or [..., 2, 8, n] (2, G2)."""
    shape = coords[0].shape
    want = (NLIMBS,) if edims == 1 else (2, NLIMBS)
    if len(shape) < edims + 1 or tuple(shape[-1 - edims:-1]) != want:
        dims = "8" if edims == 1 else "2, 8"
        raise ValueError(
            f"{name}: expected [..., {dims}, n], got {tuple(shape)}")
    for c in coords:
        if c.device != coords[0].device or c.device.type != "cuda":
            raise ValueError(f"{name}: coordinates must share one CUDA device")
        if c.dtype != torch.int32 or c.shape != shape:
            raise TypeError(f"{name}: coordinates must be int32 of one shape")
        if not c.is_contiguous():
            raise ValueError(f"{name}: coordinates must be contiguous")


def _launch(name, curve, fn_name, coords, *args):
    """Launch `fn_name` of the curve's source on the coordinates; `args`
    (ints) go between the sizes and the constant block: the doubling's
    `times`, none for the addition."""
    edims, source = (1, "g1.cu") if curve == "G1" else (2, "g2.cu")
    _check(name, coords, edims)
    outs = [torch.empty_like(coords[0]) for _ in range(3)]
    total = coords[0].numel() // (NLIMBS * edims)
    if total == 0:
        return tuple(outs)
    fn = kernels.function(source, fn_name)
    ptrs = [c.data_ptr() for c in coords] + [o.data_ptr() for o in outs]
    err = fn(*ptrs, coords[0].shape[-1], total, *args,
             ctypes.cast(_words(curve), ctypes.c_void_p),
             torch.cuda.current_stream(coords[0].device).cuda_stream)
    kernels.check(source, err, name)
    kernels.count(name, total, *args)
    return tuple(outs)


def add_points(p, q):
    """K2 wrapper: complete G1 addition of coordinate tuples."""
    if p[0].device.type == "cpu":
        return add_points_plain(p, q)
    return _launch("g1_add", "G1", "lsk_g1_add", list(p) + list(q))


def double_point(p, times: int = 1):
    """K3 wrapper: `times` >= 1 complete G1 doublings of a coordinate
    tuple, in one launch on the card."""
    _check_times(times)
    if p[0].device.type == "cpu":
        return double_point_plain(p, times)
    return _launch("g1_double", "G1", "lsk_g1_double", list(p), times)


def g2_add_points(p, q):
    """K5 wrapper: complete G2 addition of coordinate tuples."""
    if p[0].device.type == "cpu":
        return g2_add_points_plain(p, q)
    return _launch("g2_add", "G2", "lsk_g2_add", list(p) + list(q))


def g2_double_point(p, times: int = 1):
    """K6 wrapper: `times` >= 1 complete G2 doublings of a coordinate
    tuple, in one launch on the card."""
    _check_times(times)
    if p[0].device.type == "cpu":
        return g2_double_point_plain(p, times)
    return _launch("g2_double", "G2", "lsk_g2_double", list(p), times)
