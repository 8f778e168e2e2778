"""K2/K3: the fused G1 add and double kernels, their plain versions and
wrappers.

Counterpart of `legosnark_tpu/curve/pallas_group.py`. The kernels are in
`csrc/g1.cu`; `add_points_plain` / `double_point_plain` run the same RCB
sequence (`group.rcb_add` / `rcb_double`) in torch ops on any device,
with the plain version of K1 for every product, and agree with the
kernels bit for bit: every intermediate stays in [0, 2p) under the
contract of `fields/limb.py`, at every batch width.

K3 takes `times` >= 1 and doubles each point that many times in one
launch (the plain version loops the single doubling).

Dispatch: CPU coordinates take the plain version, CUDA coordinates the
kernel. Coordinates are (x, y, z) int32 tensors `[..., 8, n]` of one shape.
Each launch is counted in `kernels.launches` and, by its width (points per
launch) and `times`, in `kernels.launch_widths`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels
from ..fields.limb import NLIMBS
from ..fields.ops import FqOps
from . import bn254
from .group import rcb_add, rcb_double

#: Fq ops that multiply with K1's plain version on every device
FQ_PLAIN = FqOps(bn254.FQ, plain=True)


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


@functools.lru_cache(None)
def _words():
    spec = bn254.FQ
    q = spec.p
    b3m = spec.to_mont_int(bn254.B3_G1)
    w = [(q >> (32 * k)) & 0xFFFFFFFF for k in range(NLIMBS)]
    w += [((2 * q) >> (32 * k)) & 0xFFFFFFFF for k in range(NLIMBS)]
    w += [spec.ninv32]
    w += [(b3m >> (32 * k)) & 0xFFFFFFFF for k in range(NLIMBS)]
    return kernels.words(w)


def _check(name, coords):
    shape = coords[0].shape
    if len(shape) < 2 or shape[-2] != NLIMBS:
        raise ValueError(f"{name}: expected [..., 8, n], got {tuple(shape)}")
    for c in coords:
        if c.device != coords[0].device or c.device.type != "cuda":
            raise ValueError(f"{name}: coordinates must share one CUDA device")
        if c.dtype != torch.int32 or c.shape != shape:
            raise TypeError(f"{name}: coordinates must be int32 of one shape")
        if not c.is_contiguous():
            raise ValueError(f"{name}: coordinates must be contiguous")


def _launch(name, fn_name, coords, *args):
    """Launch `fn_name` on the coordinates; `args` (ints) go between the
    sizes and the constant block: K3's `times`, none for K2."""
    _check(name, coords)
    outs = [torch.empty_like(coords[0]) for _ in range(3)]
    total = coords[0].numel() // NLIMBS
    if total == 0:
        return tuple(outs)
    fn = kernels.function("g1.cu", fn_name)
    ptrs = [c.data_ptr() for c in coords] + [o.data_ptr() for o in outs]
    err = fn(*ptrs, coords[0].shape[-1], total, *args,
             ctypes.cast(_words(), ctypes.c_void_p),
             torch.cuda.current_stream(coords[0].device).cuda_stream)
    kernels.check("g1.cu", err, name)
    kernels.count(name, total, *args)
    return tuple(outs)


def add_points(p, q):
    """K2 wrapper: complete G1 addition of coordinate tuples."""
    if p[0].device.type == "cpu":
        return add_points_plain(p, q)
    return _launch("g1_add", "lsk_g1_add", list(p) + list(q))


def double_point(p, times: int = 1):
    """K3 wrapper: `times` >= 1 complete G1 doublings of a coordinate
    tuple, in one launch on the card."""
    _check_times(times)
    if p[0].device.type == "cpu":
        return double_point_plain(p, times)
    return _launch("g1_double", "lsk_g1_double", list(p), times)
