"""K1: the Montgomery product kernel, its plain version and its wrapper.

Counterpart of `legosnark_tpu/fields/pallas_limb.py`. The kernel is
`csrc/mont_mul.cu`; `mont_mul_plain` computes the same function with
torch ops on any device, and the two agree bit for bit: both return
(a*b + M*p)/R with the unique M in [0, R), with no final subtraction.

Dispatch: a CPU tensor takes the plain version, a CUDA tensor the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels
from .limb import (FieldSpec, NLIMBS, consts, exact, narrow, pad_top,
                   widen)


def _split16(x):
    """int32 limbs [..., 8, V] -> 16-bit halves, int64 [..., 16, V]."""
    u = widen(x)
    h = torch.stack([u & 0xFFFF, u >> 16], dim=-2)
    return h.reshape(x.shape[:-2] + (2 * NLIMBS, x.shape[-1]))


@functools.lru_cache(None)
def _diagonals(A: int, B: int, device: torch.device) -> torch.Tensor:
    """i + j for the flattened outer product's entry i*B + j."""
    return (torch.arange(A)[:, None] + torch.arange(B)).reshape(-1).to(device)


def _conv(x, y):
    """Product columns out[k] = sum_{i+j=k} x[i]*y[j] along axis -2:
    [..., A, V] x [..., B, V] -> [..., A+B-1, V]: the outer product's
    entries added into their anti-diagonals by one `index_add_`."""
    A, B = x.shape[-2], y.shape[-2]
    outer = (x[..., :, None, :] * y[..., None, :, :]).flatten(-3, -2)
    out = torch.zeros(outer.shape[:-2] + (A + B - 1, outer.shape[-1]),
                      dtype=outer.dtype, device=outer.device)
    return out.index_add_(-2, _diagonals(A, B, outer.device), outer)


def mont_mul_plain(spec: FieldSpec, a, b):
    """a*b/R in torch ops, on 16-bit halves so every column fits int64.

    t = a*b has columns < 16*2^32 = 2^36; the low half of t times
    -p^-1 has columns < 16*2^36*2^16 = 2^56 (three carry passes reach
    limbs < 2^16 + 2^9), and t + M*p columns stay < 2^37 (two passes
    reach limbs < 2^16 + 2^6), within `exact`'s 2^17 - 2."""
    a, b = torch.broadcast_tensors(a, b)
    c = consts(spec, a.device)
    h = 2 * NLIMBS
    t = _conv(_split16(a), _split16(b))                        # 31 columns
    m = exact(_conv(t[..., :h, :], c["ninv16"][:, None])[..., :h, :], 16, 3)
    u = exact(pad_top(t) + pad_top(_conv(m, c["p16"])), 16, 2)  # 32 limbs
    hi = u[..., h:, :]                                          # (t + Mp)/R
    return narrow(hi[..., 0::2, :] | (hi[..., 1::2, :] << 16))


@functools.lru_cache(None)
def field_words(p: int):
    """The kernels' Field block: p, 2p and -p^-1 mod 2^32 as 17 words."""
    spec = FieldSpec(p)
    w = [(p >> (32 * k)) & 0xFFFFFFFF for k in range(NLIMBS)]
    w += [((2 * p) >> (32 * k)) & 0xFFFFFFFF for k in range(NLIMBS)]
    return kernels.words(w + [spec.ninv32])


def mont_mul(spec: FieldSpec, a, b):
    """K1 wrapper: a*b/R for int32 limbs broadcastable to [..., 8, n].

    The broadcast is materialised (e.g. a [8, 1] scalar against [8, n])."""
    a, b = torch.broadcast_tensors(a, b)
    if a.device.type == "cpu":
        return mont_mul_plain(spec, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"mont_mul: unsupported device {a.device}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("mont_mul: limbs must be int32")
    if a.dim() < 2 or a.shape[-2] != NLIMBS:
        raise ValueError(f"mont_mul: expected [..., 8, n], got {tuple(a.shape)}")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    total = a.numel() // NLIMBS
    if total == 0:
        return out
    fn = kernels.function("mont_mul.cu", "lsk_mont_mul")
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[-1], total,
             ctypes.cast(field_words(spec.p), ctypes.c_void_p),
             torch.cuda.current_stream(a.device).cuda_stream)
    kernels.check("mont_mul.cu", err, "mont_mul")
    kernels.count("mont_mul", total)
    return out
