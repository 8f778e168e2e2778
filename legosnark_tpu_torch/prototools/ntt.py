"""Radix-2 NTT over Fr and evaluation-domain queries.

Counterpart of `legosnark_tpu/prototools/ntt.py`: NTT and inverse NTT,
their coset forms, division by the vanishing polynomial on the coset,
polynomial products, Z(t) and all Lagrange polynomials at a point.

Decimation in time, one stage per step of a Python loop over the log2(n)
stages: each stage is one Montgomery product of width n/2 over the whole
batch (kernel K1 on the card) and one add and one sub, with the butterfly
pairs taken by reshapes of the vector axis. Inputs are Montgomery limbs
[..., 8, n]; leading axes transform several vectors at once. Twiddle and
power tables are computed once per (base, size, device) from Python
ints on the host (`power_limbs`) and kept on the device.

Each transform, plain or coset, is one span `ntt` (`utils/trace`;
attributes: size, batch, inverse, coset).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..curve import bn254
from ..fields import limb as fl
from ..utils import trace

FR = bn254.FR
R = bn254.R


def power_limbs(base: int, count: int) -> np.ndarray:
    """Montgomery limbs [8, count] of base^0 .. base^(count - 1), on the
    host (not cached: keygen passes its trapdoor). The recurrence runs on
    the Montgomery forms base^i 2^256 mod r themselves."""
    vals = [FR.to_mont_int(1)] * count
    for i in range(1, count):
        vals[i] = vals[i - 1] * base % R
    return fl.ints_to_limbs(vals)


@functools.lru_cache(None)
def _powers_on(base: int, log_n: int, device: torch.device) -> torch.Tensor:
    return fl.tensor(power_limbs(base, 1 << log_n), device)


def _powers(base: int, log_n: int, device) -> torch.Tensor:
    """[8, 2^log_n] Montgomery powers of `base` on `device` (cached; do
    not write)."""
    return _powers_on(base % R, log_n, torch.device(device))


def _stage_twiddle(log_n: int, s: int, inverse: bool, device):
    """Twiddles w_m^j, j < m/2, of stage s (m = 2^s): [8, m/2]."""
    root = bn254.fr_two_adic_root(log_n)
    if inverse:
        root = pow(root, R - 2, R)
    return _powers(pow(root, (1 << log_n) >> s, R), s - 1, device)


@functools.lru_cache(None)
def _bitrev_on(log_n: int, device: torch.device) -> torch.Tensor:
    idx = np.arange(1 << log_n)
    rev = np.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return torch.from_numpy(rev).to(device)


def _log2(n: int) -> int:
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError(f"NTT size {n} is not a power of two")
    return log_n


def _span(a, inverse: bool, coset: bool):
    n = a.shape[-1]
    return trace.span("ntt", size=n, batch=a.numel() // (fl.NLIMBS * n),
                      inverse=inverse, coset=coset)


def _ntt(a, inverse: bool):
    n = a.shape[-1]
    log_n = _log2(n)
    a = torch.index_select(a, -1, _bitrev_on(log_n, a.device))
    lead = a.shape[:-1]                                 # [..., 8]
    for s in range(1, log_n + 1):
        m = 1 << s
        x = a.reshape(lead + (n // m, m))
        even = x[..., : m // 2].reshape(lead + (n // 2,))
        odd = x[..., m // 2 :].reshape(lead + (n // 2,))
        tw = _stage_twiddle(log_n, s, inverse, a.device)    # [8, m/2]
        tw = tw[:, None, :].expand(fl.NLIMBS, n // m, m // 2)
        odd = fl.mont_mul(FR, odd, tw.reshape(fl.NLIMBS, n // 2))
        hi = fl.add(FR, even, odd).reshape(lead + (n // m, m // 2))
        lo = fl.sub(FR, even, odd).reshape(lead + (n // m, m // 2))
        a = torch.cat([hi, lo], dim=-1).reshape(lead + (n,))
    if inverse:
        a = fl.mont_mul(FR, a, fl.const_mont(FR, pow(n, R - 2, R), a.device))
    return a


def ntt(a, inverse: bool = False):
    """In-order NTT of Montgomery coefficients [..., 8, n] -> evaluations
    at the powers of the 2^log_n root `bn254.fr_two_adic_root`; inverse:
    evaluations -> coefficients, the 1/n scale included."""
    with _span(a, inverse, False):
        return _ntt(a, inverse)


def intt(a):
    with _span(a, True, False):
        return _ntt(a, True)


def coset_ntt(a):
    """Evaluations on the coset g<w>, g = `fr_multiplicative_generator`."""
    with _span(a, False, True):
        shift = _powers(bn254.fr_multiplicative_generator(),
                        _log2(a.shape[-1]), a.device)
        return _ntt(fl.mont_mul(FR, a, shift), False)


def coset_intt(a):
    with _span(a, True, True):
        g_inv = pow(bn254.fr_multiplicative_generator(), R - 2, R)
        return fl.mont_mul(FR, _ntt(a, True),
                           _powers(g_inv, _log2(a.shape[-1]), a.device))


def divide_by_z_on_coset(evals):
    """Coset evaluations divided by Z(x) = x^n - 1, which is the constant
    g^n - 1 on the coset."""
    n = evals.shape[-1]
    g = bn254.fr_multiplicative_generator()
    zinv = pow((pow(g, n, R) - 1) % R, R - 2, R)
    return fl.mont_mul(FR, evals, fl.const_mont(FR, zinv, evals.device))


def poly_mul_ntt(a, b):
    """Product of coefficient vectors [..., 8, na] and [..., 8, nb] by
    zero-padded NTTs -> [..., 8, na + nb - 1]."""
    na, nb = a.shape[-1], b.shape[-1]
    n = 1 << max(na + nb - 2, 0).bit_length()

    def pad(v):
        return torch.constant_pad_nd(v, (0, n - v.shape[-1]))

    return intt(fl.mont_mul(FR, ntt(pad(a)), ntt(pad(b))))[..., : na + nb - 1]


def vanishing_at(n: int, t_mont):
    """Z(t) = t^n - 1."""
    return fl.sub(FR, fl.mont_pow(FR, t_mont, n),
                  fl.one(FR, (), t_mont.device))


def all_lagrange_at(n: int, t_mont):
    """The n Lagrange polynomials of the domain at t [8, 1] -> [8, n]:
    l_i(t) = (t^n - 1) w^i / (n (t - w^i)), one batched inversion."""
    dev = t_mont.device
    ws = _powers(bn254.fr_two_adic_root(_log2(n)), _log2(n), dev)
    scale = fl.mont_mul(FR, vanishing_at(n, t_mont),
                        fl.const_mont(FR, pow(n, R - 2, R), dev))
    num = fl.mont_mul(FR, ws, scale)
    return fl.mont_mul(FR, num, fl.inv(FR, fl.sub(FR, t_mont, ws)))
