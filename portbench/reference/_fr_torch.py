"""Fr arithmetic in plain torch for the references' wide work: MLE folds,
mat-vec products and the MiMC tree digest of a million lanes.

An element batch is an int64 tensor [16, n]: sixteen 16-bit limbs, least
significant first, always canonical (below r). Products are Montgomery
products with R = 2^256 by 16-bit digit-serial reduction, so every column
sum stays below 2^38. No kernel, no cache: each step is a torch operation
on whole columns, on whatever device the tensors live on.
"""
from __future__ import annotations

import functools

import torch

from . import _bn254 as hb

R = hb.R
BITS = 16
LIMBS = 16
MASK = (1 << BITS) - 1
NINV = (-pow(R, -1, 1 << BITS)) % (1 << BITS)
#: below this many lanes the tree digest continues in host ints
HOST_DIGEST_LANES = 4096


@functools.lru_cache(None)
def _col(x: int, device: torch.device) -> torch.Tensor:
    return torch.tensor([(x >> (BITS * k)) & MASK for k in range(LIMBS)],
                        dtype=torch.int64, device=device)[:, None]


def const(x: int, device) -> torch.Tensor:
    """[16, 1] limbs of x mod r (cached; do not write)."""
    return _col(x % R, torch.device(device))


def mont_const(x: int, device) -> torch.Tensor:
    return const(x * hb.MONT, device)


def from_ints(xs, device) -> torch.Tensor:
    xs = [int(x) % R for x in xs]
    return torch.tensor([[(x >> (BITS * k)) & MASK for x in xs]
                         for k in range(LIMBS)], dtype=torch.int64,
                        device=device).reshape(LIMBS, len(xs))


def to_ints(x: torch.Tensor) -> list:
    """[16, n] limbs (any column sums) -> ints, not reduced."""
    cols = x.detach().cpu().tolist()
    return [sum(int(cols[k][i]) << (BITS * k) for k in range(len(cols)))
            for i in range(x.shape[-1])]


def from_words(t: torch.Tensor) -> torch.Tensor:
    """Canonical 32-bit word patterns [..., 8, n] int32 -> [..., 16, n]."""
    w = t.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & MASK, w >> BITS], dim=-2).reshape(
        t.shape[:-2] + (LIMBS, t.shape[-1]))


def _carry(t: torch.Tensor) -> torch.Tensor:
    """Propagate carries (and borrows) up the limb axis 0, in place; the
    top limb keeps the rest, with its sign."""
    for k in range(t.shape[0] - 1):
        t[k + 1] += t[k] >> BITS
        t[k] &= MASK
    return t


def _r_like(t: torch.Tensor) -> torch.Tensor:
    """r's limbs shaped to broadcast against t's limb axis 0."""
    return _col(R, t.device).view((LIMBS,) + (1,) * (t.dim() - 1))


def _reduce_once(s: torch.Tensor) -> torch.Tensor:
    """s in [0, 2r) with carried limbs -> s mod r."""
    d = _carry(s[:LIMBS] - _r_like(s))
    return torch.where(d[LIMBS - 1] >= 0, d, s[:LIMBS])


def add(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return _reduce_once(_carry(a + b))


def sub(a, b):
    a, b = torch.broadcast_tensors(a, b)
    d = _carry(a - b)
    return torch.where(d[LIMBS - 1] < 0, _carry(d + _r_like(d)), d)


def mont_mul(a, b):
    """a * b / 2^256 mod r for a < 2r, b < r (or the other way round)."""
    a, b = torch.broadcast_tensors(a, b)
    t = torch.zeros((2 * LIMBS + 1,) + a.shape[1:], dtype=torch.int64,
                    device=a.device)
    for i in range(LIMBS):
        t[i : i + LIMBS] += a[i] * b
    p = _r_like(t)
    for i in range(LIMBS):
        m = ((t[i] & MASK) * NINV) & MASK
        t[i : i + LIMBS] += m * p
        t[i + 1] += t[i] >> BITS
    return _reduce_once(_carry(t[LIMBS:]))


def to_mont(a):
    return mont_mul(a, const(hb.MONT * hb.MONT, a.device))


def from_mont(a):
    return mont_mul(a, const(1, a.device))


def fold(vals, x_m):
    """Bind the top variable of [16, 2h] Montgomery tables to x_m [16, 1]."""
    h = vals.shape[-1] // 2
    lo, hi = vals[:, :h], vals[:, h:]
    return add(lo, mont_mul(sub(hi, lo), x_m))


def mle_eval(vals_m, pts: list) -> list:
    """Fold Montgomery tables [16, 2^d] at the ints of pts (top variables
    first) -> the remaining table's canonical ints."""
    for x in pts:
        vals_m = fold(vals_m, mont_const(x, vals_m.device))
    return hb.from_mont(to_ints(vals_m), R)


def sum_mod(vals) -> list:
    """Sum of [16, ..., m] canonical values over the last axis, mod r."""
    return [v % R for v in to_ints(vals.sum(dim=-1).reshape(LIMBS, -1))]


def permute(x_m):
    """The MiMC permutation on Montgomery lanes [16, n]."""
    for c in hb._CONSTS:
        t = add(x_m, mont_const(c, x_m.device))
        t4 = mont_mul(t, t)
        t4 = mont_mul(t4, t4)
        x_m = mont_mul(t4, t)
    return x_m


def tree_digest(lanes_m) -> int:
    """`_bn254.tree_digest` of Montgomery lanes [16, n], the wide levels
    here and the last HOST_DIGEST_LANES in host ints."""
    h = permute(lanes_m)
    while h.shape[-1] > HOST_DIGEST_LANES:
        m = h.shape[-1]
        half = m // 2
        comb = add(h[:, :half], h[:, half : 2 * half])
        if m % 2:
            comb = torch.cat([comb, h[:, -1:]], dim=-1)
        h = permute(comb)
    vals = hb.from_mont(to_ints(h), R)
    while len(vals) > 1:
        half = len(vals) // 2
        comb = [(a + b) % R for a, b in zip(vals[:half], vals[half : 2 * half])]
        if len(vals) % 2:
            comb.append(vals[-1])
        vals = [hb.permute(v) for v in comb]
    return vals[0]
