"""Multilinear-extension engines: folds, eq tables, sumcheck round polys.

Counterpart of `legosnark_tpu/prototools/mle.py:39-266`. One primitive,
`fold(table, r)`, binds the top variable:
v'[p] = v[p | x0=0] + r*(v[p | x0=1] - v[p | x0=0]).

Conventions (as in the JAX package): a 2^d evaluation table lives on the
vector axis as [..., 8, 2^d]; variable i is bit d-1-i of the index
(big-endian), so binding variable 0 splits the table into contiguous
halves. Tables are Montgomery-form Fr; challenge lists are [8, d].
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..curve import bn254
from ..fields import limb as fl

FR = bn254.FR


def fold(v, r):
    """Bind the top variable to r [8, 1]: [..., 8, 2n] -> [..., 8, n]."""
    n = v.shape[-1] // 2
    lo, hi = v[..., :n], v[..., n:]
    return fl.add(FR, lo, fl.mont_mul(FR, r, fl.sub(FR, hi, lo)))


def eval_mle(v, rs):
    """v~(r_0..r_{d-1}) by d folds: v [..., 8, 2^d], rs [8, d] -> [..., 8, 1]."""
    d = rs.shape[-1]
    if v.shape[-1] != 1 << d:
        raise ValueError("table size does not match the point")
    for i in range(d):
        v = fold(v, rs[..., i : i + 1])
    return v


def mk_beta(rho):
    """eq table [8, 2^d]: out[p] = prod_i (p_i ? rho_i : 1 - rho_i), built
    innermost variable first so variable i lands at bit d-1-i."""
    d = rho.shape[-1]
    one = fl.one(FR, (), rho.device)
    t = one
    for k in range(d - 1, -1, -1):
        r = rho[..., k : k + 1]
        t0 = fl.mont_mul(FR, t, fl.sub(FR, one, r))
        t1 = fl.mont_mul(FR, t, r)
        t = torch.cat([t0, t1], dim=-1)
    return t


def eval_beta_point(rho, r):
    """beta(rho, r) = prod_i (rho_i r_i + (1 - rho_i)(1 - r_i)), the
    verifier's closed form of the eq table: rho, r [8, d] -> [8, 1]."""
    one = fl.one(FR, (), rho.device)
    rho, r = torch.broadcast_tensors(rho, r)
    x = torch.stack([rho, fl.sub(FR, one, rho)])
    y = torch.stack([r, fl.sub(FR, one, r)])
    t = fl.mont_mul(FR, x, y)
    return field_prod(fl.add(FR, t[0], t[1]))


def matrix_mle_fold(A, beta_rho):
    """v[c] = sum_r A[r, c] * eq(r, rho): A [n, 8, n] (rows leading),
    beta_rho = mk_beta(rho) [8, n] -> [8, n]."""
    b = beta_rho.movedim(-1, 0)[..., None]          # [n, 8, 1]
    return field_sum_leading(fl.mont_mul(FR, A, b))


def field_sum_leading(v):
    """Sum along axis 0 by pairwise tree reduction."""
    n = v.shape[0]
    while n > 1:
        half = n // 2
        s = fl.add(FR, v[0 : 2 * half : 2], v[1 : 2 * half : 2])
        if n % 2:
            s = torch.cat([s, v[-1:]], dim=0)
        v = s
        n = (n + 1) // 2
    return v[0]


def field_sum(v):
    """Sum along the vector axis: [..., 8, n] -> [..., 8, 1]."""
    n = v.shape[-1]
    while n > 1:
        h = n // 2
        s = fl.add(FR, v[..., :h], v[..., h : 2 * h])
        if n % 2:
            s = torch.cat([s, v[..., -1:]], dim=-1)
        v = s
        n = (n + 1) // 2
    return v


def field_prod(v):
    """Product along the vector axis: [..., 8, n] -> [..., 8, 1]."""
    n = v.shape[-1]
    while n > 1:
        h = n // 2
        s = fl.mont_mul(FR, v[..., :h], v[..., h : 2 * h])
        if n % 2:
            s = torch.cat([s, v[..., -1:]], dim=-1)
        v = s
        n = (n + 1) // 2
    return v


def matmul_mont(A, B, chunk: int = 4):
    """C = A*B over Fr: C[i, :, j] = sum_k A[i, :, k] * B[k, :, j] for
    A, B [n, 8, n] Montgomery. Blocked over k so that the
    [chunk, n, 8, n] product stays bounded (128 MB at n = 1024)."""
    n = A.shape[0]
    if n <= chunk:
        a = A.movedim(-1, 0)[..., None]              # [n(k), n(i), 8, 1]
        return field_sum_leading(fl.mont_mul(FR, a, B[:, None]))
    if n % chunk:
        raise ValueError("n must be a multiple of chunk")
    acc = fl.zero(FR, (n, n), A.device)
    for k0 in range(0, n, chunk):
        a_blk = A[:, :, k0 : k0 + chunk].movedim(-1, 0)[..., None]
        prod = fl.mont_mul(FR, a_blk, B[k0 : k0 + chunk, None])
        acc = fl.add(FR, acc, field_sum_leading(prod))
    return acc


def round_poly(tables):
    """One sumcheck round polynomial of a product of k tables:
    h(X) = sum_p prod_t (lo_t[p] + X*(hi_t[p] - lo_t[p])).
    tables [k, 8, 2n] -> coefficients [8, k+1], ascending."""
    k = tables.shape[0]
    n = tables.shape[-1] // 2
    lo = tables[..., :n]
    slope = fl.sub(FR, tables[..., n:], lo)
    coeffs = torch.stack([lo[0], slope[0]])          # [2, 8, n]
    for t in range(1, k):
        c_lo = fl.mont_mul(FR, coeffs, lo[t][None])
        c_sl = fl.mont_mul(FR, coeffs, slope[t][None])
        zerorow = fl.zero(FR, (1, n), tables.device)
        coeffs = fl.add(FR, torch.cat([c_lo, zerorow]),
                        torch.cat([zerorow, c_sl]))
    summed = field_sum(coeffs)                       # [k+1, 8, 1]
    return summed[..., 0].movedim(0, -1)


class SumcheckRounds(NamedTuple):
    h_coeffs: torch.Tensor   # [d, 8, k+1] round polynomials, ascending
    finals: torch.Tensor     # [k, 8, 1] each table folded to a point
    zs: torch.Tensor         # [8, d+1] claimed partial sums z_0..z_d


def prove_rounds(tables, challenges) -> SumcheckRounds:
    """All d sumcheck rounds of sum_p prod_t T_t[p] with injected
    challenges: tables [k, 8, 2^d], challenges [8, d]."""
    d = challenges.shape[-1]
    if tables.shape[-1] != 1 << d:
        raise ValueError("table size does not match the challenges")
    hs, zs = [], []
    for i in range(d):
        h = round_poly(tables)                       # [8, k+1]
        hs.append(h)
        r = challenges[..., i : i + 1]
        zs.append(poly_eval(h, r))                   # z_{i+1} = h_i(r_i)
        tables = fold(tables, r)
    dev = tables.device
    z0 = fl.add(FR, poly_eval(hs[0], fl.zero(FR, (), dev)),
                poly_eval(hs[0], fl.one(FR, (), dev)))
    return SumcheckRounds(h_coeffs=torch.stack(hs), finals=tables,
                          zs=torch.cat([z0] + zs, dim=-1))


def poly_eval(coeffs, x):
    """Horner evaluation of [..., 8, m] ascending coefficients at x [8, 1]."""
    m = coeffs.shape[-1]
    acc = coeffs[..., m - 1 : m]
    for i in range(m - 2, -1, -1):
        acc = fl.add(FR, fl.mont_mul(FR, acc, x), coeffs[..., i : i + 1])
    return acc
