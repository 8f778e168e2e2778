"""Optimal ate pairing on BN254, batched over the vector axis.

Counterpart of `legosnark_tpu/curve/pairing.py`: homogeneous-projective
doubling and addition steps on the D-type twist (Costello-Lange-Naehrig),
line values in the sparse form c0 + (c3 + c4 v) w folded in with
`Fq12Ops.mul_by_034`, a loop over the bits of 6x+2, and the x-adic
addition chain of the final exponentiation's hard part.

Dispatch, as in `curve/cuda_group`: on CUDA tensors `miller_loop`,
`final_exp`, `pairing`, `pairing_checks` and `pairing_product_is_one`
run the hand-written kernels of `csrc/pairing.cu`, K7
(`pairing_miller_kernel`, one thread per pair: the legs made affine, an
identity leg's Miller value 1, the Miller loop) and K8
(`pairing_final_exp_kernel`, one thread per product: a group's Miller
values multiplied, the final exponentiation), counted in
`kernels.launches` as `pairing_miller` (per pair) and `pairing_final_exp`
(per product). A pairing check is one launch of each. On CPU tensors they
run `miller_loop_plain` and `final_exp_plain`, torch code batched over
leading axes and the vector axis, whose independent Fq2 products of each
step run as one stacked call; its loops branch on the static bits in
Python. The kernels write canonical values; the plain versions' values
are the same field elements.

Identities are masked at the API boundary: on the plain path an identity
leg is replaced by the generator and its Miller value by 1.
`pairing_checks` evaluates several products of pairings with one Miller
loop over all their pairs and one final exponentiation of width K; each
product is still checked on its own. The JAX package's per-pad-width
jitted pieces are not carried over: nothing here is compiled ahead of
time.

Spans (`utils/trace`): `pairing.checks` around each `pairing_checks`
and `pairing_product_is_one` (attributes: pairs in all, products), with the
children `pairing.miller` (the Miller values: K7 on the card; affine legs,
Miller loop and the groups' products on the CPU) and `pairing.final_exp`
(K8, the products included, on the card).

The final exponentiation is the JAX package's: its hard part computes
f^(2x(6x^2 + 3x + 1)(q^4 - q^2 + 1)/r), a fixed power (coprime to r) of
the reduced pairing f^((q^12 - 1)/r). So `pairing` is bilinear and
non-degenerate, and is that power of `tests/oracle.py`'s pairing.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import kernels
from ..fields.limb import NLIMBS
from ..fields.tower import Fq6Ops, Fq12Ops
from ..utils import trace
from . import bn254
from .group import (FQ2_OPS, FQ_OPS, G1, G2, Point, point_concat,
                    to_affine_batch)

F1 = FQ_OPS
F2 = FQ2_OPS
F6 = Fq6Ops(F2)
F12 = Fq12Ops(F6)

_ATE_BITS = [int(b) for b in bin(6 * bn254.BN_X + 2)[3:]]
_X_BITS = [int(b) for b in bin(bn254.BN_X)[3:]]


@functools.lru_cache(None)
def _consts(device: torch.device) -> dict:
    """Frobenius factors as [2, 3, 2, 8, 1] Fq12-shaped Fq2 tensors (the
    factor of v^i w^j at [j, i]), the twist-Frobenius factors, 1/2 and
    the twist's b."""
    fc = bn254.frob_coeffs()
    q = bn254.Q
    gam = {}
    for n in (1, 2, 3):
        rows = [torch.stack([F2.const(fc[n][2 * i + j], device)
                             for i in range(3)]) for j in range(2)]
        gam[n] = torch.stack(rows)
    return {
        "gamma": gam,
        "twist_qx": F2.const(bn254._fq2_pow(bn254.XI, (q - 1) // 3), device),
        "twist_qy": F2.const(bn254._fq2_pow(bn254.XI, (q - 1) // 2), device),
        "two_inv": F1.const(pow(2, -1, q), device),
        "b_twist": F2.const(bn254.B_G2, device),
    }


def _bits_below_top(v: int) -> list:
    """The bits of v below its top bit, low word first, and their count."""
    n = v.bit_length() - 1
    low = v - (1 << n)
    return [low & 0xFFFFFFFF, low >> 32, n]


@functools.lru_cache(None)
def _words():
    """K7/K8's constant block (`PairingConsts` in csrc/pairing.cu): p, 2p,
    -p^-1 mod 2^32, 1 in Montgomery form, then `_consts`' 1/2, b', the
    twist-Frobenius factors and the three Frobenius tables, then the bits
    of 6x + 2 and of x below their top bits."""
    spec = bn254.FQ
    q = spec.p
    c = _consts(torch.device("cpu"))

    def limbs(v: int) -> list:
        return [(v >> (32 * k)) & 0xFFFFFFFF for k in range(NLIMBS)]

    def flat(t) -> list:
        return [v & 0xFFFFFFFF for v in t.flatten().tolist()]

    w = limbs(q) + limbs(2 * q) + [spec.ninv32] + limbs(spec.R % q)
    for t in (c["two_inv"], c["b_twist"], c["twist_qx"], c["twist_qy"],
              *(c["gamma"][n] for n in (1, 2, 3))):
        w += flat(t)
    w += _bits_below_top(6 * bn254.BN_X + 2) + _bits_below_top(bn254.BN_X)
    assert len(w) == 375   # the words of PairingConsts
    return kernels.words(w)


def frobenius(a, n: int):
    """q^n-power Frobenius on Fq12 [..., 2, 3, 2, 8, V]: conjugate every
    Fq2 coefficient for odd n, then scale the coefficient of v^i w^j by
    gamma_n[2i + j] (one stacked Fq2 product)."""
    if n % 2 == 1:
        a = F2.conj(a)
    return F2.mul(a, _consts(a.device)["gamma"][n])


# ---------------------------------------------------------------------------
# Miller loop
# ---------------------------------------------------------------------------


def _dbl_step(rx, ry, rz):
    """CLN doubling step on the twist: the new R and the line
    coefficients (c0, c3, c4), c0 to be scaled by P.y and c3 by P.x."""
    k = _consts(rx.device)
    s = F2.add(ry, rz)
    xy, b, c, j, hh = F2.mul(torch.stack([rx, ry, rz, rx, s]),
                             torch.stack([ry, ry, rz, rx, s])).unbind(0)
    c3x = F2.add(F2.add(c, c), c)
    e = F2.mul(k["b_twist"], c3x)
    a = F2.mul_base(xy, k["two_inv"])
    f = F2.add(F2.add(e, e), e)
    h = F2.sub(hh, F2.add(b, c))
    g = F2.mul_base(F2.add(b, f), k["two_inv"])
    g2, e2, nx, nz = F2.mul(torch.stack([g, e, a, b]),
                            torch.stack([g, e, F2.sub(b, f), h])).unbind(0)
    ny = F2.sub(g2, F2.add(F2.add(e2, e2), e2))
    c3 = F2.add(F2.add(j, j), j)
    return (nx, ny, nz), (F2.neg(h), c3, F2.sub(e, b))


def _add_step(rx, ry, rz, qx, qy):
    """CLN mixed addition step R += Q (Q affine on the twist)."""
    yz, xz = F2.mul(torch.stack(torch.broadcast_tensors(qy, qx)),
                    torch.stack([rz, rz])).unbind(0)
    theta = F2.sub(ry, yz)
    lam = F2.sub(rx, xz)
    c, d = F2.mul(torch.stack([theta, lam]),
                  torch.stack([theta, lam])).unbind(0)
    e, f, g = F2.mul(torch.stack([lam, rz, rx]),
                     torch.stack([d, c, d])).unbind(0)
    h = F2.sub(F2.add(e, f), F2.add(g, g))
    qx, qy = torch.broadcast_tensors(qx, qy)
    nx, t, ery, nz, tq, lq = F2.mul(
        torch.stack([lam, theta, e, rz, theta, lam]),
        torch.stack([h, F2.sub(g, h), ry, e, qx, qy])).unbind(0)
    ny = F2.sub(t, ery)
    return (nx, ny, nz), (lam, F2.neg(theta), F2.sub(tq, lq))


def _ell(f, coeffs, px, py):
    """Fold a line value into f: f *= (c0*P.y) + (c3*P.x + c4 v) w."""
    c0, c3, c4 = coeffs
    s0, s3 = F1.mul(torch.stack([c0, c3]),
                    torch.stack([py, px])[..., None, :, :]).unbind(0)
    return F12.mul_by_034(f, s0, s3, c4)


def _mul_by_char(qx, qy):
    """Untwist-Frobenius-twist endomorphism on an affine twist point."""
    k = _consts(qx.device)
    return F2.mul(torch.stack([F2.conj(qx), F2.conj(qy)]),
                  torch.stack([k["twist_qx"].expand_as(qx),
                               k["twist_qy"].expand_as(qy)])).unbind(0)


def miller_loop_plain(px, py, qx, qy):
    """Batched Miller loop in torch ops. px, py: affine G1 coordinates
    [..., 8, V]; qx, qy: affine G2 coordinates [..., 2, 8, V]. Returns
    Fq12 [..., V]."""
    batch = F1.batch_shape(px)
    dev = px.device
    f = F12.one(batch, dev)
    rx, ry, rz = qx, qy, F2.bcast(F2.one((), dev), batch)
    for bit in _ATE_BITS:
        f = F12.sqr(f)
        (rx, ry, rz), cd = _dbl_step(rx, ry, rz)
        f = _ell(f, cd, px, py)
        if bit:
            (rx, ry, rz), ca = _add_step(rx, ry, rz, qx, qy)
            f = _ell(f, ca, px, py)
    # the last two addition steps, with q1 = pi(Q) and q2 = -pi^2(Q)
    q1x, q1y = _mul_by_char(qx, qy)
    q2x, q2y = _mul_by_char(q1x, q1y)
    (rx, ry, rz), c1 = _add_step(rx, ry, rz, q1x, q1y)
    f = _ell(f, c1, px, py)
    _, c2 = _add_step(rx, ry, rz, q2x, F2.neg(q2y))
    return _ell(f, c2, px, py)


# ---------------------------------------------------------------------------
# Final exponentiation
# ---------------------------------------------------------------------------


def _exp_by_neg_x(f):
    """f^(-x) for the BN parameter x (f in the cyclotomic subgroup, where
    the inverse is the conjugate)."""
    acc = f
    for bit in _X_BITS:
        acc = F12.sqr(acc)
        if bit:
            acc = F12.mul(acc, f)
    return F12.conj(acc)


def final_exp_plain(f):
    """In torch ops: easy part f^((q^6 - 1)(q^2 + 1)), then the hard
    part's x-adic chain (Fuentes-Castaneda et al., as in the JAX package,
    libff and arkworks)."""
    f = F12.mul(F12.conj(f), F12.inv(f))
    r = F12.mul(frobenius(f, 2), f)
    y0 = _exp_by_neg_x(r)
    y1 = F12.sqr(y0)
    y2 = F12.sqr(y1)
    y3 = F12.mul(y2, y1)
    y4 = _exp_by_neg_x(y3)
    y5 = F12.sqr(y4)
    y6 = F12.conj(_exp_by_neg_x(y5))
    y3 = F12.conj(y3)
    y7 = F12.mul(y6, y4)
    y8 = F12.mul(y7, y3)
    y9 = F12.mul(y8, y1)
    y10 = F12.mul(y8, y4)
    y11 = F12.mul(y10, r)
    y13 = F12.mul(frobenius(y9, 1), y11)
    y14 = F12.mul(frobenius(y8, 2), y13)
    y15 = frobenius(F12.mul(F12.conj(r), y9), 3)
    return F12.mul(y15, y14)


# ---------------------------------------------------------------------------
# K7 and K8
# ---------------------------------------------------------------------------


def _check(name, ts, elem):
    """Contiguous int32 tensors [..., *elem, n] of one CUDA device."""
    for t in ts:
        if t.device.type != "cuda" or t.device != ts[0].device:
            raise ValueError(f"{name}: tensors must share one CUDA device")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name}: tensors must be contiguous int32")
        if t.dim() <= len(elem) or t.shape[-1 - len(elem):-1] != elem:
            dims = ", ".join(map(str, elem))
            raise ValueError(f"{name}: expected [..., {dims}, n], got "
                             f"{tuple(t.shape)}")


def miller_values(g1_points: Point, g2_points: Point):
    """K7: the Miller value of each pair of projective legs, 1 where
    either is the identity. G1 [..., 8, n] and G2 [..., 2, 8, n] (batch
    shapes broadcast) -> Fq12 [..., 2, 3, 2, 8, n], one launch."""
    shape = torch.broadcast_shapes(F1.batch_shape(g1_points.x),
                                   F2.batch_shape(g2_points.x))
    lead, n = shape[:-1], shape[-1]
    g1 = [t.expand(lead + (NLIMBS, n)).contiguous() for t in g1_points]
    g2 = [t.expand(lead + (2, NLIMBS, n)).contiguous() for t in g2_points]
    _check("pairing_miller", g1, (NLIMBS,))
    _check("pairing_miller", g2, (2, NLIMBS))
    dev = g1[0].device
    out = torch.empty(lead + (2, 3, 2, NLIMBS, n), dtype=torch.int32,
                      device=dev)
    total = math.prod(shape)
    if total == 0:
        return out
    fn = kernels.function("pairing.cu", "lsk_pairing_miller")
    err = fn(*(t.data_ptr() for t in g1 + g2), out.data_ptr(), n, total,
             ctypes.cast(_words(), ctypes.c_void_p),
             torch.cuda.current_stream(dev).cuda_stream)
    kernels.check("pairing.cu", err, "pairing_miller")
    kernels.count("pairing_miller", total)
    return out


def final_exps(fs, idx, n_out: int = 1):
    """K8: for each row of idx [K, width] (integer), the final
    exponentiation of the product of the Miller values fs [..., 2, 3, 2,
    8, n] it indexes, counted over fs's batch flattened (n fastest); an
    index outside [0, batch) stands for 1. -> Fq12 [K / n_out, 2, 3, 2,
    8, n_out], one launch."""
    fs = fs.contiguous()
    _check("pairing_final_exp", [fs], (2, 3, 2, NLIMBS))
    dev = fs.device
    idx = idx.to(device=dev, dtype=torch.int64).contiguous()
    products, width = idx.shape
    out = torch.empty((products // n_out, 2, 3, 2, NLIMBS, n_out),
                      dtype=torch.int32, device=dev)
    if products == 0:
        return out
    n_in = fs.shape[-1]
    fn = kernels.function("pairing.cu", "lsk_pairing_final_exp")
    err = fn(fs.data_ptr(), n_in, fs.numel() // (12 * NLIMBS),
             idx.data_ptr(), products, width, out.data_ptr(), n_out,
             ctypes.cast(_words(), ctypes.c_void_p),
             torch.cuda.current_stream(dev).cuda_stream)
    kernels.check("pairing.cu", err, "pairing_final_exp")
    kernels.count("pairing_final_exp", products)
    return out


# ---------------------------------------------------------------------------
# High-level API
# ---------------------------------------------------------------------------


def miller_loop(px, py, qx, qy):
    """Miller loop of affine pairs, batched: G1 px, py [..., 8, V], G2 qx,
    qy [..., 2, 8, V] -> Fq12 [..., V]; K7 with z = 1 on the card."""
    if px.device.type == "cpu":
        return miller_loop_plain(px, py, qx, qy)
    dev = px.device
    z1 = F1.bcast(F1.one((), dev), F1.batch_shape(px))
    z2 = F2.bcast(F2.one((), dev), F2.batch_shape(qx))
    return miller_values(Point(px, py, z1), Point(qx, qy, z2))


def final_exp(f):
    """The final exponentiation of each Fq12 of f [..., V]; K8 on the
    card, one product of one value per element."""
    if f.device.type == "cpu":
        return final_exp_plain(f)
    total = f.numel() // (12 * NLIMBS)
    idx = torch.arange(total, device=f.device).view(total, 1)
    return final_exps(f, idx, f.shape[-1]).view(f.shape)


def pairing(px, py, qx, qy):
    """Reduced optimal ate pairing e(P, Q) of affine coordinates, batched."""
    return final_exp(miller_loop(px, py, qx, qy))


def g1_affine(p: Point):
    """Projective G1 -> (x, y, valid); an identity becomes the generator's
    coordinates with valid False, so that its pairing stays defined."""
    a = to_affine_batch(G1, p)
    valid = ~G1.is_identity(p)
    dev = p.x.device
    gx, gy = (F1.bcast(F1.const(c, dev), F1.batch_shape(p.x))
              for c in bn254.G1_GEN)
    return F1.select(valid, a.x, gx), F1.select(valid, a.y, gy), valid


def g2_affine(p: Point):
    a = to_affine_batch(G2, p)
    valid = ~G2.is_identity(p)
    dev = p.x.device
    gx, gy = (F2.bcast(F2.const(c, dev), F2.batch_shape(p.x))
              for c in (bn254.G2_GEN_X, bn254.G2_GEN_Y))
    return F2.select(valid, a.x, gx), F2.select(valid, a.y, gy), valid


def _tree_prod(fs):
    """Product of an Fq12 batch along the vector axis -> [..., 1]."""
    n = fs.shape[-1]
    while n > 1:
        h = n // 2
        prod = F12.mul(fs[..., :h], fs[..., h : 2 * h])
        if n % 2:
            prod = torch.cat([prod, fs[..., -1:]], dim=-1)
        fs = prod
        n = (n + 1) // 2
    return fs


def _miller_masked(g1_points: Point, g2_points: Point):
    """Miller values of projective pairs, 1 where either leg is the
    identity, in torch ops (K7's plain version)."""
    px, py, v1 = g1_affine(g1_points)
    qx, qy, v2 = g2_affine(g2_points)
    fs = miller_loop_plain(px, py, qx, qy)
    return F12.select(v1 & v2, fs, F12.one(F12.batch_shape(fs), fs.device))


def multi_miller(g1_points: Point, g2_points: Point):
    """prod_i miller(P_i, Q_i) over the vector axis, identity legs
    contributing 1 -> Fq12 [..., 1]."""
    return _tree_prod(_miller_masked(g1_points, g2_points))


def _checked(miller, final, pairs: int, products: int):
    """Whether each final exponentiation `final(miller())` is 1, as the
    spans `pairing.checks`, `pairing.miller`, `pairing.final_exp`."""
    with trace.span("pairing.checks", pairs=pairs, products=products):
        with trace.span("pairing.miller"):
            f = miller()
        with trace.span("pairing.final_exp"):
            f = final(f)
        return F12.is_one(f)[..., 0]


def pairing_product_is_one(g1_points: Point, g2_points: Point):
    """prod_i e(P_i, Q_i) == 1 over the vector axis, for every leading
    batch index: G1 [..., 8, n] and G2 [..., 2, 8, n] -> bool [...]. On
    the card the leading axes are the K8 table's rows."""
    lead, n = g1_points.x.shape[:-2], g1_points.x.shape[-1]
    products = math.prod(lead)
    if g1_points.x.device.type == "cpu":
        return _checked(lambda: multi_miller(g1_points, g2_points),
                        final_exp_plain, products * n, products)

    def final(fs):   # one table row per leading index of fs
        rows, width = fs.shape[:-5], fs.shape[-1]
        k = math.prod(rows)
        idx = torch.arange(k * width, device=fs.device).view(k, width)
        return final_exps(fs, idx).view(rows + (2, 3, 2, NLIMBS, 1))
    return _checked(lambda: miller_values(g1_points, g2_points), final,
                    products * n, products)


def _group_table(sizes):
    """idx [K, width]: group k's pairs in the concatenation, padded with
    the index `total`, which stands for 1."""
    total, width = sum(sizes), max(sizes)
    idx = torch.full((len(sizes), width), total, dtype=torch.long)
    off = 0
    for k, n in enumerate(sizes):
        idx[k, :n] = torch.arange(off, off + n)
        off += n
    return idx


def _grouped_miller(groups, sizes):
    """The product of each group's Miller values -> Fq12 [K, ..., 1]."""
    fs = _miller_masked(point_concat([g for g, _ in groups]),
                        point_concat([g for _, g in groups]))
    fs = torch.cat([fs, F12.one((1,), fs.device)], dim=-1)
    g = fs[..., _group_table(sizes)].movedim(-2, 0)    # [K, 2,3,2,8, width]
    return _tree_prod(g)


def pairing_checks(groups):
    """For each (G1 [8, n_k], G2 [2, 8, n_k]) in `groups`, whether
    prod_i e(P_i, Q_i) == 1 -> bool [K]. One Miller loop runs over all
    pairs and one final exponentiation over the K products: on the card
    one K7 and one K8 launch."""
    sizes = [g1.x.shape[-1] for g1, _ in groups]
    if groups[0][0].x.device.type == "cpu":
        return _checked(lambda: _grouped_miller(groups, sizes),
                        final_exp_plain, sum(sizes), len(groups))
    return _checked(
        lambda: miller_values(point_concat([g for g, _ in groups]),
                              point_concat([g for _, g in groups])),
        lambda fs: final_exps(fs, _group_table(sizes)),
        sum(sizes), len(groups))


def simple_pairing_check(a1: Point, a2: Point, b1: Point, b2: Point):
    """e(a1, a2) == e(b1, b2), as e(-a1, a2) * e(b1, b2) == 1 with one
    final exponentiation."""
    return pairing_product_is_one(point_concat([G1.neg(a1), b1]),
                                  point_concat([a2, b2]))
