"""Groth16 zkSNARK (eprint 2016/260) on the port's MSM, NTT and pairing.

Counterpart of `legosnark_tpu/gadgets/groth16.py`, the comparison
baseline of the `legogrothmatrix` example:

  setup(r1cs): trapdoor (tau, alpha, beta, gamma, delta); the QAP values
      u_i(tau), v_i(tau), w_i(tau) from the domain's Lagrange values at
      tau, all on the host in Python ints (one batched inversion); every
      key element from one fixed-base batch multiplication per curve on
      the generator tables (`msm.generator_table`).
  prove(pk, z): H = (Az * Bz - Cz) / Z by an inverse NTT, coset NTTs, a
      pointwise product, division by Z on the coset and an inverse coset
      NTT; then three MSMs. The blinding terms r delta, s delta and
      -rs delta ride as extra MSM columns instead of scalar
      multiplications (a G2 scalar multiplication is ~250 sequential
      torch doublings):
        A, B1 = alpha, beta + one G1 MSM of two rows
                (a_query | delta) . (z | r), (b1_query | delta) . (z | s)
        B     = beta_2 + (b2_query | delta_2) . (z | s)            (G2)
        C     = (l_query | h_query | A | B1 | delta)
                . (z_priv | h | s | r | -rs)
      which are the points the JAX package computes.
  verify(vk, x, pf): e(A, B) = e(alpha, beta) e(IC(x), gamma) e(C, delta),
      one product of four pairings.

The R1CS is host-side sparse rows and the witness products Az, Bz, Cz
run in Python ints. Layout: Fr vectors [8, n], G1 batches [8, n], G2
batches [2, 8, n].
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..curve import bn254
from ..curve import msm as msm_mod
from ..curve import pairing as pr
from ..curve.group import G1, G2, Point, point_concat, point_map, point_stack
from ..fields import limb as fl
from ..prototools import ntt
from ..utils import rand as lrand

FR = bn254.FR
R = bn254.R


class R1CS(NamedTuple):
    """Constraints <A_j, z> * <B_j, z> = <C_j, z> as sparse host rows.

    num_vars counts the leading constant-1 variable; variables
    0..num_public are public (index 0 is the constant)."""

    num_vars: int
    num_public: int
    A: List[List[Tuple[int, int]]]   # per constraint: [(var, coeff)]
    B: List[List[Tuple[int, int]]]
    C: List[List[Tuple[int, int]]]


class ProvingKey(NamedTuple):
    alpha_g1: Point
    beta_g1: Point
    beta_g2: Point
    delta_g1: Point
    delta_g2: Point
    a_query: Point      # [8, n_vars] u_i(tau) G1
    b1_query: Point     # [8, n_vars] v_i(tau) G1
    b2_query: Point     # [2, 8, n_vars] v_i(tau) G2
    h_query: Point      # [8, D - 1] tau^i Z(tau) / delta G1
    l_query: Point      # [8, n_priv] (beta u_i + alpha v_i + w_i) / delta G1
    domain: int


class VerifyKey(NamedTuple):
    alpha_g1: Point
    beta_g2: Point
    gamma_g2: Point
    delta_g2: Point
    # [8, num_public + 1] (beta u_i + alpha v_i + w_i) / gamma G1
    ic: Point


class Proof(NamedTuple):
    a: Point   # G1
    b: Point   # G2
    c: Point   # G1


def proof_size_group_elements() -> dict:
    return {"g1": 2, "g2": 1, "fr": 0}


def _domain(m: int) -> int:
    d = 1
    while d < m:
        d *= 2
    return d


def batch_inv_ints(xs: list) -> list:
    """Inverses mod r of host ints by Montgomery's trick: one modular
    inversion and 3 (n - 1) products. Zeros map to zero."""
    pref = [1] * len(xs)
    acc = 1
    for i, x in enumerate(xs):
        pref[i] = acc
        if x:
            acc = acc * x % R
    inv = pow(acc, -1, R)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        if xs[i]:
            out[i] = inv * pref[i] % R
            inv = inv * xs[i] % R
    return out


def lagrange_at(tau: int, d: int) -> list:
    """L_j(tau) = Z(tau) w^j / (d (tau - w^j)) over the radix-2 domain of
    size d, as host ints."""
    root = bn254.fr_two_adic_root(d.bit_length() - 1)
    ws = [1] * d
    for j in range(1, d):
        ws[j] = ws[j - 1] * root % R
    scale = (pow(tau, d, R) - 1) * pow(d, -1, R) % R
    invs = batch_inv_ints([(tau - w) % R for w in ws])
    return [scale * w % R * iv % R for w, iv in zip(ws, invs)]


def _cols(p: Point, lo: int, hi: int) -> Point:
    return point_map(lambda x: x[..., lo:hi], p)


def setup(r1cs: R1CS, seed: int = 0, device=None):
    """The generator: trapdoor drawn as the JAX package draws it for the
    same seed (toxic waste, discarded) -> (ProvingKey, VerifyKey) in the
    JAX package's layout."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed ^ 0x6706)
    tau, alpha, beta, gamma, delta = (lrand.rand_fr_int(rng)
                                      for _ in range(5))
    m = len(r1cs.A)
    D = _domain(m)
    nv = r1cs.num_vars
    lag = lagrange_at(tau, D)

    # QAP: u_i(tau) = sum_j A[j][i] L_j(tau), likewise v and w
    u, v, wv = [0] * nv, [0] * nv, [0] * nv
    for rows, acc in ((r1cs.A, u), (r1cs.B, v), (r1cs.C, wv)):
        for row, lj in zip(rows, lag):
            for var, coef in row:
                acc[var] = (acc[var] + coef * lj) % R

    ginv = pow(gamma, -1, R)
    dinv = pow(delta, -1, R)
    npub = r1cs.num_public + 1
    comb = [(beta * a + alpha * b + c) % R for a, b, c in zip(u, v, wv)]
    ic = [x * ginv % R for x in comb[:npub]]
    lq = [x * dinv % R for x in comb[npub:]]
    hq = [0] * (D - 1)
    t = (pow(tau, D, R) - 1) * dinv % R
    for i in range(D - 1):
        hq[i] = t
        t = t * tau % R

    def batch(C, scalars):
        return msm_mod.batch_scalar_mul(
            C, msm_mod.generator_table(C, dev),
            fl.tensor(fl.ints_to_limbs(scalars), dev), c=8)

    g1 = batch(G1, [alpha, beta, delta] + u + v + hq + lq + ic)
    g2 = batch(G2, [beta, gamma, delta] + v)
    o_h = 3 + 2 * nv
    o_l = o_h + D - 1
    o_ic = o_l + nv - npub
    pk = ProvingKey(
        alpha_g1=_cols(g1, 0, 1), beta_g1=_cols(g1, 1, 2),
        beta_g2=_cols(g2, 0, 1), delta_g1=_cols(g1, 2, 3),
        delta_g2=_cols(g2, 2, 3), a_query=_cols(g1, 3, 3 + nv),
        b1_query=_cols(g1, 3 + nv, o_h), b2_query=_cols(g2, 3, 3 + nv),
        h_query=_cols(g1, o_h, o_l), l_query=_cols(g1, o_l, o_ic),
        domain=D)
    vk = VerifyKey(alpha_g1=pk.alpha_g1, beta_g2=pk.beta_g2,
                   gamma_g2=_cols(g2, 1, 2), delta_g2=pk.delta_g2,
                   ic=_cols(g1, o_ic, o_ic + npub))
    return pk, vk


def sparse_matvec(rows, z) -> list:
    """<row, z> mod r for each sparse row."""
    return [sum(coef * z[var] for var, coef in row) % R for row in rows]


def prove(pk: ProvingKey, r1cs: R1CS, z: List[int], seed: int = 1) -> Proof:
    """The prover, with r and s drawn as the JAX package draws them for
    the same seed."""
    dev = pk.alpha_g1.x.device
    rng = np.random.default_rng(seed ^ 0x6707)
    r_bl = lrand.rand_fr_int(rng)
    s_bl = lrand.rand_fr_int(rng)
    D = pk.domain
    npub = r1cs.num_public + 1

    # H coefficients: (a b - c) / Z through the coset pipeline, the three
    # vectors through each NTT together
    abc = [sparse_matvec(rows, z) + [0] * (D - len(rows))
           for rows in (r1cs.A, r1cs.B, r1cs.C)]
    evals = fl.to_mont(FR, fl.tensor(
        fl.ints_to_limbs([x for vec in abc for x in vec]), dev)
        .view(fl.NLIMBS, 3, D).movedim(1, 0))                 # [3, 8, D]
    cos = ntt.coset_ntt(ntt.intt(evals))
    prod = fl.sub(FR, fl.mont_mul(FR, cos[0], cos[1]), cos[2])
    h = ntt.coset_intt(ntt.divide_by_z_on_coset(prod))[..., : D - 1]

    def col(k):
        return fl.tensor(fl.ints_to_limbs([k % R]), dev)

    z_can = fl.tensor(fl.ints_to_limbs([x % R for x in z]), dev)
    zr = torch.cat([z_can, col(r_bl)], dim=-1)
    zs = torch.cat([z_can, col(s_bl)], dim=-1)

    # A - alpha and B1 - beta as two rows of one G1 MSM
    ab = msm_mod.msm(G1, point_stack([
        point_concat([pk.a_query, pk.delta_g1]),
        point_concat([pk.b1_query, pk.delta_g1])]), torch.stack([zr, zs]))
    ab = G1.add(point_stack([pk.alpha_g1, pk.beta_g1]), ab)   # [2, 8, 1]
    A, B1 = (point_map(lambda t, i=i: t[i], ab) for i in range(2))
    B = G2.add(pk.beta_g2, msm_mod.msm(
        G2, point_concat([pk.b2_query, pk.delta_g2]), zs))
    C = msm_mod.msm(
        G1, point_concat([pk.l_query, pk.h_query, A, B1, pk.delta_g1]),
        torch.cat([z_can[..., npub:], fl.from_mont(FR, h), col(s_bl),
                   col(r_bl), col(-r_bl * s_bl)], dim=-1))
    return Proof(a=A, b=B, c=C)


def verify_pairs(vk: VerifyKey, public: List[int], pf: Proof) -> list:
    """The verification equation as one group of four pairs for
    `pairing.pairing_checks`: e(A, B) e(-alpha, beta) e(-IC(x), gamma)
    e(-C, delta) == 1, with IC(x) = ic . (1 | x) one G1 MSM."""
    x = [1] + [v % R for v in public]
    ic = msm_mod.msm(G1, vk.ic, fl.tensor(fl.ints_to_limbs(x), vk.ic.x.device))
    return [(point_concat([pf.a, G1.neg(vk.alpha_g1), G1.neg(ic),
                           G1.neg(pf.c)]),
             point_concat([pf.b, vk.beta_g2, vk.gamma_g2, vk.delta_g2]))]


def verify(vk: VerifyKey, public: List[int], pf: Proof):
    """-> bool []."""
    return pr.pairing_product_is_one(*verify_pairs(vk, public, pf)[0])


# ---------------------------------------------------------------------------
# The matmul R1CS (`legosnark_tpu/gadgets/groth16.py:246-306`)
# ---------------------------------------------------------------------------


def matmul_r1cs(n: int):
    """R1CS for C = A*B over n x n matrices by inner-product chains: one
    multiplication constraint per (i, j, k) with running partial sums.
    Public inputs: the n^2 entries of C. Returns (r1cs, assign), where
    assign(A, B) builds the variable vector and C from int matrices.
    Rows and variable order equal the JAX package's."""
    n2 = n * n
    # variables: [1, C entries (public), A entries, B entries, partials]
    num_public = n2

    def idx_c(i, j):
        return 1 + i * n + j

    def idx_a(i, k):
        return 1 + n2 + i * n + k

    def idx_b(k, j):
        return 1 + 2 * n2 + k * n + j

    # partial sums s_{i,j,k} for k < n-1 (s_{i,j,n-1} is C[i,j])
    base_p = 1 + 3 * n2

    def idx_p(i, j, k):
        return base_p + (i * n + j) * (n - 1) + k

    A_rows, B_rows, C_rows = [], [], []
    for i in range(n):
        for j in range(n):
            for k in range(n):
                if k == 0:
                    crow = [(idx_p(i, j, 0) if n > 1 else idx_c(i, j), 1)]
                else:
                    cur = idx_c(i, j) if k == n - 1 else idx_p(i, j, k)
                    crow = [(cur, 1), (idx_p(i, j, k - 1), -1 % R)]
                A_rows.append([(idx_a(i, k), 1)])
                B_rows.append([(idx_b(k, j), 1)])
                C_rows.append(crow)

    num_vars = base_p + n2 * (n - 1)
    r1cs = R1CS(num_vars=num_vars, num_public=num_public,
                A=A_rows, B=B_rows, C=C_rows)

    def assign(Amat, Bmat):
        z = [0] * num_vars
        z[0] = 1
        Cmat = [[0] * n for _ in range(n)]
        for i in range(n):
            for k in range(n):
                z[idx_a(i, k)] = Amat[i][k] % R
        for k in range(n):
            for j in range(n):
                z[idx_b(k, j)] = Bmat[k][j] % R
        for i in range(n):
            for j in range(n):
                acc = 0
                for k in range(n):
                    acc = (acc + Amat[i][k] * Bmat[k][j]) % R
                    if k == n - 1:
                        Cmat[i][j] = acc
                        z[idx_c(i, j)] = acc
                    else:
                        z[idx_p(i, j, k)] = acc
        return z, Cmat

    return r1cs, assign
