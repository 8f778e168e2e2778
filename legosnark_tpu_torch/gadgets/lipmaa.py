"""CPhadL - Lipmaa's Hadamard-product argument (NTT and pairing based).

Counterpart of `legosnark_tpu/gadgets/lipmaa.py` (eprint 2014/396), with
trapdoors chi and gamma drawn and discarded by keygen:
  commit(v; r): c  = r Z(chi) G1 + sum_i v_i l_i(chi) G1,
                kc = gamma (the same combination) G2;
  prove: A, B, C interpolate a, b, c; H = (A B - C) / Z by inverse NTTs,
         coset NTTs, a pointwise product, division by Z on the coset and
         an inverse coset NTT, plus the blinding terms
         d2 A + d1 B + d1 d2 Z - d3 of the commitments' r = (d1, d2, d3);
         pi = <chi powers, H coefficients>, one G1 MSM;
  verify: e(ca, kc_b) == e(G1, kc_c) e(pi, gamma Z(chi) G2).

With hat(A) = A + d1 Z etc., hat(A) hat(B) - hat(C) = Z (H_q + d2 A +
d1 B + d1 d2 Z - d3), so at the trapdoor both sides equal
e(G1, G2)^(gamma hat(A)(chi) hat(B)(chi)).

The G1 MSMs run on kernels K1-K3; the G2 legs (keygen's Lagrange points,
the commitments' kc) run the torch group law, each product on K1.
Layout: evaluation vectors [8, n]; points [8, m] (G1), [2, 8, m] (G2).
"""
from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..config import resolve_device
from ..curve import bn254
from ..curve import msm as msm_mod
from ..curve import pairing as pr
from ..curve.group import G1, G2, Point, g1_generator, point_concat, point_map
from ..fields import limb as fl
from ..prototools import ntt
from ..utils import rand as lrand
from ..utils import util

FR = bn254.FR


class InterpKey(NamedTuple):
    """Lagrange-basis commitment key."""

    n: int
    lag_g1: Point    # [8, n] l_i(chi) G1
    lag_kg2: Point   # [2, 8, n] gamma l_i(chi) G2
    z_g1: Point      # Z(chi) G1
    z_kg2: Point     # gamma Z(chi) G2


class HadLKey(NamedTuple):
    """Proving key: the powers of chi, and the commitment key."""

    n: int
    chi_pows: Point  # [8, n + 1] chi^i G1
    interp: InterpKey


class InterpComm(NamedTuple):
    c: Point   # G1
    kc: Point  # G2


def proof_size_group_elements() -> dict:
    """pi is one G1 element."""
    return {"g1": 1, "g2": 0, "fr": 0}


def _cols(p: Point, lo: int, hi: int) -> Point:
    return point_map(lambda x: x[..., lo:hi], p)


def keygen(n: int, seed: int = 0, device=None) -> HadLKey:
    """chi and gamma as the JAX package draws them for the same seed;
    every G1 point of the key (l_i(chi), Z(chi), chi^i) comes from one
    fixed-base batch multiplication, every G2 point from another."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed ^ 0x11BA)
    chi = lrand.rand_fr_int(rng)
    gamma = lrand.rand_fr_int(rng)

    chi_m = fl.tensor(FR.to_mont_ints([chi]), dev)
    lag = ntt.all_lagrange_at(n, chi_m)                    # [8, n]
    z = ntt.vanishing_at(n, chi_m)                         # [8, 1]
    lag_z = torch.cat([lag, z], dim=-1)
    lag_z_g = fl.mont_mul(FR, lag_z, fl.tensor(FR.to_mont_ints([gamma]),
                                               dev))
    pows = fl.tensor(ntt.power_limbs(chi, n + 1), dev)    # chi^0..chi^n

    t1 = msm_mod.generator_table(G1, dev)
    t2 = msm_mod.generator_table(G2, dev)
    g1s = msm_mod.batch_scalar_mul(
        G1, t1, fl.from_mont(FR, torch.cat([lag_z, pows], dim=-1)), c=8)
    g2s = msm_mod.batch_scalar_mul(G2, t2, fl.from_mont(FR, lag_z_g), c=8)
    interp = InterpKey(n, _cols(g1s, 0, n), _cols(g2s, 0, n),
                       _cols(g1s, n, n + 1), _cols(g2s, n, n + 1))
    return HadLKey(n, _cols(g1s, n + 1, 2 * n + 2), interp)


def srs_path(n: int, seed: int, cache_dir=None) -> Path:
    """The file `keygen_cached` keeps the key of (n, seed) in."""
    return Path(cache_dir or util.SRS_CACHE_DIR) / \
        f"lipmaa_torch_n{n}_s{seed}.npz"


def keygen_cached(n: int, seed: int = 0, cache_dir=None,
                  device=None) -> HadLKey:
    """`keygen` through the SRS disk cache (`utils.util`), under the
    port's own file names in `srs_cache/` unless `cache_dir` names
    another directory."""
    dev = resolve_device(device)
    path = srs_path(n, seed, cache_dir)
    if path.exists():
        g = util.load_point_group(path, dev)
        return HadLKey(n, g["chi_pows"], InterpKey(
            n, g["lag_g1"], g["lag_kg2"], g["z_g1"], g["z_kg2"]))
    key = keygen(n, seed, dev)
    ik = key.interp
    util.save_point_group(path, {
        "chi_pows": key.chi_pows, "lag_g1": ik.lag_g1,
        "lag_kg2": ik.lag_kg2, "z_g1": ik.z_g1, "z_kg2": ik.z_kg2})
    return key


def commit(key: InterpKey, v_mont, r_mont) -> InterpComm:
    """c = <(l_i(chi) G1, Z(chi) G1), (v, r)> and kc the same in G2: one
    MSM of n + 1 points on each curve. Leading axes of v [K.., 8, n] and
    r [K.., 8, 1] commit K vectors in the same two MSMs."""
    s = fl.from_mont(FR, torch.cat([v_mont, r_mont], dim=-1))
    c = msm_mod.msm(G1, point_concat([key.lag_g1, key.z_g1]), s)
    kc = msm_mod.msm(G2, point_concat([key.lag_kg2, key.z_kg2]), s)
    return InterpComm(c, kc)


def commit_pairings(key: InterpKey, cm: InterpComm) -> list:
    """Well-formedness e(c, gamma Z G2) == e(Z G1, kc) as one group of
    pairs (`pairing_checks`): both sides are e(G1, G2)^(gamma Z(chi)
    val(chi))."""
    return [(point_concat([G1.neg(cm.c), key.z_g1]),
             point_concat([key.z_kg2, cm.kc]))]


def check_commit(key: InterpKey, cm: InterpComm):
    """-> bool []."""
    return pr.pairing_checks(commit_pairings(key, cm)).all()


def prove(key: HadLKey, a_evals, b_evals, c_evals, d_mont) -> Point:
    """pi for c = a o b; d_mont [8, 3] the commitments' r (d1, d2, d3).
    The three vectors go through each NTT together."""
    d1, d2, d3 = (d_mont[..., i : i + 1] for i in range(3))
    coeffs = ntt.intt(torch.stack([a_evals, b_evals, c_evals]))  # [3, 8, n]
    cos = ntt.coset_ntt(coeffs)
    prod = fl.sub(FR, fl.mont_mul(FR, cos[0], cos[1]), cos[2])
    hq = ntt.coset_intt(ntt.divide_by_z_on_coset(prod))

    # H = H_q + d2 A + d1 B + d1 d2 Z - d3, with Z = x^n - 1
    blind = fl.mont_mul(FR, coeffs[:2], torch.stack([d2, d1]))
    h = fl.add(FR, hq, fl.add(FR, blind[0], blind[1]))
    d12 = fl.mont_mul(FR, d1, d2)
    h0 = fl.sub(FR, fl.sub(FR, h[..., :1], d12), d3)
    h_full = torch.cat([h0, h[..., 1:], d12], dim=-1)            # [8, n+1]
    return msm_mod.msm(G1, key.chi_pows, fl.from_mont(FR, h_full))


def verify_pairings(key: HadLKey, ca: InterpComm, cb: InterpComm,
                    cc: InterpComm, pi: Point) -> list:
    """e(ca, kc_b) == e(G1, kc_c) e(pi, gamma Z(chi) G2) as one group of
    three pairs whose product is 1, for `pairing_checks`."""
    return [(point_concat([G1.neg(ca.c), g1_generator((), pi.x.device), pi]),
             point_concat([cb.kc, cc.kc, key.interp.z_kg2]))]


def verify(key: HadLKey, ca: InterpComm, cb: InterpComm, cc: InterpComm,
           pi: Point):
    """The verification equation -> bool []."""
    return pr.pairing_checks(verify_pairings(key, ca, cb, cc, pi)).all()
