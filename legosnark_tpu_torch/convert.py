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


def polycomm_from_jax(cm, device):
    """A JAX `PolyComm` -> the port's."""
    from .gadgets.poly import PolyComm
    return PolyComm(point_from_jax(cm.c, device), point_from_jax(cm.ca, device))


def _fr(x, device):
    return fl.tensor(field_from_jax(x, bn254.FR), device)


def _polypf_from_jax(p, device):
    from .gadgets.poly import PolyPf
    return PolyPf(point_from_jax(p.witness, device),
                  point_from_jax(p.witnessa, device))


def scproof_from_jax(sc, device):
    """A JAX `SumcheckProof` (with its CPpoly and sigma proofs) -> the
    port's."""
    from .gadgets import sigma, sumcheck

    prd = sc.prd_proof
    return sumcheck.SumcheckProof(
        r=_fr(sc.r, device), h_comms=point_from_jax(sc.h_comms, device),
        eq_proofs=sigma.ZKEqProof(point_from_jax(sc.eq_proofs.a, device),
                                  _fr(sc.eq_proofs.z, device)),
        ans_comms=point_from_jax(sc.ans_comms, device),
        poly_pfs=tuple(_polypf_from_jax(p, device) for p in sc.poly_pfs),
        prd_proof=sigma.ZKPrdProof(
            *(point_from_jax(getattr(prd, f), device)
              for f in ("alpha", "beta", "delta")),
            *(_fr(getattr(prd, f), device)
              for f in ("z1", "z2", "z3", "z4", "z5"))),
        finals=_fr(sc.finals, device))


def matproof_from_jax(pf, device):
    """A JAX `MatProof` -> the port's. Field values become port Montgomery
    limbs of the same elements, points port points of the same group
    elements."""
    from .gadgets import matrix
    return matrix.MatProof(
        r=_fr(pf.r, device), s=_fr(pf.s, device),
        t_comm=point_from_jax(pf.t_comm, device),
        sc_proof=scproof_from_jax(pf.sc_proof, device),
        c_ans_comm=point_from_jax(pf.c_ans_comm, device),
        c_poly_pf=None if pf.c_poly_pf is None
        else _polypf_from_jax(pf.c_poly_pf, device))


def hadkey_from_jax(key, device):
    """A JAX `HadKey` -> the port's."""
    from .gadgets.hadamard import HadKey
    return HadKey(key.n, key.d, polykey_from_jax(key.poly_key, device))


def hadproof_from_jax(pf, device):
    """A JAX `HadProof` -> the port's."""
    from .gadgets.hadamard import HadProof
    return HadProof(rho=_fr(pf.rho, device),
                    t_ans_comm=point_from_jax(pf.t_ans_comm, device),
                    c_poly_pf=_polypf_from_jax(pf.c_poly_pf, device),
                    sc_proof=scproof_from_jax(pf.sc_proof, device))


def hadlkey_from_jax(key, device):
    """A JAX `HadLKey` (CPhadL) -> the port's."""
    from .gadgets.lipmaa import HadLKey, InterpKey
    ik = key.interp
    return HadLKey(key.n, point_from_jax(key.chi_pows, device), InterpKey(
        ik.n, *(point_from_jax(getattr(ik, f), device)
                for f in ("lag_g1", "lag_kg2", "z_g1", "z_kg2"))))


def commitkey_from_jax(ck, device):
    """A JAX `CommitmentKey` (`prototools.commit`) -> the port's."""
    from .prototools.commit import CommitmentKey
    return CommitmentKey(*(point_from_jax(p, device) for p in ck))


def comm_from_jax(cm, device):
    """A JAX `Comm` (commitment and knowledge leg) -> the port's."""
    from .prototools.commit import Comm
    return Comm(point_from_jax(cm.c, device), point_from_jax(cm.kc, device))


def subspacekey_from_jax(key, device):
    """A JAX `SubspaceKey` -> the port's."""
    from .gadgets.subspace import SubspaceKey
    return SubspaceKey(*(point_from_jax(p, device) for p in key))


def ackey_from_jax(key, device):
    """A JAX `ACKey` (CPAC) -> the port's."""
    from .gadgets.arithcirc import ACKey
    return ACKey(hadlkey_from_jax(key.hadl_key, device),
                 subspacekey_from_jax(key.ss_key, device),
                 point_from_jax(key.t_points, device))


def acproof_from_jax(pf, device):
    """A JAX `ACProof` -> the port's."""
    from .gadgets.arithcirc import ACProof
    from .gadgets.lipmaa import InterpComm
    return ACProof(*(InterpComm(point_from_jax(cm.c, device),
                                point_from_jax(cm.kc, device))
                     for cm in (pf.ca, pf.cb, pf.cc)),
                   point_from_jax(pf.had_pi, device),
                   point_from_jax(pf.lin_pi, device))


def groth16_pk_from_jax(pk, device):
    """A JAX Groth16 `ProvingKey` -> the port's."""
    from .gadgets.groth16 import ProvingKey
    return ProvingKey(*(point_from_jax(getattr(pk, f), device)
                        for f in ProvingKey._fields[:-1]), domain=pk.domain)


def groth16_vk_from_jax(vk, device):
    """A JAX Groth16 `VerifyKey` -> the port's."""
    from .gadgets.groth16 import VerifyKey
    return VerifyKey(*(point_from_jax(p, device) for p in vk))


def groth16_proof_from_jax(pf, device):
    """A JAX Groth16 `Proof` -> the port's."""
    from .gadgets.groth16 import Proof
    return Proof(*(point_from_jax(p, device) for p in pf))


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
