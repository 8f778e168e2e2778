"""Debug printing, off unless LEGOSNARK_CPDBG=1.

Counterpart of `legosnark_tpu/utils/dbg.py` (the reference's `cpdbg`
printers, compiled out there). When `ENABLED`, values print as canonical
integers: Fr elements from their Montgomery limbs, G1 points as affine
(x, y) pairs or None for the identity.
"""
from __future__ import annotations

import os

from ..curve import bn254
from ..curve.group import g1_to_ints
from ..fields import limb as fl

ENABLED = bool(int(os.environ.get("LEGOSNARK_CPDBG", "0")))


def _fr_ints(v_mont) -> list:
    """Canonical ints of Montgomery Fr limbs [..., 8, n], flattened."""
    return [bn254.FR.from_mont_int(v)
            for v in fl.limbs_to_ints(v_mont).reshape(-1)]


def print_fr(label: str, v_mont) -> None:
    """The first 8 elements of a Montgomery Fr batch [..., 8, n]."""
    if not ENABLED:
        return
    vals = _fr_ints(v_mont)
    print(f"[cpdbg] {label}: {vals[:8]}{' ...' if len(vals) > 8 else ''}")


def print_point(label: str, p) -> None:
    """A G1 batch [..., 8, n] as affine ints; a single point without the
    list around it."""
    if not ENABLED:
        return
    pts = g1_to_ints(p)
    print(f"[cpdbg] {label}: {pts[0] if len(pts) == 1 else pts}")


def print_matrix(label: str, m_mont) -> None:
    """The shape of a Montgomery Fr matrix [rows, 8, cols] and its
    top-left 4 x 4 entries."""
    if not ENABLED:
        return
    print(f"[cpdbg] {label}: matrix shape "
          f"{tuple(m_mont.shape[:-2]) + tuple(m_mont.shape[-1:])}")
    for row in m_mont[:4]:
        print("   ", _fr_ints(row[..., :4]))
