"""Uniform Fr sampling for keygens, nonces and benchmark data.

Counterpart of `legosnark_tpu/utils/rand.py`: the same numpy draws, so a
given seed yields the same field elements as the JAX package.
"""
from __future__ import annotations

import numpy as np

from ..config import resolve_device
from ..curve import bn254
from ..fields import limb as fl

#: limb width of the JAX package's sampler (rand_fr_limbs_fast draws
#: 20 limbs of 13 bits; the draws are kept and repacked to 32-bit limbs)
_DRAW_BITS, _DRAW_LIMBS = 13, 20


def rand_fr_int(rng: np.random.Generator) -> int:
    """One uniform element of Fr: 320 random bits reduced mod r."""
    return int.from_bytes(rng.bytes(40), "little") % bn254.R


def rand_fr_ints(rng: np.random.Generator, n: int) -> list:
    """n `rand_fr_int` draws from one byte string: the generator's stream
    is the same as n calls (40 bytes are whole 32-bit words)."""
    buf = rng.bytes(40 * n)
    return [int.from_bytes(buf[i : i + 40], "little") % bn254.R
            for i in range(0, 40 * n, 40)]


def rand_fr_mont(rng: np.random.Generator, n: int, device=None):
    """[8, n] uniform Montgomery-form Fr elements."""
    dev = resolve_device(device)
    return fl.tensor(bn254.FR.to_mont_ints(rand_fr_ints(rng, n)), dev)


def rand_fr_canonical(rng: np.random.Generator, n: int, device=None):
    """[8, n] uniform canonical (standard-form) Fr limbs."""
    dev = resolve_device(device)
    return fl.tensor(fl.ints_to_limbs(rand_fr_ints(rng, n)), dev)


def rand_fr_limbs_fast(rng: np.random.Generator, n: int,
                       bits: int = 253) -> np.ndarray:
    """int32 numpy [8, n] canonical limbs uniform in [0, 2^bits).

    Draws the JAX package's (20, n) array of 13-bit values and repacks
    it, so a seed gives the same elements there and here. bits <= 253
    keeps every value below r (benchmark and test data, not secrets)."""
    if bits > bn254.FR.bits - 1:
        raise ValueError("bits must stay below the bit length of r")
    d = rng.integers(0, 1 << _DRAW_BITS, size=(_DRAW_LIMBS, n),
                     dtype=np.uint32)
    out = np.zeros((fl.NLIMBS, n), dtype=np.uint64)
    for k in range(_DRAW_LIMBS):
        lo = k * _DRAW_BITS
        keep = min(_DRAW_BITS, max(0, bits - lo))
        v = (d[k] & np.uint32((1 << keep) - 1)).astype(np.uint64)
        i, off = divmod(lo, fl.LIMB_BITS)
        v <<= np.uint64(off)
        out[i] |= v & np.uint64(fl.MASK)
        if i + 1 < fl.NLIMBS:
            out[i + 1] |= v >> np.uint64(fl.LIMB_BITS)
    return out.astype(np.uint32).view(np.int32)


def rand_fr_mont_fast(rng: np.random.Generator, n: int, device=None):
    """[8, n] Montgomery-form pseudo-uniform Fr elements: the draws of
    `rand_fr_limbs_fast` (the JAX package's for the same rng), converted
    on the device by one Montgomery product."""
    dev = resolve_device(device)
    return fl.to_mont(bn254.FR, fl.tensor(rand_fr_limbs_fast(rng, n), dev))
