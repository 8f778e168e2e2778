"""Fiat-Shamir transcript: a MiMC-5 sponge over Fr.

Counterpart of `legosnark_tpu/utils/transcript.py`: the permutation is
110 rounds of x <- (x + c_i)^5 over Fr with the same round constants
(numpy seed 0xF5), batched over the vector axis; a batch is compressed by
a binary tree of permutations (`_tree_digest`) before it enters the
running state; the label, `absorb_fr`, `challenge` and `challenges` are
the JAX package's. Every step is a field operation, so absorbing the
same Fr elements gives the same challenges as field elements, whatever
the limb layout (the JAX package's `_as_fr` reduces its 13-bit limbs to
the element they represent; here the Montgomery limbs already are one).

Points (a decision of this port): `absorb_point` absorbs each point of a
batch as its affine canonical coordinates reduced into Fr, x mod r and
y mod r, the identity as (0, 0), all in one `absorb_fr`; one batched
`to_affine_batch` per absorb. The JAX package absorbs projective 13-bit
limbs (`legosnark_tpu/utils/transcript.py:89-94`), which depend on its
limb layout and on the representative (X : Y : Z) an addition order
produces, so no other implementation can reproduce its bytes. Fiat-Shamir
proofs of the port are therefore held to the JAX package by verification,
not by equal bytes; with honest-verifier challenges, or with Fr-only
transcripts, the two agree element for element.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import resolve_device
from ..curve import bn254
from ..curve.group import G1, Point, to_affine_batch
from ..fields import limb as fl
from . import trace

FR = bn254.FR
N_ROUNDS = 110


@functools.lru_cache(None)
def _round_constants(device: torch.device) -> torch.Tensor:
    """[N_ROUNDS, 8, 1] Montgomery constants (fixed-seed uniform draws)."""
    rng = np.random.default_rng(0xF5)
    vals = [int.from_bytes(rng.bytes(40), "little") % bn254.R
            for _ in range(N_ROUNDS)]
    return fl.tensor(FR.to_mont_ints(vals), device).T.reshape(
        N_ROUNDS, fl.NLIMBS, 1).contiguous()


def permute(x):
    """110 rounds of x <- (x + c_i)^5, batched over the vector axis:
    three Montgomery products per round, 330 in all."""
    consts = _round_constants(x.device)
    trace.count("mimc.permute")
    for i in range(N_ROUNDS):
        t = fl.add(FR, x, consts[i])
        t4 = fl.mont_sqr(FR, fl.mont_sqr(FR, t))
        x = fl.mont_mul(FR, t4, t)
    return x


def _tree_digest(v):
    """Compress [8, m] columns to one [8, 1] digest: permute all lanes
    once, then log2(m) rounds of pairwise combine and permute."""
    h = permute(v)
    m = h.shape[-1]
    while m > 1:
        half = m // 2
        comb = fl.add(FR, h[..., :half], h[..., half : 2 * half])
        if m % 2:
            comb = torch.cat([comb, h[..., -1:]], dim=-1)
        h = permute(comb)
        m = (m + 1) // 2
    return h


class Transcript:
    """Absorb-then-squeeze sponge; the state is one Fr element [8, 1] on
    `device` (CUDA unless the caller names another). Each absorb and each
    squeeze is one span (`transcript.absorb`, `transcript.squeeze`) that
    counts its permutations (`mimc.permute`)."""

    def __init__(self, label: int = 0, device=None):
        dev = resolve_device(device)
        self.state = fl.const_mont(FR, label % bn254.R, dev).clone()

    def absorb_fr(self, v_mont) -> None:
        """Absorb a batch of Fr elements [..., 8, m] (any leading axes,
        flattened in order onto the vector axis)."""
        with trace.span("transcript.absorb",
                        lanes=v_mont.numel() // fl.NLIMBS):
            self._absorb(v_mont)

    def _absorb(self, v_mont) -> None:
        v = v_mont.reshape(-1, fl.NLIMBS, v_mont.shape[-1])
        digest = _tree_digest(torch.cat(v.unbind(0), dim=-1))
        self.state = permute(fl.add(FR, self.state, digest))

    def absorb_point(self, p: Point) -> None:
        """Absorb a G1 batch [..., 8, m] as affine (x mod r, y mod r),
        the identity as (0, 0)."""
        with trace.span("transcript.absorb",
                        lanes=2 * (p.x.numel() // fl.NLIMBS)):
            a = to_affine_batch(G1, p)
            ident = G1.is_identity(p)
            xy = fl.canon(FR, fl.from_mont(bn254.FQ, torch.stack([a.x, a.y])))
            xy = fl.select(ident, torch.zeros_like(xy), xy)
            self._absorb(fl.to_mont(FR, xy))

    def _squeeze(self):
        self.state = permute(self.state)
        return self.state

    def challenge(self):
        """Squeeze one Fr challenge [8, 1] (Montgomery form)."""
        with trace.span("transcript.squeeze", challenges=1):
            return self._squeeze()

    def challenges(self, n: int):
        """[8, n] challenges."""
        with trace.span("transcript.squeeze", challenges=n):
            return torch.cat([self._squeeze() for _ in range(n)], dim=-1)
