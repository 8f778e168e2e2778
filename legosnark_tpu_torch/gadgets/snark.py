"""Commit-and-prove input plumbing.

Counterpart of `legosnark_tpu/gadgets/snark.py`: `init` commits a list
of vectors under a `prototools.commit` key and splits the prover's view
(public inputs and full openings, `CPPIn`) from the verifier's (public
inputs and bare commitments, `CPVIn`). With an rng, each commitment draws
its randomness with `rand_fr_mont(rng, 1)`, in vector order; without,
r = 0.

`init_each` does the same under several keys, drawing as `init` under
each key in turn would, and runs every commitment as a row of one G1 and
one G2 MSM.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..curve.group import point_map
from ..prototools import commit as cs
from ..utils import rand as lrand


class CPPIn(NamedTuple):
    """The prover's inputs."""

    public_slot: Any                 # tuple of public Fr arrays [8, m]
    comm_slot: Sequence[cs.CommOut]  # full openings


class CPVIn(NamedTuple):
    """The verifier's inputs."""

    public_in: Any                   # tuple of public Fr arrays
    comm_in: Sequence[cs.Comm]       # bare commitments


def init_each(keys: Sequence[cs.CommitmentKey], public: Sequence,
              vectors: Sequence, rng: Optional[np.random.Generator] = None
              ) -> list:
    """[(CPPIn, CPVIn)] per key: every vector (Montgomery [8, m_j])
    committed under every key. Shorter vectors are padded with zeros for
    the joint MSM, which adds nothing to their commitments."""
    dev = vectors[0].device
    K, V = len(keys), len(vectors)
    m = max(v.shape[-1] for v in vectors)
    vs = torch.stack([torch.nn.functional.pad(v, (0, m - v.shape[-1]))
                      for v in vectors])                        # [V, 8, m]
    ck = cs.CommitmentKey(*(point_map(lambda *x: torch.stack(x)[:, None], *ps)
                            for ps in zip(*keys)))              # [K, 1, ..]
    r = None
    if rng is not None:
        r = torch.stack([lrand.rand_fr_mont(rng, 1, dev)
                         for _ in range(K * V)]).view(K, V, -1, 1)
    out = cs.commit(ck, vs, r)
    views = []
    for k in range(K):
        outs = tuple(cs.CommOut(
            cs.Comm(*(point_map(lambda x: x[k, j], p) for p in out.c)),
            out.r if r is None else r[k, j], vectors[j]) for j in range(V))
        views.append((CPPIn(tuple(public), outs),
                      CPVIn(tuple(public), tuple(o.c for o in outs))))
    return views


def init(ck: cs.CommitmentKey, public: Sequence, vectors: Sequence,
         rng: Optional[np.random.Generator] = None):
    """(CPPIn, CPVIn) for the vectors committed under ck."""
    return init_each([ck], public, vectors, rng)[0]


def init_no_pub(ck: cs.CommitmentKey, vectors: Sequence,
                rng: Optional[np.random.Generator] = None):
    """`init` with no public inputs."""
    return init(ck, (), vectors, rng)
