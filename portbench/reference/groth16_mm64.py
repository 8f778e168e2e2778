"""Plain reference of Groth16 on the n x n matmul R1CS, with the emulated
witness commitment.

The relation: constraint (i, j, k), numbered (i n + j) n + k, multiplies
A[i][k] by B[k][j] into the running sum s_ijk = sum_{t <= k} A[i][t]
B[t][j]; its C row is s_ijk - s_ij(k-1), with C[i][j] = s_ij(n-1) the
public input in place of the last partial sum. The QAP's domain is the
radix-2 domain of the smallest power of two holding the constraints, with
the root of `_bn254.two_adic_root`.

Setup draws tau, alpha, beta, gamma, delta from numpy seed
`setup_seed ^ 0x6706` and a proof its r, s from `prove_seed ^ 0x6707`
(40-byte little-endian integers mod r). With a(tau), b(tau), c(tau) the
constraint vectors' interpolants at tau and c_pub the public part of c:

  A = (alpha + a + r delta) G1,   B = (beta + b + s delta) G2,
  C = ((beta a + alpha b + c - c_pub + a b - c) / delta
       + s A + r B1 - r s delta) G1,

where a b - c = h(tau) Z(tau) is what the prover's H must give. The
emulated commitment is (sum_i w_i k_i) G1 over the private variables w
(A's entries row-major, B's, then the partial sums s_ijk, k < n - 1, in
constraint order) and the bases' scalars k_i.
"""
from __future__ import annotations

import numpy as np

from . import _bn254 as hb

R = hb.R


class Trapdoor:
    """The setup's secrets and the domain's Lagrange values at tau."""

    def __init__(self, n: int, setup_seed: int):
        self.n = n
        self.tau, self.alpha, self.beta, self.gamma, self.delta = \
            hb.fr_draws(np.random.default_rng(setup_seed ^ 0x6706), 5)
        m = n ** 3
        d = 1 << (m - 1).bit_length()
        self.lag = hb.lagrange_at(self.tau, d)


def matmul(A, B) -> list:
    n = len(A)
    return [[sum(A[i][k] * B[k][j] for k in range(n)) % R for j in range(n)]
            for i in range(n)]


def private_witness(A, B) -> list:
    n = len(A)
    w = [x % R for row in A for x in row] + [x % R for row in B for x in row]
    for i in range(n):
        for j in range(n):
            acc = 0
            for k in range(n - 1):
                acc = (acc + A[i][k] * B[k][j]) % R
                w.append(acc)
    return w


def expected(td: Trapdoor, A, B, prove_seed: int) -> dict:
    """The affine points of an honest proof of A*B with proof seed
    `prove_seed`, and the public inputs (C row-major)."""
    n, lag = td.n, td.lag
    a = b = c = c_pub = 0
    for i in range(n):
        for j in range(n):
            base = (i * n + j) * n
            for k in range(n):
                lj = lag[base + k]
                x, y = A[i][k], B[k][j]
                a += lj * x
                b += lj * y
                c += lj * (x * y % R)
    C = matmul(A, B)
    for i in range(n):
        for j in range(n):
            c_pub += lag[(i * n + j) * n + n - 1] * C[i][j]
    a, b, c, c_pub = a % R, b % R, c % R, c_pub % R
    r, s = hb.fr_draws(np.random.default_rng(prove_seed ^ 0x6707), 2)
    al, be, de = td.alpha, td.beta, td.delta
    priv = (be * a + al * b + c - c_pub) % R
    a_s = (al + a + r * de) % R
    b_s = (be + b + s * de) % R
    c_s = ((priv + a * b - c) * pow(de, -1, R) + s * a_s + r * b_s
           - r * s * de) % R
    return {"a": hb.aff_mul(hb.G1_GEN, a_s), "b": hb.aff2_mul(hb.G2_GEN, b_s),
            "c": hb.aff_mul(hb.G1_GEN, c_s),
            "public": [x for row in C for x in row]}


def check(td: Trapdoor, inputs: dict, out: dict) -> list:
    """The names of the program's values that differ from the honest ones
    for `inputs` (A, B as int matrices, `prove_seed`, the bases' scalars
    `base_scalars`); `out` holds the proof's points and the commitment."""
    want = expected(td, inputs["A"], inputs["B"], inputs["prove_seed"])
    bad = []
    if hb.g1_points(out["a"]) != [want["a"]]:
        bad.append("proof A = (alpha + a + r delta) G1")
    if hb.g2_points(out["b"]) != [want["b"]]:
        bad.append("proof B = (beta + b + s delta) G2")
    if hb.g1_points(out["c"]) != [want["c"]]:
        bad.append("proof C")
    if [x % R for x in out["public"]] != want["public"]:
        bad.append("public inputs C = A*B")
    w = private_witness(inputs["A"], inputs["B"])
    ks = inputs["base_scalars"]
    commit = hb.aff_mul(hb.G1_GEN, sum(x * k for x, k in zip(w, ks)) % R) \
        if len(ks) == len(w) else None
    if commit is None or hb.g1_points(out["commit"]) != [commit]:
        bad.append("witness commitment (sum w_i k_i) G1")
    return bad
