"""Host-int BN254 for the plain references: affine G1 and G2, the MiMC
transcript, MLE folds and the seeded Fr draws.

Everything here is Python ints (and numpy's generator for the draws). It
imports nothing of the measured package and reads the package's outputs
only through `g1_points` / `g2_points` / `fr_ints`, which decode the
documented limb layout: int32 tensors `[..., 8, n]` of eight little-endian
32-bit words, Montgomery form with R = 2^256, values possibly in [0, 2p),
points homogeneous projective (X : Y : Z) with the identity at Z = 0.
"""
from __future__ import annotations

import numpy as np

Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
G1_GEN = (1, 2)
#: the G2 generator (EIP-197), affine over Fq2 = Fq[u]/(u^2 + 1)
G2_GEN = ((10857046999023057135944570762232829481370756359578518086990519993285655852781,
           11559732032986387107991004021392285783925812861821192530917403151452391805634),
          (8495653923123431417604973247489272438418190587263600148770280649306958101930,
           4082367875863433681332203403145435568316851327593401208105741076214120093531))
MONT = 1 << 256
#: MiMC-5: 110 rounds of x <- (x + c_i)^5 over Fr, constants from numpy
#: seed 0xF5 (40 bytes little-endian, reduced mod r)
MIMC_ROUNDS = 110


# ---------------------------------------------------------------------------
# seeded draws
# ---------------------------------------------------------------------------


def fr_draws(rng: np.random.Generator, n: int) -> list:
    """n uniform Fr elements: 40 bytes each, little-endian, mod r."""
    buf = rng.bytes(40 * n)
    return [int.from_bytes(buf[i : i + 40], "little") % R
            for i in range(0, 40 * n, 40)]


# ---------------------------------------------------------------------------
# decoding the measured package's limbs
# ---------------------------------------------------------------------------


def words_ints(t) -> list:
    """[..., 8, V] int32 word patterns -> flat list of the integers."""
    a = np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)
    a = np.moveaxis(a.astype(np.int64) & 0xFFFFFFFF, -2, -1)
    flat = np.ascontiguousarray(a.reshape(-1, 8)).astype("<u4")
    return [int.from_bytes(row.tobytes(), "little") for row in flat]


def from_mont(vals: list, p: int) -> list:
    rinv = pow(MONT, -1, p)
    return [v * rinv % p for v in vals]


def fr_ints(t) -> list:
    """Montgomery Fr limbs -> canonical ints (flat)."""
    return from_mont(words_ints(t), R)


def g1_points(p) -> list:
    """A G1 batch (x, y, z) of Montgomery Fq limbs -> affine (x, y) or None."""
    xs, ys, zs = (from_mont(words_ints(c), Q) for c in p[:3])
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, Q)
            out.append((x * zi % Q, y * zi % Q))
    return out


def g2_points(p) -> list:
    """A G2 batch (x, y, z), each [2, 8, V] Fq2 limbs (c0, c1) -> affine
    ((x0, x1), (y0, y1)) or None."""
    def pairs(c):
        return list(zip(from_mont(words_ints(c[0]), Q),
                        from_mont(words_ints(c[1]), Q)))

    out = []
    for x, y, z in zip(pairs(p[0]), pairs(p[1]), pairs(p[2])):
        if z == (0, 0):
            out.append(None)
            continue
        zi = f2_inv(z)
        out.append((f2_mul(x, zi), f2_mul(y, zi)))
    return out


# ---------------------------------------------------------------------------
# affine G1 over Fq
# ---------------------------------------------------------------------------


def aff_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    (x1, y1), (x2, y2) = p, q
    if x1 == x2 and (y1 + y2) % Q == 0:
        return None
    if p == q:
        lam = 3 * x1 * x1 * pow(2 * y1, -1, Q) % Q
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    return (x3, (lam * (x1 - x3) - y1) % Q)


def aff_neg(p):
    return None if p is None else (p[0], (-p[1]) % Q)


def aff_mul(p, k):
    k %= R
    acc = None
    while k:
        if k & 1:
            acc = aff_add(acc, p)
        p = aff_add(p, p)
        k >>= 1
    return acc


def aff_sum(ps):
    acc = None
    for p in ps:
        acc = aff_add(acc, p)
    return acc


# ---------------------------------------------------------------------------
# affine G2 over Fq2
# ---------------------------------------------------------------------------


def f2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % Q, (a[0] * b[1] + a[1] * b[0]) % Q)


def f2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def f2_inv(a):
    d = pow(a[0] * a[0] + a[1] * a[1], -1, Q)
    return (a[0] * d % Q, -a[1] * d % Q)


def aff2_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    (x1, y1), (x2, y2) = p, q
    if x1 == x2 and (y1[0] + y2[0]) % Q == 0 and (y1[1] + y2[1]) % Q == 0:
        return None
    if p == q:
        x1sq = f2_mul(x1, x1)
        lam = f2_mul((3 * x1sq[0], 3 * x1sq[1]), f2_inv((2 * y1[0], 2 * y1[1])))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_mul(lam, lam), x1), x2)
    return (x3, f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1))


def aff2_mul(p, k):
    k %= R
    acc = None
    while k:
        if k & 1:
            acc = aff2_add(acc, p)
        p = aff2_add(p, p)
        k >>= 1
    return acc


# ---------------------------------------------------------------------------
# MLE folds and the MiMC transcript
# ---------------------------------------------------------------------------


def mle_fold(vals: list, pt: list) -> list:
    """Bind the top variables of an MLE table to the points of pt, in
    order (variable i is bit d-1-i of the index)."""
    for x in pt:
        h = len(vals) // 2
        vals = [(a + x * (b - a)) % R for a, b in zip(vals[:h], vals[h:])]
    return vals


def mimc_constants() -> list:
    return fr_draws(np.random.default_rng(0xF5), MIMC_ROUNDS)


_CONSTS = mimc_constants()


def permute(x: int) -> int:
    for c in _CONSTS:
        x = pow(x + c, 5, R)
    return x


def tree_digest(lanes: list) -> int:
    """Permute every lane, then halve: lane i of the first half plus lane
    i of the second (the odd one carried), permuted, until one is left."""
    h = [permute(v) for v in lanes]
    while len(h) > 1:
        half = len(h) // 2
        comb = [(a + b) % R for a, b in zip(h[:half], h[half : 2 * half])]
        if len(h) % 2:
            comb.append(h[-1])
        h = [permute(v) for v in comb]
    return h[0]


def point_lanes(points: list) -> list:
    """A batch of affine G1 points as transcript lanes: every x mod r,
    then every y mod r, the identity as (0, 0)."""
    xs = [0 if p is None else p[0] % R for p in points]
    ys = [0 if p is None else p[1] % R for p in points]
    return xs + ys


class Transcript:
    """The sponge: state = label; absorbing v sets state = permute(state +
    digest(v)); a challenge is state = permute(state)."""

    def __init__(self, label: int):
        self.state = label % R

    def absorb_digest(self, digest: int) -> None:
        self.state = permute((self.state + digest) % R)

    def absorb(self, lanes: list) -> None:
        self.absorb_digest(tree_digest(lanes))

    def absorb_points(self, points: list) -> None:
        self.absorb(point_lanes(points))

    def challenge(self) -> int:
        self.state = permute(self.state)
        return self.state

    def challenges(self, n: int) -> list:
        return [self.challenge() for _ in range(n)]


def two_adic_root(log_n: int) -> int:
    """The primitive 2^log_n-th root of unity of the QAP domain: the
    smallest g whose ((r-1) / 2^s)-th power has order exactly 2^s, that
    power raised to 2^(s - log_n)."""
    s = ((R - 1) & -(R - 1)).bit_length() - 1
    g = 2
    while True:
        cand = pow(g, (R - 1) >> s, R)
        if pow(cand, 1 << (s - 1), R) != 1:
            break
        g += 1
    return pow(cand, 1 << (s - log_n), R)


def lagrange_at(tau: int, d: int) -> list:
    """L_j(tau) = Z(tau) w^j / (d (tau - w^j)) over the domain of size d,
    the d inversions batched by prefix products."""
    root = two_adic_root(d.bit_length() - 1)
    ws = [1] * d
    for j in range(1, d):
        ws[j] = ws[j - 1] * root % R
    z_tau = (pow(tau, d, R) - 1) % R
    dens = [d * (tau - wj) % R for wj in ws]
    pref = [1] * (d + 1)
    for j, x in enumerate(dens):
        pref[j + 1] = pref[j] * x % R
    inv = pow(pref[d], -1, R)
    lag = [0] * d
    for j in range(d - 1, -1, -1):
        lag[j] = z_tau * ws[j] % R * (inv * pref[j] % R) % R
        inv = inv * dens[j] % R
    return lag
