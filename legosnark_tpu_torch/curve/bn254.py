"""BN254 (alt_bn128) curve constants as plain Python integers.

Counterpart of `legosnark_tpu/curve/bn254.py:18-46, 78-125`, copied as ints so
that this package imports nothing of the JAX package. The field specs
describe the port's limb layout: 8 x 32-bit limbs, R = 2^256.
"""
from __future__ import annotations

import functools

from ..fields.limb import FieldSpec

# Base field and scalar field moduli.
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# BN parameter x: q = 36x^4 + 36x^3 + 24x^2 + 6x + 1, r = 36x^4+36x^3+18x^2+6x+1
BN_X = 4965661367192848881
assert 36 * BN_X**4 + 36 * BN_X**3 + 24 * BN_X**2 + 6 * BN_X + 1 == Q
assert 36 * BN_X**4 + 36 * BN_X**3 + 18 * BN_X**2 + 6 * BN_X + 1 == R

# y^2 = x^3 + 3 over Fq; G1 generator
B_G1 = 3
G1_GEN = (1, 2)

# Fq2 = Fq[u]/(u^2 + 1); twist y^2 = x^3 + b/xi with xi = 9 + u  (D-twist)
XI = (9, 1)

# G2 generator (affine, Fq2 coords as (c0, c1))
G2_GEN_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GEN_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)


def _fq2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % Q, (a[0] * b[1] + a[1] * b[0]) % Q)


def _fq2_inv(a):
    d = pow(a[0] * a[0] + a[1] * a[1], -1, Q)
    return ((a[0] * d) % Q, (-a[1] * d) % Q)


def _fq2_pow(a, e):
    acc, base = (1, 0), a
    while e:
        if e & 1:
            acc = _fq2_mul(acc, base)
        base = _fq2_mul(base, base)
        e >>= 1
    return acc


def frob_coeffs() -> dict:
    """Frobenius coefficients of the tower (`legosnark_tpu/curve/
    bn254.py:frob_coeffs`): for power n in (1, 2, 3), gamma_n[k] =
    xi^(k (q^n - 1) / 6), k = 0..5, the factor of the w^k coefficient."""
    return {n: [_fq2_pow(XI, k * (Q**n - 1) // 6) for k in range(6)]
            for n in (1, 2, 3)}


# Twist curve coefficient b2 = 3 / xi  (alt_bn128 is a D-type twist)
B_G2 = _fq2_mul((B_G1, 0), _fq2_inv(XI))

# 3*b, the constant of the RCB complete formulas (a = 0)
B3_G1 = 3 * B_G1 % Q
B3_G2 = (3 * B_G2[0] % Q, 3 * B_G2[1] % Q)

FQ = FieldSpec(p=Q, name="Fq")
FR = FieldSpec(p=R, name="Fr")


def _two_adicity() -> int:
    t, s = R - 1, 0
    while t % 2 == 0:
        t //= 2
        s += 1
    return s


@functools.lru_cache(None)
def fr_two_adic_root(log_n: int) -> int:
    """A primitive 2^log_n-th root of unity in Fr (`legosnark_tpu/curve/
    bn254.py:fr_two_adic_root`): the same element, so NTTs agree."""
    s = _two_adicity()
    if log_n > s:
        raise ValueError(f"domain 2^{log_n} exceeds 2-adicity {s}")
    g = 2
    while True:   # the smallest g whose power has order exactly 2^s
        cand = pow(g, (R - 1) >> s, R)
        if pow(cand, 1 << (s - 1), R) != 1:
            break
        g += 1
    return pow(cand, 1 << (s - log_n), R)


#: the prime factors of r - 1
_FR_ORDER_FACTORS = (2, 3, 13, 29, 983, 11003, 237073, 405928799,
                     1670836401704629, 13818364434197438864469338081)


@functools.lru_cache(None)
def fr_multiplicative_generator() -> int:
    """The smallest generator of Fr^*, the NTT's coset shift
    (`legosnark_tpu/curve/bn254.py:fr_multiplicative_generator`)."""
    rest = R - 1
    for f in _FR_ORDER_FACTORS:
        while rest % f == 0:
            rest //= f
    assert rest == 1, "factorization of r - 1 incomplete"
    g = 2
    while any(pow(g, (R - 1) // f, R) == 1 for f in _FR_ORDER_FACTORS):
        g += 1
    return g
