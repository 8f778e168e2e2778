"""P1a, P1b and P2: design probes of the Montgomery product on the card.

Counterpart of the TPU probes `scripts/probe_mxu.py` (P1: the Fq product
with its reduction on the vector unit, `build("vpu")`, or as int8 Toeplitz
matmuls on the MXU, `build("mxu")`) and `scripts/probe_conv.py` (P2: where
the limb-product convolution's time goes). Their card kernels:

* `mont_mul_sos` (P1a, `csrc/mont_sos.cu`): separated operand scanning,
  t = a*b, m = t_lo * ninv mod R with the whole 256-bit ninv, u = t + m*p,
  u_hi; bit-identical to K1 (`fields/cuda_limb.mont_mul`).
* `mont_mul_tc` (P1b, `csrc/mont_tc.cu`): the same product with the two
  constant convolutions as u8 Toeplitz products on the tensor cores
  (mma.sync m16n8k32); bit-identical to K1. It is also the exact
  counterpart of probe_conv's inexact f32 tensor-unit body `k_dot`.
* `limb_product` (P2, `csrc/limb_product.cu`): the exact 512-bit product
  [8, n] x [8, n] -> [16, n] words, variants `floor` (k_mul: one multiply
  per output word, the bandwidth floor; not a product), `operand`
  (k_scratch, k_pad, k_roll: operand scanning with carry chains) and
  `product` (k_rows: column-wise accumulation).

Each wrapper takes its plain PyTorch version for CPU tensors, launches its
kernel for CUDA tensors (or raises) and counts its launches in
`kernels.launches`. The probes are off the main path: nothing in the
package calls them, and they never replace K1.

Usage: python -m legosnark_tpu_torch.probes.mont_variants [LOG_N]
(default 20; needs a CUDA card): checks each kernel bit for bit against
its plain version and K1, and prints its time beside K1's.
"""
from __future__ import annotations

import ctypes
import functools
import json
import sys

import numpy as np
import torch

from .. import kernels
from ..config import resolve_device
from ..curve import bn254
from ..fields import cuda_limb
from ..fields import limb as fl
from ..fields.limb import FieldSpec
from ..utils.bench import edge_ints, rand_below, timed_ms, word_err

VARIANTS = ("floor", "operand", "product")
#: timed repetitions of a kernel and of its plain version, and the seed of
#: the probes' operands
REPS = 20
PLAIN_REPS = 2
SEED = 2026


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def mont_mul_sos_plain(spec: FieldSpec, a, b):
    """The SOS product's plain version: K1's, which already computes
    (ab + Mp)/R on 16-bit halves in SOS order."""
    return cuda_limb.mont_mul_plain(spec, a, b)


@functools.lru_cache(None)
def toeplitz_bytes(p: int) -> np.ndarray:
    """[96, 32] uint8: rows 0..31 N[k][i] = ninv_byte[k - i] (ninv =
    -p^-1 mod 2^256), rows 32..95 P[k][i] = p_byte[k - i], zero where
    k - i falls outside [0, 32)."""
    ninv = FieldSpec(p).ninv.to_bytes(32, "little")
    pb = p.to_bytes(32, "little")
    out = np.zeros((96, 32), dtype=np.uint8)
    for k in range(64):
        for i in range(32):
            if 0 <= k - i < 32:
                if k < 32:
                    out[k, i] = ninv[k - i]
                out[32 + k, i] = pb[k - i]
    return out


@functools.lru_cache(None)
def _toeplitz(p: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(toeplitz_bytes(p)).to(device)


def _bytes(h16):
    """16-bit limbs [..., K, V] -> bytes [..., 2K, V] (little-endian)."""
    b = torch.stack([h16 & 0xFF, h16 >> 8], dim=-2)
    return b.reshape(h16.shape[:-2] + (2 * h16.shape[-2], h16.shape[-1]))


def _words(x, bits: int):
    """Exact `bits`-bit limbs [..., K, V] -> int32 words [..., K*bits/32, V]."""
    per = 32 // bits
    k, v = x.shape[-2], x.shape[-1]
    y = x.reshape(x.shape[:-2] + (k // per, per, v))
    w = sum(y[..., q, :] << (bits * q) for q in range(per))
    return fl.narrow(w)


def _wide_halves(a, b):
    """Exact 16-bit limbs [..., 32, V] of the 512-bit products a*b."""
    t = cuda_limb._conv(cuda_limb._split16(a), cuda_limb._split16(b))
    return fl.exact(fl.pad_top(t), 16, 3)                     # cols < 2^36


#: P1b's tile of P: its rows 30..61 (table rows 62..93), columns 30..61 of
#: m*p; column 62 is m_31 * p_31 and column 63 is 0 (`csrc/mont_tc.cu`)
TC_P_ROW0 = 32 + 30


def tc_digit_word(e, w):
    """Word of digit word w (0..7) of a warp's element e (0..31) in P1b's
    digit buffer (`dig_word` in `csrc/mont_tc.cu`); ints or numpy arrays."""
    return 8 * e + (w ^ (e & 4))


def tc_pair_word(e, q):
    """Word of pair word q (0..15) of a warp's element e (0..31) in P1b's
    pair buffer (`pair_word` in `csrc/mont_tc.cu`); ints or numpy arrays."""
    line = (e & 1) | ((q >> 3) << 1) | ((e >> 3) << 2)
    bank = (q & 3) | (((e ^ (q >> 2)) & 1) << 2) | (((e >> 1) & 3) << 3)
    return 32 * line + bank


def tc_tile_slot(mt: int, r: int) -> int:
    """Slot of row r (0..15) of P1b's constant tile mt (0, 1): lane g's rows
    g, g + 8 of tiles 0, 1 are slots 4g..4g+3, one slot group."""
    return 4 * (r % 8) + 2 * mt + r // 8


def tc_slot_row(tile: int, s: int) -> int:
    """`toeplitz_bytes` row of slot s of tile 0, 1 (N: column s) or 2, 3
    (P: column 32 + s for s < 30, s for s = 30, 31; slot (k - 32) mod 32
    holds column k)."""
    if tile < 2:
        return s
    return 32 + (32 + s if s < 30 else s)


@functools.lru_cache(None)
def tc_fragments(p: int) -> np.ndarray:
    """P1b's constant operand in register order: word 128 tile + 4 lane + i
    is A-fragment register a_i of lane (g, t) = (lane // 4, lane % 4) for
    tiles 0, 1 (N) and 2, 3 (P): bytes 4t.. (a0, a1) and 16 + 4t.. (a2,
    a3) of tile rows g (a0, a2) and g + 8 (a1, a3). Word 512 is p_byte[31]
    (column 62 of m*p is m_31 * p_31); 516 words in all."""
    T = toeplitz_bytes(p)
    out = np.zeros(4 * 32 * 4 + 4, dtype=np.uint32)
    for tile in range(4):
        rows = [tc_slot_row(tile, tc_tile_slot(tile % 2, r))
                for r in range(16)]
        w = np.ascontiguousarray(T[rows]).view("<u4")        # [16, 8] words
        for lane in range(32):
            g, t = divmod(lane, 4)
            out[128 * tile + 4 * lane:][:4] = [w[g, t], w[g + 8, t],
                                               w[g, 4 + t], w[g + 8, 4 + t]]
    out[512] = p.to_bytes(32, "little")[31]
    return out


@functools.lru_cache(None)
def _fragments(p: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(tc_fragments(p).view(np.int32)).to(device)


def mont_mul_tc_plain(spec: FieldSpec, a, b):
    """The tensor-core product's decomposition step by step: t = a*b, its
    low 32 bytes against N (column sums), carries to m mod R, m's bytes
    against P's rows 30..61 (columns 30..61 of m*p) and column 62 =
    m_31 * p_31, the carry out of the low half as ceil((t_lo + col_30
    2^240 + col_31 2^248) / 2^256), then t_hi + columns 32..62 + that carry
    with carries. The contractions run in float64, exact as every sum stays
    below 2^21 (the card's torch.matmul has no int64 kernel); the rest in
    int64."""
    a, b = torch.broadcast_tensors(a, b)
    T = _toeplitz(spec.p, a.device).to(torch.float64)
    t = _bytes(_wide_halves(a, b))                            # [..., 64, V]
    m_cols = torch.matmul(T[:32], t[..., :32, :].to(torch.float64))
    m = fl.exact(m_cols.to(torch.int64), 8, 3)                # m mod 2^256
    u_cols = torch.matmul(T[TC_P_ROW0:TC_P_ROW0 + 32],
                          m.to(torch.float64)).to(torch.int64)  # cols 30..61
    col62 = m[..., 31:, :] * int(T[TC_P_ROW0 + 32, 31])
    top = sum(t[..., 28 + q, :] << (8 * q) for q in range(4)) \
        + (u_cols[..., 0, :] << 16) + (u_cols[..., 1, :] << 24)  # word 7
    rest = ((top & fl.MASK) != 0) | (t[..., :28, :] != 0).any(dim=-2)
    carry = (top >> 32) + rest.to(torch.int64)
    hi = t[..., 32:, :] + torch.cat(
        [u_cols[..., 2:, :], col62, torch.zeros_like(col62)], dim=-2)
    hi[..., 0, :] += carry
    return _words(fl.exact(hi, 8, 3), 8)                      # u / R


def limb_product_plain(a, b, variant: str):
    """[8, n] x [8, n] -> [16, n] words on 16-bit halves in int64: the
    exact product for `operand` and `product`; for `floor` the low and
    high word of each a[k]*b[k] (out[k], out[8 + k])."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    a, b = torch.broadcast_tensors(a, b)
    if variant != "floor":
        return _words(_wide_halves(a, b), 16)
    x, y = fl.widen(a), fl.widen(b)
    xs = torch.stack([x & 0xFFFF, x >> 16], dim=-2)          # [..., 8, 2, V]
    ys = torch.stack([y & 0xFFFF, y >> 16], dim=-2)
    h = fl.exact(fl.pad_top(cuda_limb._conv(xs, ys)), 16, 3)  # [..., 8, 4, V]
    lo = fl.narrow(h[..., 0, :] | (h[..., 1, :] << 16))
    hi = fl.narrow(h[..., 2, :] | (h[..., 3, :] << 16))
    return torch.cat([lo, hi], dim=-2)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _operands(name: str, a, b):
    """Broadcast, check and make contiguous the operands of a launch."""
    a, b = torch.broadcast_tensors(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a.device}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"{name}: limbs must be int32")
    if a.dim() < 2 or a.shape[-2] != fl.NLIMBS:
        raise ValueError(f"{name}: expected [..., 8, n], got {tuple(a.shape)}")
    return a.contiguous(), b.contiguous()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(None)
def _sos_words(p: int):
    w = [(p >> (32 * k)) & 0xFFFFFFFF for k in range(fl.NLIMBS)]
    ninv = FieldSpec(p).ninv
    w += [(ninv >> (32 * k)) & 0xFFFFFFFF for k in range(fl.NLIMBS)]
    return kernels.words(w)


def mont_mul_sos(spec: FieldSpec, a, b):
    """P1a wrapper: a*b/R by SOS, bit-identical to K1."""
    if torch.broadcast_tensors(a, b)[0].device.type == "cpu":
        return mont_mul_sos_plain(spec, a, b)
    a, b = _operands("mont_mul_sos", a, b)
    out = torch.empty_like(a)
    total = a.numel() // fl.NLIMBS
    if total == 0:
        return out
    fn = kernels.function("mont_sos.cu", "lsk_mont_mul_sos")
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[-1], total,
             ctypes.cast(_sos_words(spec.p), ctypes.c_void_p), _stream(a))
    kernels.check("mont_sos.cu", err, "mont_mul_sos")
    kernels.count("mont_mul_sos", total)
    return out


def mont_mul_tc(spec: FieldSpec, a, b):
    """P1b wrapper: a*b/R with the reduction's convolutions on the tensor
    cores, bit-identical to K1."""
    if torch.broadcast_tensors(a, b)[0].device.type == "cpu":
        return mont_mul_tc_plain(spec, a, b)
    a, b = _operands("mont_mul_tc", a, b)
    out = torch.empty_like(a)
    total = a.numel() // fl.NLIMBS
    if total == 0:
        return out
    frag = _fragments(spec.p, a.device)
    fn = kernels.function("mont_tc.cu", "lsk_mont_mul_tc")
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[-1], total,
             frag.data_ptr(), _stream(a))
    kernels.check("mont_tc.cu", err, "mont_mul_tc")
    kernels.count("mont_mul_tc", total)
    return out


def limb_product(a, b, variant: str):
    """P2 wrapper: [..., 8, n] x [..., 8, n] -> [..., 16, n] words."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if torch.broadcast_tensors(a, b)[0].device.type == "cpu":
        return limb_product_plain(a, b, variant)
    a, b = _operands("limb_product", a, b)
    out = torch.empty(a.shape[:-2] + (2 * fl.NLIMBS, a.shape[-1]),
                      dtype=torch.int32, device=a.device)
    total = a.numel() // fl.NLIMBS
    if total == 0:
        return out
    fn = kernels.function("limb_product.cu", "lsk_limb_product")
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[-1], total,
             VARIANTS.index(variant), _stream(a))
    kernels.check("limb_product.cu", err, f"limb_product_{variant}")
    kernels.count(f"limb_product_{variant}", total)
    return out


# ---------------------------------------------------------------------------
# the probe: checks and times on the card
# ---------------------------------------------------------------------------


def measure(log_n: int = 20, device=None) -> dict:
    """Run every probe kernel at n = 2^log_n: P1a and P1b on Fr and Fq
    (random values in [0, 2p) plus the edge values) against their plain
    versions, K1 and Python ints; P2's variants on random 256-bit operands
    against `limb_product_plain` and Python ints. Times (ms) are on Fr for
    P1 and at the same n for P2, K1's beside them.

    Returns {name: {"max_abs_err", "k1_err" (P1 only), "ms", "plain_ms",
    "n"}} plus {"k1": {"ms"}}; every error is the largest word
    difference, 0 when bit-identical."""
    dev = resolve_device(device)
    n = 1 << log_n
    rng = np.random.default_rng(SEED)
    out = {name: {"max_abs_err": 0, "k1_err": 0, "n": n}
           for name in ("mont_mul_sos", "mont_mul_tc")}
    for spec in (bn254.FR, bn254.FQ):
        p = spec.p
        xs = edge_ints(p) + rand_below(rng, n - 7, 2 * p)
        ys = edge_ints(p)[::-1] + rand_below(rng, n - 7, 2 * p)
        a = fl.tensor(fl.ints_to_limbs(xs), dev)
        b = fl.tensor(fl.ints_to_limbs(ys), dev)
        k1 = cuda_limb.mont_mul(spec, a, b)
        rinv = pow(spec.R, -1, p)
        for name, fn, plain in (
                ("mont_mul_sos", mont_mul_sos, mont_mul_sos_plain),
                ("mont_mul_tc", mont_mul_tc, mont_mul_tc_plain)):
            got = fn(spec, a, b)
            st = out[name]
            st["max_abs_err"] = max(st["max_abs_err"],
                                    word_err(got, plain(spec, a, b)))
            st["k1_err"] = max(st["k1_err"], word_err(got, k1))
            gi = fl.limbs_to_ints(got[:, :64].cpu())
            for i in range(64):
                if gi[i] % p != xs[i] * ys[i] * rinv % p or gi[i] >= 2 * p:
                    raise AssertionError(f"{name} {spec.name} value {i}")
            if spec is bn254.FR:
                st["ms"] = timed_ms(lambda: fn(spec, a, b), dev, REPS)
                st["plain_ms"] = timed_ms(lambda: plain(spec, a, b), dev,
                                          PLAIN_REPS)
        if spec is bn254.FR:
            out["k1"] = {"ms": timed_ms(lambda: cuda_limb.mont_mul(spec, a, b),
                                        dev, REPS)}

    full = (1 << 256) - 1
    xs = [0, full, full, 1] + rand_below(rng, n - 4, 1 << 256)
    ys = [full, full, 1, 0] + rand_below(rng, n - 4, 1 << 256)
    a = fl.tensor(fl.ints_to_limbs(xs), dev)
    b = fl.tensor(fl.ints_to_limbs(ys), dev)
    for variant in VARIANTS:
        name = f"limb_product_{variant}"
        got = limb_product(a, b, variant)
        st = {"n": n, "max_abs_err": word_err(
            got, limb_product_plain(a, b, variant))}
        w = fl.limbs_to_ints(got[:8, :64].cpu())     # 256-bit halves
        hi = fl.limbs_to_ints(got[8:, :64].cpu())
        for i in range(64):
            if variant == "floor":
                want = [((xs[i] >> 32 * k) & fl.MASK) * ((ys[i] >> 32 * k)
                        & fl.MASK) for k in range(8)]
                lo = sum((v & fl.MASK) << 32 * k for k, v in enumerate(want))
                hw = sum((v >> 32) << 32 * k for k, v in enumerate(want))
                ok = w[i] == lo and hi[i] == hw
            else:
                ok = w[i] + (hi[i] << 256) == xs[i] * ys[i]
            if not ok:
                raise AssertionError(f"{name} value {i}")
        st["ms"] = timed_ms(lambda: limb_product(a, b, variant), dev, REPS)
        st["plain_ms"] = timed_ms(lambda: limb_product_plain(a, b, variant),
                                  dev, PLAIN_REPS)
        out[name] = st
    return out


def main(argv) -> int:
    log_n = int(argv[0]) if argv else 20
    res = measure(log_n)
    for name, st in res.items():
        print(f"{name}: " + ", ".join(f"{k} {v}" for k, v in st.items()))
    bad = [k for k, st in res.items()
           if st.get("max_abs_err", 0) or st.get("k1_err", 0)]
    print(json.dumps(res))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
