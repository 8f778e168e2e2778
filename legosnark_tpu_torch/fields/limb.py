"""Batched multi-limb modular arithmetic on torch tensors.

Counterpart of `legosnark_tpu/fields/limb.py`.

Layout
* A batch of field elements is an int32 tensor `[..., 8, n]`: eight
  little-endian 32-bit limbs on the second-to-last axis (limb-major, as
  the JAX package's `[..., 20, n]` with 13-bit limbs) and a batch axis
  last. A single element is `[8, 1]`.
* The int32 values are the limbs' uint32 bit patterns: `torch.uint32`
  has no `add` and no `>>` on the CPU. The CUDA kernels reinterpret the
  words as `uint32_t`; the torch code widens them to int64 with
  `& 0xFFFFFFFF`.
* Montgomery form with R = 2^256. R/q ~ 5.29 and R/r ~ 5.29.

Contract: every value lies in the redundant domain [0, 2p) with exact
limbs. `add`, `sub` and `neg` reduce modulo 2p; `mont_mul` returns
(a*b + M*p)/R with M = -a*b/p mod R in [0, R), which is < 1.76p for
inputs < 2p, with no final subtraction. Only `canon`, `from_mont` and the
comparisons subtract p. The kernels of `cuda_limb` and `curve/cuda_group`
keep the same contract, so their outputs equal the torch code's bit for
bit.

Carries in the torch code run on int64 columns: a few magnitude passes
shrink each column to at most one limb plus one, then one cumulative max
resolves the remaining carry chains exactly (the JAX package's
`_carry_exact`, with 32-bit limbs).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

LIMB_BITS = 32
NLIMBS = 8
MASK = (1 << LIMB_BITS) - 1


@dataclass(frozen=True)
class FieldSpec:
    """A prime field below 2^256 in the port's limb layout."""

    p: int
    name: str = "F"

    @property
    def bits(self) -> int:
        return self.p.bit_length()

    @property
    def R(self) -> int:
        return 1 << (LIMB_BITS * NLIMBS)

    @functools.cached_property
    def R2(self) -> int:
        return self.R * self.R % self.p

    @functools.cached_property
    def ninv32(self) -> int:
        """-p^-1 mod 2^32, the per-word factor of the CIOS reduction."""
        return (-pow(self.p, -1, 1 << 32)) % (1 << 32)

    @functools.cached_property
    def ninv(self) -> int:
        """-p^-1 mod R."""
        return (-pow(self.p, -1, self.R)) % self.R

    def to_mont_int(self, x: int) -> int:
        return (int(x) % self.p) * self.R % self.p

    def to_mont_ints(self, xs) -> np.ndarray:
        """ints -> Montgomery limbs, int32 numpy [8, n]."""
        return ints_to_limbs([self.to_mont_int(x) for x in xs])

    def from_mont_int(self, v: int) -> int:
        return int(v) * pow(self.R, -1, self.p) % self.p


# ---------------------------------------------------------------------------
# host conversions
# ---------------------------------------------------------------------------


def ints_to_limbs(xs) -> np.ndarray:
    """Non-negative ints < 2^256 -> int32 numpy [8, n] (uint32 bit patterns)."""
    xs = [int(x) for x in xs]
    if not xs:
        return np.zeros((NLIMBS, 0), dtype=np.int32)
    buf = b"".join(x.to_bytes(4 * NLIMBS, "little") for x in xs)
    words = np.frombuffer(buf, dtype="<u4").reshape(len(xs), NLIMBS)
    return np.ascontiguousarray(words.T).view(np.int32)


def limbs_to_ints(v) -> np.ndarray:
    """Limbs [..., 8, V] (tensor or numpy) -> object array of ints [..., V]."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    v = np.asarray(v).astype(np.int64) & MASK
    moved = np.ascontiguousarray(np.moveaxis(v, -2, -1)).astype("<u4")
    flat = moved.reshape(-1, NLIMBS)
    out = np.empty((flat.shape[0],), dtype=object)
    for i in range(flat.shape[0]):
        out[i] = int.from_bytes(flat[i].tobytes(), "little")
    return out.reshape(moved.shape[:-1])


def tensor(arr, device) -> torch.Tensor:
    """int32 numpy limbs -> tensor on `device`."""
    return torch.from_numpy(np.array(arr).view(np.int32)).to(device)


@functools.lru_cache(None)
def _consts(p: int, device: torch.device) -> dict:
    """Per-(field, device) constant limb tensors."""
    R = 1 << (LIMB_BITS * NLIMBS)
    spec = FieldSpec(p)

    def i32(x):
        return tensor(ints_to_limbs([x]), device)

    def i64(x):
        return i32(x).to(torch.int64) & MASK

    def halves(x):
        return torch.tensor([(x >> (16 * k)) & 0xFFFF for k in range(16)],
                            dtype=torch.int64, device=device)

    one0 = torch.zeros((NLIMBS, 1), dtype=torch.int64, device=device)
    one0[0, 0] = 1
    return {
        "p2_64": i64(2 * p),
        "p2_comp64": i64(R - 2 * p),
        "canon_comps64": torch.stack([i64(R - k * p) for k in (1, 2, 3)]),
        "one0_64": one0,
        "r2": i32(spec.R2),
        "one_std": i32(1),
        "one_mont": i32(R % p),
        "zero": i32(0),
        "p16": halves(p)[:, None],
        "ninv16": halves(spec.ninv),
    }


def consts(spec: FieldSpec, device) -> dict:
    return _consts(spec.p, torch.device(device))


def const_mont(spec: FieldSpec, x: int, device) -> torch.Tensor:
    """Montgomery form of x as an [8, 1] tensor (cached; do not write)."""
    return _const_mont(spec.p, int(x), torch.device(device))


@functools.lru_cache(None)
def _const_mont(p: int, x: int, device: torch.device) -> torch.Tensor:
    return tensor(ints_to_limbs([FieldSpec(p).to_mont_int(x)]), device)


# ---------------------------------------------------------------------------
# int64 column helpers (limb axis = -2)
# ---------------------------------------------------------------------------


def widen(x: torch.Tensor) -> torch.Tensor:
    """int32 limb bit patterns -> their uint32 values in int64."""
    return x.to(torch.int64) & MASK


def narrow(u: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 bit patterns."""
    return ((u ^ 0x80000000) - 0x80000000).to(torch.int32)


def shift_up(c: torch.Tensor) -> torch.Tensor:
    """Move every row one limb up (axis -2); the top row falls off."""
    return torch.constant_pad_nd(c[..., :-1, :], (0, 0, 1, 0))


def pad_top(c: torch.Tensor, k: int = 1) -> torch.Tensor:
    """Append k zero limbs above the top one."""
    return torch.constant_pad_nd(c, (0, 0, 0, k))


@functools.lru_cache(None)
def _ramp(k: int, device: torch.device) -> torch.Tensor:
    return torch.arange(2, 2 * k + 2, 2, dtype=torch.int64,
                        device=device).view(k, 1)


def exact(x: torch.Tensor, bits: int, passes: int) -> torch.Tensor:
    """Exact `bits`-bit limbs of the column sum mod 2^(bits*K).

    x: non-negative int64 columns [..., K, V]. `passes` magnitude passes
    must bring every column to at most 2^(bits+1) - 2; then every carry is
    0 or 1, and the carry into limb i is 1 iff the nearest limb below i
    that is not all ones is at least 2^bits, found by one cumulative max
    over (2j+2 | generate bit)."""
    mask = (1 << bits) - 1
    for _ in range(passes):
        x = (x & mask) + shift_up(x >> bits)
    t = torch.where(x == mask, 0, _ramp(x.shape[-2], x.device) + (x >> bits))
    m = torch.cummax(t, dim=-2).values
    return (x + shift_up(m & 1)) & mask


def _exact_pair(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Exact 32-bit limbs of two column sets at once, one limb taller:
    [2, ..., 9, V]. Columns are < 3*2^32, so one pass leaves them at most
    2^32 + 1."""
    return exact(pad_top(torch.stack([lo, hi])), LIMB_BITS, 1)


# ---------------------------------------------------------------------------
# field ops
# ---------------------------------------------------------------------------


def add(spec: FieldSpec, a, b):
    """(a + b) mod 2p for a, b in [0, 2p); a + b < 4p < R."""
    a, b = torch.broadcast_tensors(a, b)
    s = widen(a) + widen(b)
    t = _exact_pair(s, s + consts(spec, a.device)["p2_comp64"])
    ge = t[1, ..., NLIMBS:, :] > 0                      # a + b >= 2p
    return narrow(torch.where(ge, t[1, ..., :NLIMBS, :], t[0, ..., :NLIMBS, :]))


def sub(spec: FieldSpec, a, b):
    """a - b, plus 2p when a < b: in [0, 2p) for a, b in [0, 2p)."""
    a, b = torch.broadcast_tensors(a, b)
    c = consts(spec, a.device)
    cols = widen(a) + (MASK - widen(b)) + c["one0_64"]   # a + R - b
    t = _exact_pair(cols, cols + c["p2_64"])
    ge = t[0, ..., NLIMBS:, :] > 0                      # a >= b
    return narrow(torch.where(ge, t[0, ..., :NLIMBS, :], t[1, ..., :NLIMBS, :]))


def neg(spec: FieldSpec, a):
    """2p - a for a in (0, 2p); 0 stays 0."""
    return sub(spec, torch.zeros_like(a), a)


def canon(spec: FieldSpec, x):
    """Canonical representative (< p) of a value < 4p: x - kp for the
    largest k in {0, 1, 2, 3} that leaves it non-negative."""
    u = widen(x)
    comps = consts(spec, x.device)["canon_comps64"]     # R - kp, k = 1..3
    comps = comps.view((3,) + (1,) * (u.dim() - 2) + comps.shape[-2:])
    t = exact(pad_top(u + comps), LIMB_BITS, 1)         # columns < 2^33
    for k in range(3):
        u = torch.where(t[k, ..., NLIMBS:, :] > 0, t[k, ..., :NLIMBS, :], u)
    return narrow(u)


def mont_mul(spec: FieldSpec, a, b):
    """Montgomery product a*b/R for a, b in [0, 2p); result < 1.76p.

    Every product runs in kernel K1 on CUDA tensors and in its plain
    version on CPU tensors (`cuda_limb.mont_mul`)."""
    from . import cuda_limb
    return cuda_limb.mont_mul(spec, a, b)


def mont_sqr(spec: FieldSpec, a):
    return mont_mul(spec, a, a)


def to_mont(spec: FieldSpec, x):
    return mont_mul(spec, x, consts(spec, x.device)["r2"])


def from_mont(spec: FieldSpec, x):
    """Montgomery -> canonical standard form (< p)."""
    return canon(spec, mont_mul(spec, x, consts(spec, x.device)["one_std"]))


def _batched(shape):
    shape = tuple(shape)
    if not shape:
        return (NLIMBS, 1)
    return shape[:-1] + (NLIMBS, shape[-1])


def zero(spec: FieldSpec, shape, device):
    """Zero batch; `shape` is the batch shape, vector axis last."""
    return consts(spec, device)["zero"].expand(_batched(shape))


def one(spec: FieldSpec, shape, device):
    return consts(spec, device)["one_mont"].expand(_batched(shape))


def is_zero(spec: FieldSpec, a):
    """[..., V] mask: 0 is represented as 0 or p."""
    return torch.all(canon(spec, a) == 0, dim=-2)


def eq(spec: FieldSpec, a, b):
    return torch.all(canon(spec, a) == canon(spec, b), dim=-2)


def select(cond, a, b):
    """cond ? a : b with cond [..., V] and a, b [..., 8, V]."""
    return torch.where(cond[..., None, :], a, b)


def mont_pow(spec: FieldSpec, a, e: int):
    """a^e for a static exponent: square-and-multiply, MSB first."""
    if e == 0:
        return one(spec, a.shape[:-2] + a.shape[-1:], a.device)
    acc = a
    for bit in bin(e)[3:]:
        acc = mont_sqr(spec, acc)
        if bit == "1":
            acc = mont_mul(spec, acc, a)
    return acc


def inv(spec: FieldSpec, a):
    """Batched inverse by Fermat (a^(p-2)); inv(0) = 0."""
    return mont_pow(spec, a, spec.p - 2)


def batch_inv_scan(spec: FieldSpec, a):
    """Inverses over the vector (last) axis by Montgomery's trick, zeros
    mapped to zero: prefix and suffix products by `curve.group.scan`
    (log depth, about 4n products in 4 log2(n) batched calls), one
    inversion of the total, then inv(a_i) = total^-1 * prefix_(i-1) *
    suffix_(i+1) in two products of width n."""
    from ..curve.group import scan

    shape = a.shape[:-2] + a.shape[-1:]
    zmask = is_zero(spec, a)
    ones = one(spec, shape, a.device)
    safe = select(zmask, ones, a)

    def mul(x, y):
        return (mont_mul(spec, x[0], y[0]),)

    (pref,) = scan(mul, (safe,))
    (suf,) = scan(mul, (safe,), reverse=True)
    pref_m1 = torch.cat([ones[..., :1], pref[..., :-1]], dim=-1)
    suf_p1 = torch.cat([suf[..., 1:], ones[..., :1]], dim=-1)
    out = mont_mul(spec, inv(spec, pref[..., -1:]),
                   mont_mul(spec, pref_m1, suf_p1))
    return select(zmask, zero(spec, shape, a.device), out)


def get_window(spec: FieldSpec, x, start_bit: int, width: int):
    """Bits [start_bit, start_bit + width) of canonical limbs as int64
    [..., V]. A window of up to 31 bits spans at most two 32-bit limbs
    (c = 17 windows straddle limb boundaries)."""
    if not 1 <= width <= 31:
        raise ValueError(f"window width {width} outside [1, 31]")
    limb, off = divmod(start_bit, LIMB_BITS)
    if limb >= NLIMBS:
        return torch.zeros(x.shape[:-2] + x.shape[-1:], dtype=torch.int64,
                           device=x.device)
    out = widen(x[..., limb, :]) >> off
    spill = off + width - LIMB_BITS
    if spill > 0 and limb + 1 < NLIMBS:
        hi = widen(x[..., limb + 1, :]) & ((1 << spill) - 1)
        out = out | (hi << (LIMB_BITS - off))
    return out & ((1 << width) - 1)


def num_windows(spec: FieldSpec, width: int) -> int:
    return -(-spec.bits // width)
