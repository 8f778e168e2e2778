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

Dispatch (the K1 rule): CPU tensors take the plain versions,
`permute_plain` and `combine_plain` (the loop of torch ops); CUDA
tensors take K4 (`csrc/mimc.cu`), one launch per permutation, with the
tree's pairwise add and the absorb's state + digest fused in, counted in
`kernels.launches["mimc"]`; any other device raises. The two agree bit
for bit.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels
from ..config import resolve_device
from ..curve import bn254
from ..curve.group import G1, Point, to_affine_batch
from ..fields import cuda_limb
from ..fields import limb as fl
from . import trace

FR = bn254.FR
N_ROUNDS = 110


@functools.lru_cache(None)
def _round_constants(device: torch.device) -> torch.Tensor:
    """[N_ROUNDS, 8, 1] Montgomery constants (fixed-seed uniform draws),
    round after round in memory, as K4 reads them."""
    rng = np.random.default_rng(0xF5)
    vals = [int.from_bytes(rng.bytes(40), "little") % bn254.R
            for _ in range(N_ROUNDS)]
    return fl.tensor(FR.to_mont_ints(vals), device).T.reshape(
        N_ROUNDS, fl.NLIMBS, 1).contiguous()


def permute_plain(x, y=None):
    """permute(x), or permute(x + y), in torch ops: 110 rounds of
    x <- (x + c_i)^5, batched over the vector axis; three Montgomery
    products per round, 330 in all."""
    if y is not None:
        x = fl.add(FR, x, y)
    consts = _round_constants(x.device)
    for i in range(N_ROUNDS):
        t = fl.add(FR, x, consts[i])
        t4 = fl.mont_sqr(FR, fl.mont_sqr(FR, t))
        x = fl.mont_mul(FR, t4, t)
    return x


def combine_plain(h):
    """One level of the digest tree over [8, m], m >= 2, in torch ops:
    lane j < m // 2 becomes permute(h[j] + h[m // 2 + j]) and, for odd m,
    lane m // 2 becomes permute(h[m - 1])."""
    half = h.shape[-1] // 2
    comb = fl.add(FR, h[..., :half], h[..., half : 2 * half])
    if h.shape[-1] % 2:
        comb = torch.cat([comb, h[..., -1:]], dim=-1)
    return permute_plain(comb)


def _check(x) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"permute: unsupported device {x.device}")
    if x.dtype != torch.int32:
        raise TypeError("permute: limbs must be int32")
    if x.dim() != 2 or x.shape[0] != fl.NLIMBS or x.shape[1] == 0:
        raise ValueError(f"permute: expected [8, n], got {tuple(x.shape)}")


def _launch(a, a_off, b, b_off, ld, n_add, n_out):
    """K4 (`csrc/mimc.cu`): lane j of the [8, n_out] output is
    permute(a[j] + b[j]) for j < n_add, else permute(b[j]), where limb k
    of x[j] is word x_off + k * ld + j of x's storage; a may be None when
    n_add is 0."""
    dev = b.device
    out = torch.empty((fl.NLIMBS, n_out), dtype=torch.int32, device=dev)
    fn = kernels.function("mimc.cu", "lsk_mimc")
    err = fn(None if a is None else a.data_ptr() + 4 * a_off,
             b.data_ptr() + 4 * b_off, ld, out.data_ptr(), n_add, n_out,
             _round_constants(dev).data_ptr(), N_ROUNDS,
             ctypes.cast(cuda_limb.field_words(FR.p), ctypes.c_void_p),
             torch.cuda.current_stream(dev).cuda_stream)
    kernels.check("mimc.cu", err, "mimc")
    kernels.count("mimc", n_out)
    return out


def _permute_k4(x, y):
    """permute(x) (y None) or permute(x + y) for contiguous [8, n]."""
    n = x.shape[1]
    if y is None:
        return _launch(None, 0, x, 0, n, 0, n)
    return _launch(x, 0, y, 0, n, n, n)


def _combine_k4(h):
    """One tree level over a contiguous [8, m], both halves read in
    place: b starts at lane m // 2, so the odd last lane is b[m // 2]."""
    m = h.shape[1]
    half = m // 2
    return _launch(h, 0, h, half, m, half, m - half)


def permute(x, y=None):
    """MiMC-5 over Fr, batched over the vector axis; with y,
    permute(x + y). One permutation (`mimc.permute`): on CPU tensors
    `permute_plain`, on the card one launch of K4 for operands [8, n] of
    one shape."""
    trace.count("mimc.permute")
    if x.device.type == "cpu":
        return permute_plain(x, y)
    _check(x)
    if y is None:
        return _permute_k4(x.contiguous(), None)
    _check(y)
    if y.shape != x.shape or y.device != x.device:
        raise ValueError("permute: operands differ in shape or device: "
                         f"{tuple(x.shape)} on {x.device}, "
                         f"{tuple(y.shape)} on {y.device}")
    return _permute_k4(x.contiguous(), y.contiguous())


def combine(h):
    """One level of the digest tree (`combine_plain`) as one permutation:
    on the card one launch of K4 with the pairwise add fused in."""
    trace.count("mimc.permute")
    if h.device.type == "cpu":
        return combine_plain(h)
    _check(h)
    return _combine_k4(h.contiguous())


def _tree_digest(v):
    """Compress [8, m] columns to one [8, 1] digest: permute all lanes
    once, then ceil(log2(m)) levels of `combine`."""
    h = permute(v)
    while h.shape[-1] > 1:
        h = combine(h)
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
        self.state = permute(self.state, digest)

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
