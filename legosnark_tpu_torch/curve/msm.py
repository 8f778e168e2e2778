"""Multi-scalar multiplication and fixed-base batch multiplication.

Counterpart of `legosnark_tpu/curve/msm.py:55-88, 175-287, 342-416,
431-528`. Pippenger's bucket phase becomes sort + suffix scan, as in the
JAX package:

  for each window j (signed digit d_i = (-1)^neg_i * mag_i of scalar k_i):
    1. sort the points by mag                      (torch.sort)
    2. suffix sums S[i] = sum_{t >= i} P_sorted[t] (`group.scan`, ~2n adds)
    3. window sum = sum_{t=1}^{2^(c-1)} S[first index with mag >= t]
       (torch.searchsorted, a gather, and a tree sum)
  then a Horner combine over the windows with c doublings each (one
  `CurveOps.double(acc, times=c)` call, one K3 launch on G1, one K6
  launch on G2).

The windows run in chunks, the counterpart of the JAX package's
`_window_chunk` and its `lax.map` over windows: the windows of a chunk
run steps 1-3 as one batch, and a chunk holds as many windows as fit
`WINDOW_BUDGET` (`windows_per_chunk`). All windows fit in one chunk up
to 2^21 G1 rows at c = 17 (the 2^20 bench, CPpoly's pair commitment over
2^20); Groth16's MSMs at n = 128, over 2^21 points and more, take two
(G1) or four (G2).

Digits are always signed (the bucket range halves, so c = 17 costs the
boundary phase of an unsigned 16-bit window): the window count is
ceil((bits + 1) / c), so the top window always absorbs the last carry.
Step 1 gathers from [P | -P], so one gather both sorts and negates, in
descending order of mag, so that step 2 is a prefix scan. Every add and
double of a G1 MSM runs in kernels K2/K3, of a G2 MSM in K5/K6.

Spans (`utils/trace`): `msm` around each MSM (attributes: curve, rows,
points, c, chunks), with the children `msm.digits` (signed digits and
the negated sources), `msm.chunk` per chunk of windows (its window
range, and one count of the counter `msm.chunks`) and `msm.horner`;
`msm.batch` around each fixed-base batch (curve, scalars, chunks), one
count of `msm.batch_chunks` per chunk of `BATCH_CHUNK` scalars.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..fields import limb as fl
from ..utils import trace
from . import bn254
from .group import CurveOps, Point, point_concat, point_map, scan

#: device bytes that one chunk of windows may hold in its per-window
#: copies of the gathered points (`window_bytes`); about a fifth of the
#: H100's 80 GB, so that the keys and inputs of the largest caller
#: (Groth16 at n = 128) fit beside it
WINDOW_BUDGET = 16 << 30
#: copies of a window's gathered coordinates live at once at the peak of
#: its prefix scan: the gathered points, the scan's contiguous operands,
#: its levels and its output; K2 and K5 hold no temporaries. Measured on
#: the H100 at Groth16's n = 128 shapes (`scripts/profile_msm_stages_torch.py
#: --groth16`): 3.48-3.67 on G1; on G2 8.25-8.33 while its law ran in
#: torch code (its products and int64 columns beside the copies), 3.47-3.58
#: on K5, which G2's value has yet to follow (it sets the chunking).
LIVE_COPIES_G1 = 4
LIVE_COPIES_G2 = 9
#: scalars per chunk of `batch_scalar_mul`: a few GB of gathered table
#: points at most. Smaller chunks left a G2 batch bound by the host's
#: dispatch while the G2 law ran in torch code (measured on the H100 at
#: Groth16's n = 128 key batches: `scripts/profile_msm_stages_torch.py
#: --batch`)
BATCH_CHUNK = 1 << 16


def window_bytes(C: CurveOps, lead, n: int) -> int:
    """Bytes one window of an n-point MSM holds at its peak: the live
    copies of its gathered coordinates, 3 x [lead.., E.., n] int32."""
    words = fl.NLIMBS * (C.F.ndim - 1)
    copies = LIVE_COPIES_G1 if C.g1 else LIVE_COPIES_G2
    return copies * 3 * math.prod(lead) * words * n * 4


def windows_per_chunk(C: CurveOps, W: int, lead, n: int) -> int:
    """Windows per chunk: all W when they fit `WINDOW_BUDGET`, else the
    fewest equal chunks that fit (one window per chunk at least)."""
    per = window_bytes(C, lead, n)
    fit = max(1, WINDOW_BUDGET // per)
    if fit >= W:
        return W
    return -(-W // -(-W // fit))


def point_index(C: CurveOps, p: Point, idx, lead) -> Point:
    """One gather per window along the vector (last) axis: idx [W, L.., m]
    (L broadcasting against the batch shape `lead`) turns coordinates
    [B.., E.., n] into [W, lead.., E.., m]."""
    edims = C.F.ndim - 1

    def take(t):
        src = t.expand(lead + t.shape[t.dim() - edims - 1:])
        src = src[None].expand((idx.shape[0],) + src.shape)
        i = idx.view(idx.shape[:-1] + (1,) * edims + idx.shape[-1:])
        return torch.gather(src, -1, i.expand(src.shape[:-1] + i.shape[-1:]))
    return point_map(take, p)


def _all_digits(spec: fl.FieldSpec, scalars, c: int, W: int):
    """[W, n] int64 base-2^c digits of canonical scalars [8, n]."""
    return torch.stack([fl.get_window(spec, scalars, j * c, c)
                        for j in range(W)])


def _signed_digits(digits, c: int):
    """Unsigned digits [W, n] -> (mag [W, n] in [0, 2^(c-1)], neg [W, n]):
    a digit above 2^(c-1) becomes -(2^c - d) plus a carry into the next
    window."""
    half, full = 1 << (c - 1), 1 << c
    mags, negs = [], []
    carry = torch.zeros_like(digits[0])
    for j in range(digits.shape[0]):
        d = digits[j] + carry
        neg = d > half
        mags.append(torch.where(neg, full - d, d))
        negs.append(neg)
        carry = neg.to(digits.dtype)
    return torch.stack(mags), torch.stack(negs)


def _rows(m, lead):
    """Per-window values [Wc, S.., k] viewed against [Wc, lead.., k]."""
    return m.view(m.shape[:1] + (1,) * (len(lead) + 2 - m.dim())
                  + m.shape[1:])


def _sort_windows(mags, negs):
    """A chunk's digits [Wc, S.., n] -> (the mags sorted ascending, the
    positions in [P | -P] of the points in descending order of mag)."""
    n = mags.shape[-1]
    smag, order = torch.sort(mags, dim=-1)
    idx = torch.where(torch.gather(negs, -1, order), order + n, order)
    return smag, idx.flip(-1)


def _bucket_sums(C: CurveOps, smag, pre: Point, lead, T: int) -> Point:
    """Window sums [Wc, lead.., E.., 1] = sum over t = 1..T of the suffix
    sum from the first sorted position with mag >= t, read from the
    prefix sums `pre` of the descending order."""
    n = smag.shape[-1]
    t = torch.arange(1, T + 1, dtype=smag.dtype, device=smag.device)
    first = torch.searchsorted(smag, t.expand(smag.shape[:-1] + (T,))
                               .contiguous())               # [Wc, S.., T]
    ix = _rows(n - 1 - first.clamp(max=n - 1), lead)
    edims = C.F.ndim - 1

    def gather(a):
        g = ix.view(ix.shape[:-1] + (1,) * edims + (T,))
        return torch.gather(a, -1, g.expand(a.shape[:-1] + (T,)))

    bnd = C.select(_rows(first < n, lead), point_map(gather, pre),
                   C.identity(pre.x.shape[:1] + lead + (T,), smag.device))
    return C.sum_reduce(bnd)


def _window_sums(C: CurveOps, src: Point, mags, negs, lead, T: int) -> Point:
    """Steps 1-3 for a chunk of windows: digits [Wc, S.., n] against the
    sources [P | -P] -> window sums [Wc, lead.., E.., 1]."""
    smag, idx = _sort_windows(mags, negs)
    ps = point_index(C, src, _rows(idx, lead), lead)   # [Wc, lead.., E.., n]
    pre = Point(*scan(lambda a, b: C.add(Point(*a), Point(*b)), ps))
    del ps
    return _bucket_sums(C, smag, pre, lead, T)


def _horner(C: CurveOps, S: Point, c: int) -> Point:
    """sum_j 2^(c j) S_j from the most significant window down."""
    W = S.x.shape[0]
    acc = point_map(lambda a: a[W - 1], S)
    for j in range(W - 2, -1, -1):
        acc = C.add(C.double(acc, times=c), point_map(lambda a: a[j], S))
    return acc


def msm(C: CurveOps, points: Point, scalars, c: int | None = None,
        fr_spec: fl.FieldSpec = bn254.FR,
        window_chunk: int | None = None) -> Point:
    """sum_i scalars_i * points_i for canonical Fr scalars [S.., 8, n].

    points: a batch [B.., E.., n] (E the element axes: limbs for G1,
    tower and limbs for G2). The batch axes B and S broadcast against
    each other, so several MSMs run as one: over shared scalars (S
    empty), over shared points (B empty), or both. Every row runs the
    group operations it would run alone. `window_chunk` sets the windows
    per chunk (default: `windows_per_chunk`); every width gives the same
    result. Returns coordinates [lead.., E.., 1], lead the broadcast of B
    and S."""
    if c is None:
        from ..config import default_window
        c = default_window(scalars.shape[-1])
    if not 1 <= c <= 31:
        raise ValueError(f"window {c} outside [1, 31]")
    n = scalars.shape[-1]
    dev = scalars.device
    # numpy's broadcast: torch.broadcast_shapes imports sympy at its first
    # call (seconds on the card's host, inside the first MSM's time)
    lead = tuple(np.broadcast_shapes(tuple(C.F.batch_shape(points.x)[:-1]),
                                     tuple(scalars.shape[:-2])))
    if n == 0:
        return C.identity(lead + (1,), dev)
    W = -(-(fr_spec.bits + 1) // c)
    if window_chunk is None:
        window_chunk = windows_per_chunk(C, W, lead, n)
    if window_chunk < 1:
        raise ValueError(f"window_chunk {window_chunk} < 1")
    with trace.span("msm", curve="G1" if C.g1 else "G2",
                    rows=math.prod(lead), points=n, c=c,
                    chunks=-(-W // window_chunk)):
        with trace.span("msm.digits"):
            mags, negs = _signed_digits(_all_digits(fr_spec, scalars, c, W),
                                        c)
            src = point_concat([points, C.neg(points)])
        parts = []
        for j in range(0, W, window_chunk):
            with trace.span("msm.chunk",
                            windows=(j, min(W, j + window_chunk))):
                trace.count("msm.chunks")
                parts.append(_window_sums(
                    C, src, mags[j : j + window_chunk],
                    negs[j : j + window_chunk], lead, 1 << (c - 1)))
        with trace.span("msm.horner"):
            return _horner(C, point_map(lambda *a: torch.cat(a), *parts), c)


def msm_mont(C: CurveOps, points: Point, scalars_mont, c: int | None = None,
             fr_spec: fl.FieldSpec = bn254.FR) -> Point:
    """`msm` for Montgomery-form Fr scalars (one conversion, then `msm`)."""
    return msm(C, points, fl.from_mont(fr_spec, scalars_mont), c=c,
               fr_spec=fr_spec)


# ---------------------------------------------------------------------------
# Fixed-base batched scalar multiplication (keygen path)
# ---------------------------------------------------------------------------


def fixed_base_table(C: CurveOps, base: Point, c: int = 8,
                     bits: int = fl.LIMB_BITS * fl.NLIMBS) -> Point:
    """Window table T[j, m] = m * 2^(c*j) * base, batch shape [W, 2^c]
    (coordinates [W, .., 2^c]); base is a single point [.., 1]."""
    W = -(-bits // c)
    qs = [base]
    for _ in range(W - 1):
        qs.append(C.double(qs[-1], times=c))
    # Q_j on a leading axis: [W, .., 1]
    step = point_map(lambda *a: torch.stack(a), *qs)
    # multiples 0..2^c-1 by doubling blocks: T[2^i + m] = T[m] + 2^i Q
    tab = point_map(lambda i, s: torch.cat([i, s], -1),
                    C.identity((W, 1), base.x.device), step)
    for _ in range(1, c):
        step = C.double(step)
        tab = point_map(lambda t, s: torch.cat([t, s], -1), tab,
                        C.add(tab, step))
    return tab


@functools.lru_cache(None)
def generator_table(C: CurveOps, device: torch.device) -> Point:
    """`fixed_base_table` of C's generator with c = 8, built once per
    curve and device, which every keygen of a process would otherwise
    repeat. Callers must not write into it."""
    from .group import g1_generator, g2_generator
    gen = g1_generator if C.g1 else g2_generator
    return fixed_base_table(C, gen((), device), c=8)


def batch_scalar_mul(C: CurveOps, table: Point, scalars, c: int = 8,
                     fr_spec: fl.FieldSpec = bn254.FR) -> Point:
    """[k_i * base] for canonical scalars [8, n] with a `fixed_base_table`:
    per scalar, one table point per window and a tree sum over windows.
    Runs in chunks of `BATCH_CHUNK` scalars so the [W, .., chunk]
    gathered parts stay bounded."""
    W = fl.num_windows(fr_spec, c)
    if W > table.x.shape[0]:
        raise ValueError("table too small for the scalar bit length")
    edims = table.x.dim() - 2
    n = scalars.shape[-1]
    outs = []
    with trace.span("msm.batch", curve="G1" if C.g1 else "G2", scalars=n,
                    chunks=-(-n // BATCH_CHUNK)):
        for s0 in range(0, n, BATCH_CHUNK):
            trace.count("msm.batch_chunks")
            digits = _all_digits(fr_spec, scalars[..., s0 : s0 + BATCH_CHUNK],
                                 c, W)
            m = digits.shape[-1]

            def gather(a, digits=digits, m=m):
                a = a[:W]
                g = digits.view((W,) + (1,) * edims + (m,))
                return torch.gather(a, -1, g.expand(a.shape[:-1] + (m,)))

            outs.append(tree_reduce_leading(C, point_map(gather, table)))
        return point_concat(outs)


def tree_reduce_leading(C: CurveOps, p: Point) -> Point:
    """Tree sum over axis 0, keeping the other batch axes."""
    n = p.x.shape[0]
    while n > 1:
        half = n // 2
        s = C.add(point_map(lambda x: x[0 : 2 * half : 2], p),
                  point_map(lambda x: x[1 : 2 * half : 2], p))
        if n % 2:
            s = point_map(lambda a, b: torch.cat([a, b[-1:]], 0), s, p)
        p = s
        n = (n + 1) // 2
    return point_map(lambda x: x[0], p)
