"""Multi-scalar multiplication and fixed-base batch multiplication.

Counterpart of `legosnark_tpu/curve/msm.py:55-88, 175-287, 356-416,
431-528`. Pippenger's bucket phase becomes sort + suffix scan, as in the
JAX package, for every window at once:

  for each window j (signed digit d_i = (-1)^neg_i * mag_i of scalar k_i):
    1. sort the points by mag                      (torch.sort)
    2. suffix sums S[i] = sum_{t >= i} P_sorted[t] (`group.scan`, ~2n adds)
    3. window sum = sum_{t=1}^{2^(c-1)} S[first index with mag >= t]
       (torch.searchsorted, a gather, and a tree sum)
  then a Horner combine over the windows with c doublings each (one
  `CurveOps.double(acc, times=c)` call, one K3 launch on G1).

Digits are always signed (the bucket range halves, so c = 17 costs the
boundary phase of an unsigned 16-bit window): the window count is
ceil((bits + 1) / c), so the top window always absorbs the last carry.
Every add and double of a G1 MSM runs in kernels K2/K3.
"""
from __future__ import annotations

import torch

from ..fields import limb as fl
from . import bn254
from .group import CurveOps, Point, point_concat, point_map, scan


def point_index(p: Point, idx) -> Point:
    """One gather per window along the vector (last) axis: idx [W, m]
    turns coordinates [.., n] into [W, .., m]."""
    return point_map(lambda t: torch.movedim(t[..., idx], -2, 0), p)


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


def msm(C: CurveOps, points: Point, scalars, c: int | None = None,
        fr_spec: fl.FieldSpec = bn254.FR) -> Point:
    """sum_i scalars_i * points_i for canonical Fr scalars [8, n].

    points: a batch [B.., E.., n] (E the element axes: limbs for G1,
    tower and limbs for G2); every leading batch row B takes the same
    scalars, so several MSMs over shared scalars run as one. Returns
    coordinates [B.., E.., 1]."""
    if c is None:
        from ..config import default_window
        c = default_window(scalars.shape[-1])
    if not 1 <= c <= 31:
        raise ValueError(f"window {c} outside [1, 31]")
    n = scalars.shape[-1]
    dev = scalars.device
    lead = C.F.batch_shape(points.x)[:-1]
    if n == 0:
        return C.identity(lead + (1,), dev)
    W = -(-(fr_spec.bits + 1) // c)
    mags, negs = _signed_digits(_all_digits(fr_spec, scalars, c, W), c)
    T = 1 << (c - 1)

    def rows(m):
        """[W, m] per-window values against [W, B.., m] batches."""
        return m.view((W,) + (1,) * len(lead) + m.shape[-1:])

    smag, order = torch.sort(mags, dim=-1)                  # [W, n]
    ps = point_index(points, order)                         # [W, B.., E.., n]
    ps = C.select(rows(torch.gather(negs, -1, order)), C.neg(ps), ps)
    suf = Point(*scan(lambda a, b: C.add(Point(*a), Point(*b)), ps,
                      reverse=True))

    # bucket boundaries: first sorted position with mag >= t, t = 1..T
    t = torch.arange(1, T + 1, dtype=smag.dtype, device=dev)
    idx = torch.searchsorted(smag, t.expand(W, T).contiguous())
    ix = idx.clamp(max=n - 1)

    def gather(a):
        g = ix.view((W,) + (1,) * (a.dim() - 2) + (T,))
        return torch.gather(a, -1, g.expand(a.shape[:-1] + (T,)))

    bnd = C.select(rows(idx < n), point_map(gather, suf),
                   C.identity((W,) + lead + (T,), dev))
    S = C.sum_reduce(bnd)                                   # [W, B.., E.., 1]

    # Horner from the most significant window down
    acc = point_map(lambda a: a[W - 1], S)
    for j in range(W - 2, -1, -1):
        acc = C.add(C.double(acc, times=c), point_map(lambda a: a[j], S))
    return acc


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


def batch_scalar_mul(C: CurveOps, table: Point, scalars, c: int = 8,
                     fr_spec: fl.FieldSpec = bn254.FR) -> Point:
    """[k_i * base] for canonical scalars [8, n] with a `fixed_base_table`:
    per scalar, one table point per window and a tree sum over windows.
    Runs in chunks of 2^14 scalars so the [W, .., chunk] gathered parts
    stay bounded."""
    W = fl.num_windows(fr_spec, c)
    if W > table.x.shape[0]:
        raise ValueError("table too small for the scalar bit length")
    edims = table.x.dim() - 2
    chunk = 1 << 14
    outs = []
    for s0 in range(0, scalars.shape[-1], chunk):
        digits = _all_digits(fr_spec, scalars[..., s0 : s0 + chunk], c, W)
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
