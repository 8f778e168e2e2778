"""The sharded layer on `torch.distributed`: MSM, sumcheck and NTT over
a group of ranks.

Counterpart of `legosnark_tpu/parallel/sharded.py`. Where the JAX package
wraps each function in `shard_map` over a mesh, here every rank of a
process group calls the function with its own shard and the group, and
gets back its shard or the replicated result, as the JAX `out_specs`
say (`launch.run` starts such a group):

  * `msm_sharded`: points and scalars in contiguous blocks, one local
    MSM per rank, the one-point partials all-gathered and summed;
  * `shard_table` / `fold_sharded` / `field_sum_sharded` /
    `sumcheck_rounds_sharded`: 2^d tables distributed cyclically (the
    rank carries the low index bits), so each fold binds the top variable
    without communication until the local width is 1; then the k
    singletons are gathered and the last log2 W rounds run replicated;
  * `matrix_fold_sharded` / `cpmat_rounds_sharded`: the CPmmp prover's
    core on column blocks of the matrices;
  * `ntt_sharded`: the four-step (Bailey) NTT with one all-to-all.

Collectives go through two private helpers that choose their path from
`dist.get_backend(group)`: NCCL moves the device tensors, gloo explicit
host copies that go back to the tensor's device. `collective_bytes`
counts, per collective, the bytes this rank received from the others.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from ..curve import bn254
from ..curve import msm as msm_mod
from ..curve.group import CurveOps, Point, point_map
from ..fields import limb as fl
from ..prototools import mle, ntt as ntt_mod

FR = bn254.FR
R = bn254.R

#: collective name -> bytes this rank received from the other ranks since
#: the last `reset_collective_bytes()`
collective_bytes: collections.Counter = collections.Counter()


def reset_collective_bytes() -> None:
    collective_bytes.clear()


def make_group(n_ranks: int | None = None):
    """The process group of the initialised world (`make_mesh`,
    `sharded.py:46`): every rank of the world is one shard. Raises when
    `torch.distributed` is not initialised or the world does not have
    `n_ranks` ranks."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: start the "
                           "ranks with launch.run or init_process_group")
    world = dist.get_world_size()
    if n_ranks is not None and n_ranks != world:
        raise ValueError(f"requested a group of {n_ranks} ranks in a world "
                         f"of {world}")
    return dist.group.WORLD


def _wire(x, group):
    """The tensor a collective of `group` sends for `x`: `x` itself on
    NCCL, an explicit host copy on gloo."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        return x.contiguous()
    if backend == "gloo":
        return x.detach().to("cpu").contiguous()
    raise ValueError(f"unsupported backend {backend}")


def _all_gather_last(x, group):
    """[..., m] on every rank -> [..., W*m], the ranks' blocks in rank
    order along the last axis (`jax.lax.all_gather(..., tiled=True)`)."""
    W = dist.get_world_size(group)
    w = _wire(x, group)
    parts = [torch.empty_like(w) for _ in range(W)]
    dist.all_gather(parts, w, group=group)
    collective_bytes["all_gather"] += (W - 1) * w.numel() * w.element_size()
    return torch.cat(parts, dim=-1).to(x.device)


def _all_to_all_leading(x, group):
    """x [W, ...]: block s goes to rank s; returns [W, ...] whose block s
    came from rank s."""
    W = dist.get_world_size(group)
    w = _wire(x, group)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    collective_bytes["all_to_all"] += (W - 1) * w.numel() // W * \
        w.element_size()
    return out.to(x.device)


def _gather_point_sum(C: CurveOps, p: Point, group) -> Point:
    """All-gather the ranks' one-point partials [.., E.., 1] onto the
    vector axis and tree-sum them (`sharded.py:63`)."""
    return C.sum_reduce(point_map(lambda t: _all_gather_last(t, group), p))


def msm_sharded(C: CurveOps, points: Point, scalars, group,
                c: int | None = None) -> Point:
    """sum_i k_i P_i over all ranks (`sharded.py:73`).

    In: this rank's contiguous block of the n points (coordinates
    [.., E.., n/W], G1 or G2) and of the canonical scalars [8, n/W].
    Out: the total [.., E.., 1], replicated. Each rank runs `msm.msm` on
    its block with window c (default `config.default_window(n/W)`)."""
    part = msm_mod.msm(C, points, scalars, c=c)
    return _gather_point_sum(C, part, group)


# ---------------------------------------------------------------------------
# Sharded sumcheck tables (cyclic distribution)
# ---------------------------------------------------------------------------


def shard_table(v, W: int):
    """[..., 8, 2^d] -> [W, ..., 8, 2^d/W] cyclic distribution
    (`sharded.py:113`): shard s, position q holds index q*W + s."""
    n = v.shape[-1]
    if n % W:
        raise ValueError(f"table width {n} does not divide over {W} ranks")
    return v.reshape(v.shape[:-1] + (n // W, W)).movedim(-1, 0)


def unshard_table(v):
    """Inverse of `shard_table` (`sharded.py:123`)."""
    r = v.movedim(0, -1)
    return r.reshape(r.shape[:-2] + (r.shape[-2] * r.shape[-1],))


def fold_sharded(table, r):
    """One sumcheck fold of this rank's cyclic shard [..., 8, w]
    (`sharded.py:130`): binding the top variable pairs positions with
    the same low bits, so it is `mle.fold` of the shard and needs no
    communication (and no group). Out: the folded shard [..., 8, w/2]."""
    return mle.fold(table, r)


def field_sum_sharded(v, group):
    """Sum of a vector spread over the ranks (`sharded.py:142`): this
    rank's part [..., 8, w] (any distribution: the sum is order-free) ->
    the total [..., 8, 1], replicated. A local tree sum, an all-gather of
    the partials, and their sum."""
    return mle.field_sum(_all_gather_last(mle.field_sum(v), group))


def sumcheck_rounds_sharded(tables, challenges, group) -> mle.SumcheckRounds:
    """`mle.prove_rounds` over cyclically sharded tables (`sharded.py:156`).

    In: this rank's shard [k, 8, 2^d/W] (`shard_table(tables, W)[rank]`)
    and the challenges [8, d], replicated. Out: `mle.SumcheckRounds`
    (h_coeffs [d, 8, k+1], finals [k, 8, 1], zs [8, d+1]), replicated.
    Each round polynomial is a local `mle.round_poly` whose partials are
    gathered and summed. Folds stay local until the local width is 1: at
    that moment the remaining log2 W variables are the rank bits, so the
    k singletons, gathered in rank order onto the vector axis, are the
    remaining table in index order, and the last rounds run replicated.
    Gathering at any other width would mix variables."""
    W = dist.get_world_size(group)
    d = challenges.shape[-1]
    if tables.shape[-1] * W != 1 << d:
        raise ValueError("shard width times ranks does not match 2^d")
    t = tables
    replicated = False
    hs, zs = [], []
    for i in range(d):
        if not replicated and t.shape[-1] == 1:
            t = _all_gather_last(t, group)                 # [k, 8, W]
            replicated = True
        h = mle.round_poly(t)                              # [8, k+1]
        if not replicated:
            parts = _all_gather_last(h[..., None], group)  # [8, k+1, W]
            h = mle.field_sum_leading(parts.movedim(-1, 0))
        r = challenges[..., i : i + 1]
        hs.append(h)
        zs.append(mle.poly_eval(h, r))
        t = fold_sharded(t, r)
    dev = t.device
    z0 = fl.add(FR, mle.poly_eval(hs[0], fl.zero(FR, (), dev)),
                mle.poly_eval(hs[0], fl.one(FR, (), dev)))
    return mle.SumcheckRounds(h_coeffs=torch.stack(hs), finals=t,
                              zs=torch.cat([z0] + zs, dim=-1))


def matrix_fold_sharded(A, beta_rho, group):
    """`mle.matrix_mle_fold` of a column-sharded matrix
    (`sharded.py:209`). In: this rank's contiguous column block
    [n, 8, n/W] (rows leading) and the eq table [8, n], replicated. Out:
    the folded [8, n], replicated: each rank folds its columns over the
    rows (no communication), and the [8, n/W] blocks are gathered."""
    return _all_gather_last(mle.matrix_mle_fold(A, beta_rho), group)


def cpmat_rounds_sharded(A, B_T, beta_r, beta_s, challenges, group):
    """The CPmmp prover's core (`sharded.py:227`): `matrix_fold_sharded`
    of A's and B^T's column blocks [n, 8, n/W], then
    `sumcheck_rounds_sharded` on this rank's cyclic shard of the two
    folded tables. Out: `mle.SumcheckRounds`, replicated."""
    W = dist.get_world_size(group)
    rank = dist.get_rank(group)
    tables = torch.stack([matrix_fold_sharded(A, beta_r, group),
                          matrix_fold_sharded(B_T, beta_s, group)])
    return sumcheck_rounds_sharded(tables[..., rank::W].contiguous(),
                                   challenges, group)


# ---------------------------------------------------------------------------
# Sharded four-step NTT
# ---------------------------------------------------------------------------


def ntt_sharded(x, group, inverse: bool = False):
    """Four-step (Bailey) NTT of [..., 8, n] over W ranks
    (`sharded.py:245`), n = W * n2 with n2 % W == 0.

    In: this rank's cyclic shard x[..., rank::W] [..., 8, n2], which is
    row j1 = rank of A[j1][j2] = x[j1 + W*j2]. Out: this rank's chunk
    [..., 8, n2] of the output: the n2/W values k2 of block `rank`, each
    with its W values k1, element X[k2 + n2*k1] at (k2 - rank*n2/W)*W +
    k1; `ntt_unshard` reassembles natural order from the ranks' chunks.
      1. `ntt.ntt` of the row: size n2, root w^W (`fr_two_adic_root(log
         n)` raised to 2^k is `fr_two_adic_root(log n - k)`);
      2. times the twiddles w^(j1*k2), a host table (`ntt.power_limbs`)
         since each rank knows its j1;
      3. one all-to-all: block s of k2 to rank s;
      4. `ntt.ntt` of size W over j1 for each k2 (root w^n2).
    With inverse=True both NTTs run inverse, and their 1/n2 and 1/W
    scales multiply to 1/n. The JAX version's `_geom_powers`, `_ntt_any`
    and `_ntt_rows` (:317, :331, :355) are not copied: `ntt.ntt` already
    takes a batch and any power-of-two size."""
    W = dist.get_world_size(group)
    j1 = dist.get_rank(group)
    n2 = x.shape[-1]
    n = W * n2
    log_n = n.bit_length() - 1
    if 1 << log_n != n or n2 % W:
        raise ValueError(f"ntt_sharded needs n = W * n2, a power of two, "
                         f"with n2 % W == 0; got W={W}, n2={n2}")
    root = bn254.fr_two_adic_root(log_n)
    if inverse:
        root = pow(root, R - 2, R)
    y = ntt_mod.ntt(x, inverse=inverse)                    # [..., 8, n2]
    tw = fl.tensor(ntt_mod.power_limbs(pow(root, j1, R), n2), x.device)
    y = fl.mont_mul(FR, y, tw)
    lead = y.shape[:-1]
    y = y.reshape(lead + (W, n2 // W)).movedim(-2, 0)      # [W, ..., 8, n2/W]
    y = _all_to_all_leading(y, group)                      # block s: row j1=s
    y = y.movedim(0, -1)                                   # [..., 8, n2/W, W]
    y = ntt_mod.ntt(y.movedim(-3, -2), inverse=inverse)    # limbs at -2
    return y.movedim(-2, -3).reshape(lead + (n2,))


def ntt_unshard(chunks):
    """The ranks' `ntt_sharded` chunks, stacked [W, ..., 8, n2] in rank
    order -> natural order [..., 8, W * n2]."""
    W, n2 = chunks.shape[0], chunks.shape[-1]
    lead = chunks.shape[1:-1]
    y = chunks.reshape((W,) + lead + (n2 // W, W)).movedim(0, -3)
    y = y.reshape(lead + (n2, W)).transpose(-1, -2)        # [..., k1, k2]
    return y.reshape(lead + (W * n2,))
