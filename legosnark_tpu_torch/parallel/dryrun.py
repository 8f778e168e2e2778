"""The sharded layer's cross-checks over a world of W ranks.

Counterpart of `__graft_entry__.py:dryrun_multichip` (:42-131) and
`entry` (:20): each function of `sharded` runs on a world started by
`launch.run`, and its output, reassembled, must equal the port's local
engine on the same inputs: the MSM (G1 and G2), the field sum and the
fold, the sumcheck rounds (k tables), the CPmmp core (`matrix_mle_fold`
and `prove_rounds`) and the NTT forward and inverse.

Every rank draws the same inputs from one numpy seed (`make_inputs`) and
takes its own shard. The G1 MSM's points are k_i*G with known k_i and
the G2 MSM's are (i + 1)*G2, distinct points, so that a wrong shard
order changes the result (the JAX dry run's broadcast generator would
hide it).

    python -m legosnark_tpu_torch.parallel.dryrun W [--cpu]
        [--sizes small|dryrun|full]

runs W ranks: with --cpu on gloo on the CPU, else on NCCL with one card
each (it raises without W cards). `--sizes dryrun` (the default) is the
JAX dry run's, `small` the tests', `full` `chip_smoke.py` phase 12's.
"""
from __future__ import annotations

import argparse
import sys
from typing import NamedTuple

import numpy as np
import torch

from ..config import resolve_device
from ..curve import bn254, msm
from ..curve.group import (G1, G2, Point, g1_to_ints, g2_generator,
                           g2_to_ints, scan)
from ..fields import limb as fl
from ..prototools import mle, ntt
from ..utils.rand import rand_fr_limbs_fast
from . import launch, sharded

FR = bn254.FR


class Sizes(NamedTuple):
    msm_n: int           # G1 MSM points, in contiguous blocks (0: no MSM)
    msm_c: int | None    # its window (None: config.default_window(n/W))
    g2_n: int            # G2 MSM points (0: no G2 MSM)
    vec_n: int           # field sum and fold width
    sumcheck_d: int      # sumcheck variables
    ks: tuple            # sumcheck table counts
    ntt_n: int           # NTT size
    cpmat_n: int         # CPmmp matrix side


#: the tests' sizes
SMALL = Sizes(32, 4, 8, 64, 5, (2, 3), 1 << 8, 8)
#: `dryrun_multichip`'s sizes (`__graft_entry__.py:66-114`)
DRYRUN = Sizes(1 << 14, 8, 16, 1 << 12, 12, (2,), 1 << 12, 1 << 6)
#: `chip_smoke.py` phase 12: CPmmp's commit width (2^20 at c = 17), its
#: n = 1024 matrices, and Groth16 n = 64's 2^18 domain
FULL = Sizes(1 << 20, 17, 1 << 8, 1 << 20, 20, (2, 3), 1 << 18, 1 << 10)
PRESETS = {"small": SMALL, "dryrun": DRYRUN, "full": FULL}


def make_inputs(sizes: Sizes, seed: int) -> dict:
    """Every input as canonical Fr limbs (int32 numpy, below 2^253), drawn
    in one order from `seed`: the same on every rank and in the caller."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        """[.., 8, m] of shape (.., m)."""
        flat = rand_fr_limbs_fast(rng, int(np.prod(shape)))
        return np.moveaxis(flat.reshape((fl.NLIMBS,) + shape), 0, -2).copy()

    d, dm = sizes.sumcheck_d, sizes.cpmat_n.bit_length() - 1
    inp = {"msm_k": draw(sizes.msm_n), "msm_s": draw(sizes.msm_n),
           "g2_s": draw(sizes.g2_n), "vec": draw(sizes.vec_n), "r": draw(1),
           "chal": draw(d), "ntt": draw(sizes.ntt_n),
           "A": draw(sizes.cpmat_n, sizes.cpmat_n),
           "B_T": draw(sizes.cpmat_n, sizes.cpmat_n),
           "rho_r": draw(dm), "rho_s": draw(dm), "chal_m": draw(dm)}
    for k in sizes.ks:
        inp[f"tables{k}"] = draw(k, 1 << d)
    return inp


def _mont(a, device):
    return fl.to_mont(FR, fl.tensor(np.ascontiguousarray(a), device))


def g1_points(k, device) -> Point:
    """k_i * G for canonical k [8, m] (fixed-base, `msm.generator_table`)."""
    return msm.batch_scalar_mul(G1, msm.generator_table(G1, device),
                                fl.tensor(np.ascontiguousarray(k), device))


def g2_points(n: int, device) -> Point:
    """(i + 1) * G2 for i < n, by one prefix scan of the generator."""
    return Point(*scan(lambda a, b: G2.add(Point(*a), Point(*b)),
                       tuple(g2_generator((n,), device))))


def _block(n: int, W: int, rank: int) -> slice:
    if n % W:
        raise ValueError(f"{n} points do not divide over {W} ranks")
    m = n // W
    return slice(rank * m, (rank + 1) * m)


def rank_main(ctx: launch.Rank, sizes: Sizes, seed: int) -> dict:
    """One rank's share of the dry run: every sharded function on this
    rank's shard of `make_inputs(sizes, seed)`, each call `measured`.
    Returns {"out": name -> output, "stats": function -> measurements}."""
    s, W, group, dev = ctx.rank, ctx.world, ctx.group, ctx.device
    inp = make_inputs(sizes, seed)
    stats, out = {}, {}

    def run(name, fn, *args, **kwargs):
        return launch.measured(ctx, stats, name, fn, *args, **kwargs)

    if sizes.msm_n:
        b = _block(sizes.msm_n, W, s)
        pts = g1_points(inp["msm_k"][:, b], dev)
        out["msm_g1"] = run("msm_sharded_g1", sharded.msm_sharded, G1, pts,
                            fl.tensor(inp["msm_s"][:, b].copy(), dev), group,
                            c=sizes.msm_c)
    if sizes.g2_n:
        b = _block(sizes.g2_n, W, s)
        pts = Point(*(t[..., b] for t in g2_points(sizes.g2_n, dev)))
        out["msm_g2"] = run("msm_sharded_g2", sharded.msm_sharded, G2, pts,
                            fl.tensor(inp["g2_s"][:, b].copy(), dev), group)

    vec = _mont(inp["vec"][..., s::W], dev)
    out["field_sum"] = run("field_sum_sharded", sharded.field_sum_sharded,
                           vec, group)
    out["fold"] = run("fold_sharded", sharded.fold_sharded, vec,
                      _mont(inp["r"], dev))
    chal = _mont(inp["chal"], dev)
    for k in sizes.ks:
        out[f"sumcheck_k{k}"] = run(
            f"sumcheck_rounds_sharded_k{k}", sharded.sumcheck_rounds_sharded,
            _mont(inp[f"tables{k}"][..., s::W], dev), chal, group)

    b = _block(sizes.cpmat_n, W, s)
    beta_r = mle.mk_beta(_mont(inp["rho_r"], dev))
    beta_s = mle.mk_beta(_mont(inp["rho_s"], dev))
    out["cpmat"] = run("cpmat_rounds_sharded", sharded.cpmat_rounds_sharded,
                       _mont(inp["A"][..., b], dev),
                       _mont(inp["B_T"][..., b], dev), beta_r, beta_s,
                       _mont(inp["chal_m"], dev), group)

    x = _mont(inp["ntt"][..., s::W], dev)
    out["ntt"] = run("ntt_sharded", sharded.ntt_sharded, x, group)
    out["intt"] = run("ntt_sharded_inverse", sharded.ntt_sharded, x, group,
                      inverse=True)
    return {"out": out, "stats": stats}


def reference(sizes: Sizes, seed: int, device) -> dict:
    """The local engine's outputs on the whole of `make_inputs(sizes,
    seed)`, under the names of `rank_main`'s outputs."""
    dev = torch.device(device)
    inp = make_inputs(sizes, seed)
    vec = _mont(inp["vec"], dev)
    chal = _mont(inp["chal"], dev)
    folded = torch.stack([
        mle.matrix_mle_fold(_mont(inp["A"], dev),
                            mle.mk_beta(_mont(inp["rho_r"], dev))),
        mle.matrix_mle_fold(_mont(inp["B_T"], dev),
                            mle.mk_beta(_mont(inp["rho_s"], dev)))])
    x = _mont(inp["ntt"], dev)
    ref = {"field_sum": mle.field_sum(vec),
           "fold": mle.fold(vec, _mont(inp["r"], dev)),
           "cpmat": mle.prove_rounds(folded, _mont(inp["chal_m"], dev)),
           "ntt": ntt.ntt(x), "intt": ntt.intt(x)}
    for k in sizes.ks:
        ref[f"sumcheck_k{k}"] = mle.prove_rounds(
            _mont(inp[f"tables{k}"], dev), chal)
    if sizes.msm_n:
        ref["msm_g1"] = msm.msm(G1, g1_points(inp["msm_k"], dev),
                                fl.tensor(inp["msm_s"], dev), c=sizes.msm_c)
    if sizes.g2_n:
        ref["msm_g2"] = msm.msm(G2, g2_points(sizes.g2_n, dev),
                                fl.tensor(inp["g2_s"], dev))
    return ref


#: outputs each rank holds a shard of, and how the shards reassemble
_SHARDED = {"fold": sharded.unshard_table, "ntt": sharded.ntt_unshard,
            "intt": sharded.ntt_unshard}


def _same_bits(a, b) -> bool:
    if isinstance(a, tuple):
        return all(np.array_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(a, b)


def assemble(ranks: list) -> dict:
    """The world's outputs from `launch.run(rank_main, ...)`: the
    replicated ones (which must agree bit for bit on every rank) from rank
    0, the sharded ones reassembled; numpy arrays."""
    outs = [r["out"] for r in ranks]
    world = {}
    for name, first in outs[0].items():
        if name in _SHARDED:
            shards = torch.from_numpy(np.stack([o[name] for o in outs]))
            world[name] = _SHARDED[name](shards).numpy()
            continue
        for rank, o in enumerate(outs[1:], 1):
            if not _same_bits(first, o[name]):
                raise AssertionError(
                    f"{name}: rank {rank}'s replicated result differs from "
                    "rank 0's")
        world[name] = first
    return world


def _canon(x, device):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return fl.canon(FR, x.to(device))


def check(world: dict, ref: dict) -> None:
    """Raise unless every output of `assemble` equals the local engine's:
    points as affine points, field values as canonical integers."""
    for name, want in ref.items():
        got = world[name]
        if name.startswith("msm"):
            to_ints = g1_to_ints if name == "msm_g1" else g2_to_ints
            same = to_ints(Point(*(torch.from_numpy(c) for c in got))) == \
                to_ints(want)
        else:
            dev = (want[0] if isinstance(want, tuple) else want).device
            pairs = zip(got, want) if isinstance(want, tuple) else \
                [(got, want)]
            same = all(torch.equal(_canon(g, dev), _canon(w, dev))
                       for g, w in pairs)
        if not same:
            raise AssertionError(f"sharded {name} diverges from the local "
                                 "engine")


def summary(ranks: list) -> dict:
    """Per function: the fastest and the slowest rank's seconds, the
    launches per kernel and the collective bytes summed over the ranks."""
    out = {}
    for name in ranks[0]["stats"]:
        st = [r["stats"][name] for r in ranks]
        launches: dict = {}
        for s in st:
            for k, v in s["launches"].items():
                launches[k] = launches.get(k, 0) + v
        out[name] = {"seconds": min(s["seconds"] for s in st),
                     "slowest_s": max(s["seconds"] for s in st),
                     "launches": launches,
                     "collective_bytes": sum(s["collective_bytes"]
                                             for s in st)}
    return out


def run_world(devices, backend: str, sizes: Sizes, seed: int,
              ref: dict) -> tuple:
    """`rank_main` on one rank per entry of `devices`, checked against
    `ref` (`reference(sizes, seed, ...)`); returns (assembled outputs,
    each rank's result)."""
    ranks = launch.run(rank_main, devices, backend, sizes, seed)
    world = assemble(ranks)
    check(world, ref)
    return world, ranks


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="python -m legosnark_tpu_torch."
                                 "parallel.dryrun")
    ap.add_argument("world", type=int)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo on the CPU instead of NCCL over W cards")
    ap.add_argument("--sizes", choices=sorted(PRESETS), default="dryrun")
    a = ap.parse_args(argv)
    seed = 1
    sizes = PRESETS[a.sizes]
    if a.cpu:
        dev, devices, backend = torch.device("cpu"), ["cpu"] * a.world, "gloo"
    else:
        dev = resolve_device(None)
        if torch.cuda.device_count() < a.world:
            raise RuntimeError(f"NCCL needs {a.world} cards, this machine "
                               f"has {torch.cuda.device_count()}")
        devices, backend = [f"cuda:{r}" for r in range(a.world)], "nccl"
    ref = reference(sizes, seed, dev)
    world, ranks = run_world(devices, backend, sizes, seed, ref)
    for name, st in summary(ranks).items():
        print(f"{name}: {st['seconds']:.3f}-{st['slowest_s']:.3f}s launches "
              f"{st['launches']} collective bytes {st['collective_bytes']}")
    print(f"dryrun({a.world}, {backend}, {a.sizes}): ok: msm.x[0, 0]="
          f"{int(world['msm_g1'].x[0, 0])}, zs shape "
          f"{world[f'sumcheck_k{sizes.ks[0]}'].zs.shape}, ntt ok, cpmat ok")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
