"""The port's sharded layer (legosnark_tpu_torch.parallel) on gloo worlds
of 4 and 1 CPU ranks, started once per module through `launch.run`.

Every result is held exactly, as canonical integers or affine points, to
the port's local engine (`dryrun.check`), to host integers
(`tests/oracle.py` for the MSMs) and to the JAX package's
`parallel/sharded` on the same numpy inputs on a 4-device mesh of the
conftest's CPU devices. The JAX `msm_sharded` (~80 s of XLA compiles)
and the whole dry run at `__graft_entry__`'s sizes against the JAX
package are slow-tier.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from legosnark_tpu.curve import bn254 as jbn
from legosnark_tpu.curve.group import G1 as JG1, G2 as JG2
from legosnark_tpu.curve.group import (g1_from_oracle, g1_to_oracle,
                                       g2_from_oracle, g2_to_oracle)
from legosnark_tpu.fields import limb as jfl
from legosnark_tpu.parallel import sharded as jsh
from legosnark_tpu.prototools import mle as jmle

from legosnark_tpu_torch import convert
from legosnark_tpu_torch.curve import bn254
from legosnark_tpu_torch.curve.group import Point, g1_to_ints, g2_to_ints
from legosnark_tpu_torch.fields import limb as fl
from legosnark_tpu_torch.parallel import dryrun, launch, sharded

# The plain path runs many small torch ops; idle intra-op threads spin and
# starve the other test processes, so the port's tests use one thread.
torch.set_num_threads(1)

R = bn254.R
SIZES = dryrun.SMALL
SEED = 3


def ints(a) -> list:
    """Canonical port limbs (numpy or tensor) [.., 8, m] -> flat ints."""
    return [int(v) for v in fl.limbs_to_ints(a).reshape(-1)]


def mont_ints(a) -> list:
    """Port Montgomery limbs [.., 8, m] -> flat canonical ints."""
    return [int(v) for v in convert.to_ints(torch.as_tensor(a)).reshape(-1)]


def jax_ints(j) -> list:
    return [int(v) for v in
            convert.jax_field_ints(np.asarray(j), bn254.FR).reshape(-1)]


def to_jax(a):
    """Canonical port limbs [.., 8, m] -> JAX Montgomery limbs [.., 20, m]."""
    vals = fl.limbs_to_ints(a)
    flat = jbn.FR.to_mont_ints([int(v) for v in vals.reshape(-1)])
    arr = np.asarray(flat).reshape((flat.shape[0],) + vals.shape)
    return jnp.asarray(np.moveaxis(arr, 0, -2))


def host_rounds(tables, chal):
    """prove_rounds on host ints: tables [k][2^d], chal [d] -> (h, finals,
    zs) with h [d][k+1] ascending."""
    hs, zs = [], []
    for r in chal:
        half = len(tables[0]) // 2
        h = [0] * (len(tables) + 1)
        for p in range(half):
            poly = [1]
            for t in tables:
                lo, sl = t[p], (t[p + half] - t[p]) % R
                poly = [((poly[i] if i < len(poly) else 0) * lo +
                         (poly[i - 1] if i else 0) * sl) % R
                        for i in range(len(poly) + 1)]
            h = [(a + b) % R for a, b in zip(h, poly)]
        hs.append(h)
        zs.append(sum(c * pow(r, i, R) for i, c in enumerate(h)) % R)
        tables = [[(t[p] + r * (t[p + half] - t[p])) % R
                   for p in range(half)] for t in tables]
    z0 = (2 * hs[0][0] + sum(hs[0][1:])) % R
    return hs, [t[0] for t in tables], [z0] + zs


def host_beta(rho):
    """eq table of rho (variable i at bit d-1-i) on host ints."""
    t = [1]
    for r in reversed(rho):
        t = [v * (1 - r) % R for v in t] + [v * r % R for v in t]
    return t


def assert_rounds(got, want):
    hs, finals, zs = want
    assert [mont_ints(got.h_coeffs[i]) for i in range(len(hs))] == hs
    assert mont_ints(got.finals) == finals
    assert mont_ints(got.zs) == zs


@pytest.fixture(scope="module")
def inputs():
    return dryrun.make_inputs(SIZES, SEED)


@pytest.fixture(scope="module")
def ref():
    return dryrun.reference(SIZES, SEED, "cpu")


@pytest.fixture(scope="module", params=[4, 1], ids=["w4", "w1"])
def world(request):
    """(W, each rank's result, the assembled outputs) of one gloo world."""
    W = request.param
    ranks = launch.run(dryrun.rank_main, ["cpu"] * W, "gloo", SIZES, SEED)
    return W, ranks, dryrun.assemble(ranks)


def jax_sharded(inputs, sizes, with_msm=False):
    """The JAX package's sharded functions on a 4-device mesh, on the
    same inputs, under the names of `dryrun.rank_main`'s outputs."""
    mesh = jsh.make_mesh(4)
    j = {k: to_jax(v) for k, v in inputs.items()}
    sv = jsh.shard_table(j["vec"], 4)
    out = {"field_sum": jsh.field_sum_sharded(sv, mesh),
           "fold": jsh.unshard_table(jsh.fold_sharded(sv, j["r"], mesh)),
           "cpmat": jsh.cpmat_rounds_sharded(
               j["A"], j["B_T"], jmle.mk_beta(j["rho_r"]),
               jmle.mk_beta(j["rho_s"]), j["chal_m"], mesh),
           "ntt": jsh.ntt_sharded(j["ntt"], mesh),
           "intt": jsh.ntt_sharded(j["ntt"], mesh, inverse=True)}
    for k in sizes.ks:
        out[f"sumcheck_k{k}"] = jsh.sumcheck_rounds_sharded(
            j[f"tables{k}"], j["chal"], mesh)
    if with_msm:
        pts = g1_from_oracle([oracle.g1_mul(oracle.G1, k)
                              for k in ints(inputs["msm_k"])])
        s = jfl.ints_to_limbs(ints(inputs["msm_s"]), jbn.FR.nlimbs)
        out["msm_g1"] = g1_to_oracle(jsh.msm_sharded(
            JG1, pts, jnp.asarray(s), mesh, c=sizes.msm_c))
        pts = g2_from_oracle([oracle.g2_mul(oracle.G2, i + 1)
                              for i in range(sizes.g2_n)])
        s = jfl.ints_to_limbs(ints(inputs["g2_s"]), jbn.FR.nlimbs)
        out["msm_g2"] = g2_to_oracle(jsh.msm_sharded(
            JG2, pts, jnp.asarray(s), mesh, c=4))
    return out


def assert_equals_jax(out, jout):
    """Every output of a port world equals the JAX package's."""
    for name, j in jout.items():
        if name == "msm_g1":
            assert g1_to_ints(Point(*map(torch.from_numpy, out[name]))) == [j]
        elif name == "msm_g2":
            assert g2_to_ints(Point(*map(torch.from_numpy, out[name]))) == [j]
        elif isinstance(j, tuple):
            for g, w in zip(out[name], j):
                assert mont_ints(g) == jax_ints(w), name
        else:
            assert mont_ints(out[name]) == jax_ints(j), name


@pytest.fixture(scope="module")
def jax_out(inputs):
    return jax_sharded(inputs, SIZES)


def test_shard_table_equals_jax(inputs):
    v = fl.tensor(inputs[f"tables{SIZES.ks[0]}"], "cpu")
    jv = to_jax(inputs[f"tables{SIZES.ks[0]}"])
    for W in (1, 2, 4):
        sv = sharded.shard_table(v, W)
        assert sv.shape == (W,) + v.shape[:-1] + (v.shape[-1] // W,)
        assert ints(sv) == jax_ints(jsh.shard_table(jv, W))
        assert torch.equal(sharded.unshard_table(sv), v)
        # shard s, position q holds index q*W + s
        assert torch.equal(sv[W - 1][..., 1], v[..., W + W - 1])
    with pytest.raises(ValueError, match="divide"):
        sharded.shard_table(v, 3)


def test_world_equals_local_engine(world, ref):
    W, ranks, out = world
    assert len(ranks) == W
    dryrun.check(out, ref)


def test_msm_sharded_g1_g2_equal_oracle(world, inputs):
    W, _, out = world
    ks, ss = ints(inputs["msm_k"]), ints(inputs["msm_s"])
    e = sum(k * s for k, s in zip(ks, ss)) % R
    assert g1_to_ints(Point(*map(torch.from_numpy, out["msm_g1"]))) == \
        [oracle.g1_mul(oracle.G1, e)]
    e2 = sum((i + 1) * s for i, s in enumerate(ints(inputs["g2_s"]))) % R
    assert g2_to_ints(Point(*map(torch.from_numpy, out["msm_g2"]))) == \
        [oracle.g2_mul(oracle.G2, e2)]


def test_field_sum_and_fold_equal_host(world, inputs):
    _, _, out = world
    v, (r,) = ints(inputs["vec"]), ints(inputs["r"])
    assert mont_ints(out["field_sum"]) == [sum(v) % R]
    half = len(v) // 2
    want = [(v[p] + r * (v[p + half] - v[p])) % R for p in range(half)]
    assert mont_ints(out["fold"]) == want


@pytest.mark.parametrize("k", SIZES.ks)
def test_sumcheck_rounds_sharded_equal_host(world, inputs, k):
    _, _, out = world
    n = 1 << SIZES.sumcheck_d
    flat = ints(inputs[f"tables{k}"])
    want = host_rounds([flat[i * n : (i + 1) * n] for i in range(k)],
                       ints(inputs["chal"]))
    assert_rounds(out[f"sumcheck_k{k}"], want)


def test_cpmat_rounds_sharded_equal_host(world, inputs):
    _, _, out = world
    n = SIZES.cpmat_n
    tables = []
    for name, rho in (("A", "rho_r"), ("B_T", "rho_s")):
        m, beta = ints(inputs[name]), host_beta(ints(inputs[rho]))
        tables.append([sum(m[r * n + c] * beta[r] for r in range(n)) % R
                       for c in range(n)])
    want = host_rounds(tables, ints(inputs["chal_m"]))
    assert_rounds(out["cpmat"], want)


def test_ntt_sharded_equals_host(world, inputs):
    _, _, out = world
    x = ints(inputs["ntt"])
    n = len(x)
    w = bn254.fr_two_adic_root(n.bit_length() - 1)
    wi, ninv = pow(w, R - 2, R), pow(n, R - 2, R)
    fwd = [sum(v * pow(w, j * k, R) for j, v in enumerate(x)) % R
           for k in range(n)]
    inv = [ninv * sum(v * pow(wi, j * k, R) for j, v in enumerate(x)) % R
           for k in range(n)]
    assert mont_ints(out["ntt"]) == fwd
    assert mont_ints(out["intt"]) == inv


def test_measurements(world):
    """Each function is timed on every rank; on the CPU no kernel
    launches; collectives receive bytes only from other ranks."""
    W, ranks, _ = world
    gathers = ("msm_sharded_g1", "msm_sharded_g2", "field_sum_sharded",
               "cpmat_rounds_sharded", "ntt_sharded", "ntt_sharded_inverse")
    for r in ranks:
        st = r["stats"]
        assert set(st) == {"msm_sharded_g1", "msm_sharded_g2",
                           "field_sum_sharded", "fold_sharded",
                           "cpmat_rounds_sharded", "ntt_sharded",
                           "ntt_sharded_inverse"} | {
            f"sumcheck_rounds_sharded_k{k}" for k in SIZES.ks}
        assert all(s["seconds"] > 0 and s["launches"] == {}
                   for s in st.values())
        assert st["fold_sharded"]["collective_bytes"] == 0
        for name in gathers:
            assert (st[name]["collective_bytes"] > 0) == (W > 1)
        # the field sum gathers one [8, 1] int32 partial from each other rank
        assert st["field_sum_sharded"]["collective_bytes"] == (W - 1) * 32
    summ = dryrun.summary(ranks)
    assert summ["ntt_sharded"]["collective_bytes"] == \
        sum(r["stats"]["ntt_sharded"]["collective_bytes"] for r in ranks)
    assert all(s["slowest_s"] >= s["seconds"] for s in summ.values())


def test_check_and_assemble_catch_a_wrong_world(world, ref):
    W, ranks, out = world
    bad = dict(out)
    bad["ntt"] = out["ntt"][..., ::-1].copy()
    with pytest.raises(AssertionError, match="ntt"):
        dryrun.check(bad, ref)
    zs = out["sumcheck_k2"].zs.copy()
    zs[..., -1] = zs[..., -2]
    bad = dict(out, sumcheck_k2=out["sumcheck_k2"]._replace(zs=zs))
    with pytest.raises(AssertionError, match="sumcheck_k2"):
        dryrun.check(bad, ref)
    ident = Point(*(np.zeros_like(c) for c in out["msm_g1"]))
    with pytest.raises(AssertionError, match="msm_g1"):
        dryrun.check(dict(out, msm_g1=ident), ref)
    if W > 1:
        tampered = [dict(r, out=dict(r["out"])) for r in ranks]
        tampered[1]["out"]["field_sum"] = tampered[0]["out"]["fold"][..., :1]
        with pytest.raises(AssertionError, match="rank 1"):
            dryrun.assemble(tampered)


@pytest.mark.parametrize("W", [2, 8])
def test_more_world_sizes_equal_local_engine_and_host(W):
    """Every function but the MSMs (covered at W = 1 and 4) on 2 and 8
    ranks: the replicated sumcheck tail starts after d - log2 W local
    rounds, at W = 8 the CPmmp core's tables start at width 1."""
    sizes = SIZES._replace(msm_n=0, g2_n=0)
    out, ranks = dryrun.run_world(["cpu"] * W, "gloo", sizes, SEED,
                                  dryrun.reference(sizes, SEED, "cpu"))
    assert len(ranks) == W and not any(k.startswith("msm") for k in out)
    inputs = dryrun.make_inputs(sizes, SEED)
    n = 1 << SIZES.sumcheck_d
    for k in SIZES.ks:
        flat = ints(inputs[f"tables{k}"])
        assert_rounds(out[f"sumcheck_k{k}"], host_rounds(
            [flat[i * n : (i + 1) * n] for i in range(k)],
            ints(inputs["chal"])))


def test_a_rank_that_raises_makes_run_raise():
    bad = SIZES._replace(msm_n=3)
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="do not divide"):
        launch.run(dryrun.rank_main, ["cpu"] * 2, "gloo", bad, SEED)


def test_launch_and_group_refuse_bad_worlds():
    with pytest.raises(ValueError, match="distinct card"):
        launch.run(dryrun.rank_main, ["cpu", "cpu"], "nccl", SIZES, SEED)
    with pytest.raises(ValueError, match="backend"):
        launch.run(dryrun.rank_main, ["cpu"], "mpi", SIZES, SEED)
    with pytest.raises(RuntimeError, match="not initialised"):
        sharded.make_group()


def test_world_equals_jax(world, jax_out):
    """Field sum, fold, sumcheck (k = 2, 3), the CPmmp core and the NTT
    forward and inverse equal the JAX package's sharded functions."""
    assert set(jax_out) < set(world[2])
    assert_equals_jax(world[2], jax_out)


@pytest.fixture(scope="module")
def jax_msm(inputs):
    """The JAX msm_sharded on a 4-device mesh, G1 and G2, on the same
    points and scalars."""
    return {k: v for k, v in jax_sharded(inputs, SIZES, True).items()
            if k.startswith("msm")}


@pytest.mark.slow
def test_msm_sharded_equals_jax(world, jax_msm):
    assert_equals_jax(world[2], jax_msm)


@pytest.mark.slow
def test_dryrun_equals_jax():
    """The whole dry run at `__graft_entry__.dryrun_multichip`'s sizes on
    4 gloo ranks: every output equals the local engine and the JAX
    package's sharded functions on a 4-device mesh."""
    sizes = dryrun.DRYRUN
    inputs = dryrun.make_inputs(sizes, 1)
    out, _ = dryrun.run_world(["cpu"] * 4, "gloo", sizes, 1,
                              dryrun.reference(sizes, 1, "cpu"))
    assert_equals_jax(out, jax_sharded(inputs, sizes, with_msm=True))
