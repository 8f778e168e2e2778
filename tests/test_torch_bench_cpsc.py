"""CPsc, the standalone generalised sumcheck over two committed MLEs, at
3 variables on the key and draws of `legosnark_tpu_torch.bench_gadgets`
(`bench_cpsc`'s keygen seed and `cpsc_inputs`), one proof made as
`bench_cpsc` makes it (`test_torch_bench_cpsc_rows.py` holds the rows
of `bench_gadgets.main`, `test_torch_bench.py` the rest of the bench
entry points).

Fast tier: the proof verifies; z0 = sum a_i b_i, its commitment, every
round's h commitments (the round polynomial's coefficients times G) and
the finals a~(r), b~(r) equal host ints from the bench's seed
(`tests/oracle.py`); two round commitments swapped, a final changed and
the commitment of z0 + 1 each fail. Slow tier: the honest-verifier proof
at 2 variables equals the JAX package's `sumcheck.prove` element for
element, on the port's key and on the JAX key carried over by `convert`.
"""
import numpy as np
import pytest
import torch

import oracle

from legosnark_tpu_torch import bench_gadgets as bg
from legosnark_tpu_torch import convert
from legosnark_tpu_torch.curve import bn254
from legosnark_tpu_torch.curve.group import Point, point_map
from legosnark_tpu_torch.fields import limb as fl
from legosnark_tpu_torch.gadgets import poly as cppoly
from legosnark_tpu_torch.gadgets import sumcheck as cpsc
from legosnark_tpu_torch.utils import rand as lrand

# The plain path runs many small torch ops; idle intra-op threads spin and
# starve the other test processes, so the port's tests use one thread.
torch.set_num_threads(1)

R = bn254.R
D = 3


def ints(t):
    return [int(v) for v in convert.to_ints(t).reshape(-1)]


def fold(vals, x):
    h = len(vals) // 2
    return [(lo + x * (hi - lo)) % R for lo, hi in zip(vals[:h], vals[h:])]


@pytest.fixture(scope="module", autouse=True)
def _inference_mode():
    """No autograd bookkeeping for the plain path's many small ops."""
    with torch.inference_mode():
        yield


@pytest.fixture(scope="module")
def run():
    """One proof on `bench_cpsc`'s key and draws, as `bench_cpsc` makes it
    (without its cold and warm pair of calls)."""
    key = cppoly.keygen(D, D, "cpu")
    inp = bg.cpsc_inputs(D, "cpu")
    a, b = inp["a"], inp["b"]
    pf, z0, z0_comm, _ = cpsc.prove(key, torch.stack([a, b]), inp["rand"],
                                    bg.same_point, (a, b),
                                    challenges=inp["chal"])
    return {**inp, "key": key, "proof": pf, "z0": z0, "z0_comm": z0_comm,
            "comms": (cppoly.commit(key, a), cppoly.commit(key, b))}


def test_cpsc_verifies(run):
    assert bool(cpsc.verify(run["key"], run["z0_comm"], run["comms"],
                            run["proof"], bg.same_point, rand=run["hv"]))


def test_cpsc_equals_host_ints(run):
    rng = np.random.default_rng(7 + D)
    a, b = ([int(x) for x in fl.limbs_to_ints(
        lrand.rand_fr_limbs_fast(rng, 1 << D))] for _ in range(2))
    rand = {k: lrand.rand_fr_ints(rng, m)
            for k, m in (("eq_k", D), ("prd_b", 5), ("eq_e", D), ("prd_e", 1))}
    chal = lrand.rand_fr_ints(rng, D)
    assert ints(run["a"]) == a and ints(run["b"]) == b
    assert {k: ints(v) for k, v in run["rand"].items()} == rand
    assert ints(run["chal"]) == chal

    G = oracle.G1
    z0 = sum(x * y for x, y in zip(a, b)) % R
    assert ints(run["z0"]) == [z0]
    assert convert.to_ints(run["z0_comm"]) == [oracle.g1_mul(G, z0)]
    pf = run["proof"]
    for i in range(D):
        h = len(a) // 2
        da = [y - x for x, y in zip(a[:h], a[h:])]
        db = [y - x for x, y in zip(b[:h], b[h:])]
        coeffs = (sum(x * y for x, y in zip(a[:h], b[:h])),
                  sum(x * y + u * w for x, y, u, w in zip(a[:h], db, da, b[:h])),
                  sum(x * y for x, y in zip(da, db)))
        assert convert.to_ints(Point(*(t[i] for t in pf.h_comms))) == \
            [oracle.g1_mul(G, c % R) for c in coeffs], f"round {i}"
        a, b = fold(a, chal[i]), fold(b, chal[i])
    assert ints(pf.finals) == a + b


def _tampered(res, what):
    pf, one = res["proof"], fl.one(bn254.FR, (), "cpu")
    if what == "round commitments swapped":
        return res["z0_comm"], pf._replace(h_comms=point_map(
            lambda x: x[[1, 0, 2]], pf.h_comms))
    if what == "final changed":
        finals = pf.finals.clone()
        finals[..., :1] = fl.add(bn254.FR, finals[..., :1], one)
        return res["z0_comm"], pf._replace(finals=finals)
    return cpsc.commit_scalar(res["key"].g1,
                              fl.add(bn254.FR, res["z0"], one)), pf


@pytest.mark.parametrize("what", ["round commitments swapped",
                                  "final changed", "z0_comm of z0 + 1"])
def test_cpsc_rejects_tampers(run, what):
    z0_comm, pf = _tampered(run, what)
    assert not bool(cpsc.verify(run["key"], z0_comm, run["comms"], pf,
                                bg.same_point, rand=run["hv"]))


@pytest.mark.slow
def test_cpsc_hv_proof_equals_jax(tmp_path):
    """The bench's draws at 2 variables through the JAX package's
    `sumcheck.prove` (not staged) and the port's, element for element."""
    import jax.numpy as jnp
    from legosnark_tpu.curve import bn254 as jbn
    from legosnark_tpu.gadgets import poly as jpoly
    from legosnark_tpu.gadgets import sumcheck as jsc

    def jm(x):
        return jnp.asarray(jbn.FR.to_mont_ints(ints(x)))

    d = 2
    res = bg.bench_cpsc(d, "cpu", tmp_path)
    jkey = jpoly.keygen(d, seed=d)
    jpf, jz0 = jsc.prove(jkey, jnp.stack([jm(res["a"]), jm(res["b"])]),
                         {k: jm(v) for k, v in res["rand"].items()},
                         challenges=jm(res["chal"]))
    want = proof_ints(convert.scproof_from_jax(jpf, "cpu"))
    assert ints(res["z0"]) == [int(x) for x in convert.jax_field_ints(
        np.asarray(jz0), bn254.FR).reshape(-1)]

    key = convert.polykey_from_jax(jkey, "cpu")
    mine, z0, _, _ = cpsc.prove(key, torch.stack([res["a"], res["b"]]),
                                res["rand"], bg.same_point,
                                (res["a"], res["b"]),
                                challenges=res["chal"])
    assert ints(z0) == ints(res["z0"])
    for pf in (res["proof"], mine):
        got = proof_ints(pf)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == want[k], k


def proof_ints(pf) -> dict:
    """Every element of a sumcheck proof as ints or affine points."""
    out = {"r": ints(pf.r), "finals": ints(pf.finals),
           "h_comms": convert.to_ints(Point(*(t.movedim(0, -2).reshape(8, -1)
                                              for t in pf.h_comms))),
           "eq_a": convert.to_ints(pf.eq_proofs.a),
           "eq_z": ints(pf.eq_proofs.z),
           "ans_comms": convert.to_ints(pf.ans_comms)}
    for i, p in enumerate(pf.poly_pfs):
        out[f"poly{i}"] = (convert.to_ints(p.witness)
                           + convert.to_ints(p.witnessa))
    for f, v in zip(pf.prd_proof._fields, pf.prd_proof):
        out[f"prd_{f}"] = convert.to_ints(v) if isinstance(v, Point) \
            else ints(v)
    return out
