"""The port's benchmark entry points: `legosnark_tpu_torch.bench` (the G1
MSM rate) and `legosnark_tpu_torch.bench_gadgets` (the gadget rows), with
CPpoly driven through `bench_gadgets.main` at 3 variables.

Fast tier: the MSM bench's output equals its trapdoor and its lines carry
`bench.py`'s keys; CPpoly's commitment, answer and witnesses equal
host-int scalars times G with s and alpha drawn again from keygen's seed
(`tests/oracle.py`), a proof with two witnesses swapped fails, and the SRS
cache gives the same key back; the rows carry the keys `bench_gadgets.py`
recorded (BENCH_GADGETS.json) and keep other configurations' rows;
`--scale` gives `bench_gadgets.py`'s names and evaluates nothing; without
`--cpu` and without a card both entry points raise. CPsc's cases are in
`test_torch_bench_cpsc.py` (one proof against host ints) and
`test_torch_bench_cpsc_rows.py` (its rows), so that the benchmark runs
land on different test workers. Slow tier: CPpoly's commitment, answer and proof
at 2 variables equal the JAX package's, on the port's key and on the JAX
key carried over by `convert`.
"""
import json
import pathlib
from fractions import Fraction

import numpy as np
import pytest
import torch

import oracle

from legosnark_tpu_torch import bench, convert
from legosnark_tpu_torch import bench_gadgets as bg
from legosnark_tpu_torch.curve import bn254
from legosnark_tpu_torch.curve.group import point_map
from legosnark_tpu_torch.fields import limb as fl
from legosnark_tpu_torch.gadgets import poly as cppoly
from legosnark_tpu_torch.utils import rand as lrand

# The plain path runs many small torch ops; idle intra-op threads spin and
# starve the other test processes, so the port's tests use one thread.
torch.set_num_threads(1)

R = bn254.R
ROOT = pathlib.Path(__file__).resolve().parents[1]
D = 3
SCALE = "1/6"          # round(20 / 6) = 3 variables


def ints(t):
    return [int(v) for v in convert.to_ints(t).reshape(-1)]


def mle_at(vals, pt):
    for x in pt:
        h = len(vals) // 2
        vals = [(lo + x * (hi - lo)) % R for lo, hi in zip(vals[:h], vals[h:])]
    return vals[0]


def jax_row_keys(config: str) -> dict:
    """{phase: keys of its row} as `bench_gadgets.py` recorded `config`."""
    rows = json.loads((ROOT / "BENCH_GADGETS.json").read_text())
    return {r["phase"]: set(r) for r in rows if r["config"] == config}


@pytest.fixture(scope="module", autouse=True)
def _inference_mode():
    """No autograd bookkeeping for the plain path's many small ops."""
    with torch.inference_mode():
        yield


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """`bench_gadgets.main` for CPpoly at 3 variables into a file that
    already holds a row of another configuration and a stale row of this
    one."""
    tmp = tmp_path_factory.mktemp("bench")
    out = tmp / "rows.json"
    out.write_text(json.dumps([
        {"config": "cplink_2e10", "phase": "total", "seconds": 1.0, "ok": True},
        {"config": f"cppoly_{D}var", "phase": "stale", "seconds": 0.0}]))
    res = bg.main(["cppoly", "--scale", SCALE, "--cpu", "--out", str(out),
                   "--srs-cache", str(tmp / "srs")])
    return {"res": res[f"cppoly_{D}var"], "cache": tmp / "srs",
            "rows": json.loads(out.read_text())}


def test_cppoly_rows_carry_the_jax_benchmarks_keys(run):
    mine = {r["phase"]: set(r) for r in run["rows"]
            if r["config"] == f"cppoly_{D}var"}
    assert mine == jax_row_keys("cppoly_20var")
    assert [r["phase"] for r in run["rows"]][1:] == [
        "keygen", "commit", "prove", "verify"]
    assert run["rows"][-1]["ok"] is True and run["res"]["ok"]


def test_rows_of_other_configurations_are_kept(run):
    assert run["rows"][0] == {"config": "cplink_2e10", "phase": "total",
                              "seconds": 1.0, "ok": True}
    assert all(r["phase"] != "stale" for r in run["rows"])


def test_cppoly_equals_host_ints(run):
    """C = v~(s) G, Ca = alpha C, the answer v~(r) and its commitment, and
    W_i = q_i~(s_{i+1..}) G, Wa_i = alpha W_i, with q_i the quotient
    hi - lo of v folded at r_0..r_{i-1}."""
    res = run["res"]
    rng = np.random.default_rng(3)
    v = [int(x) for x in fl.limbs_to_ints(lrand.rand_fr_limbs_fast(rng, 1 << D))]
    r = lrand.rand_fr_ints(rng, D)
    assert ints(res["v"]) == v and ints(res["r"]) == r
    rng = np.random.default_rng(1 ^ 0x9057)
    s, alpha = lrand.rand_fr_ints(rng, D), lrand.rand_fr_int(rng)
    G = oracle.G1
    assert convert.to_ints(res["comm"].c) == [oracle.g1_mul(G, mle_at(v, s))]
    assert convert.to_ints(res["comm"].ca) == \
        [oracle.g1_mul(G, alpha * mle_at(v, s))]
    ans = mle_at(v, r)
    assert ints(res["ans"]) == [ans]
    assert convert.to_ints(res["ans_comm"]) == [oracle.g1_mul(G, ans)]
    w = convert.to_ints(res["proof"].witness)
    wa = convert.to_ints(res["proof"].witnessa)
    for i in range(D):
        h = len(v) // 2
        q = [(hi - lo) % R for lo, hi in zip(v[:h], v[h:])]
        assert w[i] == oracle.g1_mul(G, mle_at(q, s[i + 1:]))
        assert wa[i] == oracle.g1_mul(w[i], alpha)
        v = [(lo + r[i] * (hi - lo)) % R for lo, hi in zip(v[:h], v[h:])]


def test_cppoly_rejects_swapped_witnesses(run):
    res = run["res"]
    pf = res["proof"]
    bad = pf._replace(witness=point_map(lambda x: x[..., [1, 0, 2]],
                                        pf.witness))
    assert not bool(cppoly.verify(res["key"], res["comm"], res["ans_comm"],
                                  res["r"], bad))


def test_srs_cache_gives_the_same_key_back(run):
    assert run["rows"][1]["srs_cache_hit"] is False
    assert cppoly.srs_path(D, 1, run["cache"]).exists()

    def coords(k):
        return [t for p in k.bases + k.bases_a + (k.g2_s, k.g2_alpha, k.g1,
                                                  k.g2) for t in p]

    got = coords(cppoly.keygen_cached(D, 1, run["cache"], "cpu"))
    want = coords(run["res"]["key"])
    assert len(got) == len(want) == 3 * (2 * (D + 1) + 4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


#: the names `bench_gadgets.py:286-298` gives each scale
SCALE_NAMES = {
    "1": {"cplink_2e10", "cppoly_20var", "cphad_2e14", "cphadl_2e14",
          "cpsc_16var", "cpmmp_1024x1024"},
    "1/2": {"cplink_2e5", "cppoly_10var", "cphad_2e7", "cphadl_2e7",
            "cpsc_8var", "cpmmp_32x32"},
    "1/4": {"cplink_2e2", "cppoly_5var", "cphad_2e4", "cphadl_2e4",
            "cpsc_4var", "cpmmp_4x4"},
    "0.25": {"cplink_2e2", "cppoly_5var", "cphad_2e4", "cphadl_2e4",
             "cpsc_4var", "cpmmp_4x4"},
}


@pytest.mark.parametrize("text", sorted(SCALE_NAMES))
def test_scale_gives_the_jax_benchmarks_names(text):
    assert bg.config_names(bg.KNOWN, bg.parse_scale(text)) == SCALE_NAMES[text]
    assert bg.parse_scale(text) == Fraction(text)


@pytest.mark.parametrize("text", ["__import__('os').getcwd()", "0", "-1/4",
                                  "1/0"])
def test_scale_is_parsed_not_evaluated(text):
    with pytest.raises((ValueError, ZeroDivisionError)):
        bg.parse_scale(text)


def test_unknown_selector_is_refused():
    with pytest.raises(SystemExit):
        bg.main(["cpfoo", "--cpu"])


def test_msm_bench_meets_its_trapdoor(capsys):
    """`bench.main` at 2^6 points and c = 6: sum s_i (k_i G) = (sum k_i s_i) G
    for the host ints it returns; its lines have `bench.py`'s keys."""
    res = bench.main(["--cpu", "6", "6", "1"])[6]
    e = sum(k * s for k, s in zip(res["k"], res["s"])) % R
    assert convert.to_ints(res["out"]) == [oracle.g1_mul(oracle.G1, e)]
    assert len(set(res["k"])) == 64 and len(set(res["s"])) == 64
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [set(ln) for ln in lines] == [
        {"metric", "value", "unit", "first_call_s", "vs_baseline"},
        {"metric", "value", "unit", "vs_baseline"}]
    assert {ln["metric"] for ln in lines} == {"g1_msm_points_per_sec_2e6"}
    assert lines[1]["value"] == lines[0]["value"] > 0


@pytest.mark.parametrize("main", [bench.main, bg.main],
                         ids=["bench", "bench_gadgets"])
def test_entry_points_raise_without_a_card(main, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--out", str(tmp_path / "rows.json")] if main is bg.main else [])
    assert not (tmp_path / "rows.json").exists()


@pytest.mark.slow
def test_cppoly_commit_and_prove_equal_jax(tmp_path):
    """CPpoly at 2 variables: the JAX package's commit, compute_answer and
    prove on the same v and r, element for element, against the bench's
    (port key) and the port's on the JAX key carried over by `convert`."""
    import jax.numpy as jnp
    from legosnark_tpu.curve import bn254 as jbn
    from legosnark_tpu.curve.group import g1_to_oracle_batch
    from legosnark_tpu.gadgets import poly as jpoly

    d = 2
    res = bg.bench_cppoly(d, "cpu", tmp_path)
    jv, jr = (jnp.asarray(jbn.FR.to_mont_ints(ints(x)))
              for x in (res["v"], res["r"]))
    jkey = jpoly.keygen(d, seed=1)
    jcm = jpoly.commit(jkey, jv)
    jans, jans_c = jpoly.compute_answer(jkey, jv, jr)
    jpf = jpoly.prove(jkey, jv, jr)

    key = convert.polykey_from_jax(jkey, "cpu")
    mine = (cppoly.commit(key, res["v"]),
            cppoly.compute_answer(key, res["v"], res["r"]),
            cppoly.prove(key, res["v"], res["r"]))
    for cm, (ans, ans_c), pf in ((res["comm"], (res["ans"], res["ans_comm"]),
                                  res["proof"]), mine):
        assert convert.to_ints(cm.c) == g1_to_oracle_batch(jcm.c)
        assert convert.to_ints(cm.ca) == g1_to_oracle_batch(jcm.ca)
        assert ints(ans) == [int(x) for x in convert.jax_field_ints(
            np.asarray(jans), bn254.FR).reshape(-1)]
        assert convert.to_ints(ans_c) == g1_to_oracle_batch(jans_c)
        assert convert.to_ints(pf.witness) == g1_to_oracle_batch(jpf.witness)
        assert convert.to_ints(pf.witnessa) == g1_to_oracle_batch(jpf.witnessa)
