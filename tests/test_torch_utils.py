"""The port's remaining utilities against their JAX counterparts.

`utils.util` (log2ceiled, the Fr text files in both directions,
populate_from_file_dist, point files), `utils.bp_circuits`, `utils.dbg`,
the helpers of `utils.benchmark`, the polynomial helpers of
`prototools.polytools`, `fields.limb.batch_inv_scan`,
`utils.rand.rand_fr_mont_fast`, `curve.msm.msm_mont` and
`gadgets.sigma.zkeq_prove`, each on small inputs. The tolerance is
exact equality of canonical integers (points affine).
"""
import dataclasses
import io
import contextlib

import numpy as np
import pytest
import torch

import oracle

from legosnark_tpu_torch import convert
from legosnark_tpu_torch.curve import bn254
from legosnark_tpu_torch.curve import msm as msm_mod
from legosnark_tpu_torch.curve.group import G1, g1_from_ints, g2_from_ints
from legosnark_tpu_torch.fields import limb as fl
from legosnark_tpu_torch.gadgets import sigma
from legosnark_tpu_torch.prototools import polytools as pt
from legosnark_tpu_torch.utils import benchmark as bm
from legosnark_tpu_torch.utils import bp_circuits, dbg, util
from legosnark_tpu_torch.utils import rand as lrand

# The plain path runs many small torch ops; idle intra-op threads spin and
# starve the other test processes, so the port's tests use one thread.
torch.set_num_threads(1)

R = bn254.R
FR = bn254.FR
VALS = [0, 1, 5, R - 1, (1 << 200) + 7, 123456789]


@pytest.fixture(scope="module", autouse=True)
def _inference_mode():
    """No autograd bookkeeping for the plain path's many small ops."""
    with torch.inference_mode():
        yield


def mont(ints):
    return fl.tensor(FR.to_mont_ints(ints), "cpu")


def jmont(ints):
    import jax.numpy as jnp
    from legosnark_tpu.curve import bn254 as jbn
    return jnp.asarray(jbn.FR.to_mont_ints(ints))


def ints(t):
    return [int(v) for v in convert.to_ints(t).reshape(-1)]


def jints(a):
    return [int(v) for v in convert.jax_field_ints(
        np.asarray(a), FR).reshape(-1)]


def test_log2ceiled_equals_jax():
    from legosnark_tpu.utils import util as jutil
    for n in list(range(70)) + [1 << 20, (1 << 20) + 1, 3 << 30]:
        assert util.log2ceiled(n) == jutil.log2ceiled(n)


def test_fr_text_files_are_shared_with_jax(tmp_path):
    """Either package reads the other's file, and both write the same
    bytes; populate_from_file_dist cycles as the JAX package's does."""
    from legosnark_tpu.utils import util as jutil

    mine, theirs = tmp_path / "port.txt", tmp_path / "jax.txt"
    util.dump_into_file(mine, mont(VALS))
    jutil.dump_into_file(str(theirs), jmont(VALS))
    assert mine.read_text() == theirs.read_text()
    assert mine.read_text().split() == [str(len(VALS))] + [str(v)
                                                           for v in VALS]
    assert ints(util.load_from_file(theirs, "cpu")) == VALS
    assert jints(jutil.load_from_file(str(mine))) == VALS
    for n in (3, 6, 10, 13):
        got = ints(util.populate_from_file_dist(mine, n, "cpu"))
        assert got == jints(jutil.populate_from_file_dist(str(theirs), n))
        assert got == [VALS[i % len(VALS)] for i in range(n)]


def test_point_batches_round_trip(tmp_path):
    """The port's point files: its own layout under the JAX files' keys."""
    from legosnark_tpu.curve.group import g1_generator as jg1
    from legosnark_tpu.utils import util as jutil

    pts = [oracle.g1_mul(oracle.G1, k) for k in (1, 2, 77)] + [None]
    p = g1_from_ints(pts, "cpu")
    util.save_point_batch(tmp_path / "port.npz", p)
    back = util.load_point_batch(tmp_path / "port.npz", "cpu")
    assert all(torch.equal(a, b) for a, b in zip(p, back))
    assert convert.to_ints(back) == pts
    q = g2_from_ints([oracle.g2_mul(oracle.G2, 5), None], "cpu")
    util.save_point_batch(tmp_path / "g2.npz", q)
    assert convert.to_ints(util.load_point_batch(tmp_path / "g2.npz", "cpu"),
                           g2=True) == [oracle.g2_mul(oracle.G2, 5), None]
    jutil.save_point_batch(str(tmp_path / "jax.npz"), jg1((4,)))
    with np.load(tmp_path / "jax.npz") as j, \
            np.load(tmp_path / "port.npz") as m:
        assert sorted(j.files) == sorted(m.files) == ["x", "y", "z"]
        assert j["x"].shape[-2] == 20 and m["x"].shape[-2] == fl.NLIMBS


def test_bp_circuits_parse_as_jax(tmp_path):
    from legosnark_tpu.utils import bp_circuits as jbp

    text = ("header line\n=CIRC=\n4 2 8\n1 2\n0 1\n1 0\n"
            "noise\n=CIRC=\n3 1\n2\n1\n0 0 4\n")
    path = tmp_path / "circ.txt"
    path.write_text(text)
    mine = bp_circuits.read_from_file(path)
    theirs = jbp.read_from_file(str(path))
    assert [dataclasses.asdict(c) for c in mine] == \
        [dataclasses.asdict(c) for c in theirs]
    assert [c.total_nnz for c in mine] == [c.total_nnz for c in theirs] \
        == [5, 7]
    lines = text.splitlines()
    assert bp_circuits.parse_next(lines, 8) == (None, len(lines))


def _printed(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kwargs)
    return buf.getvalue()


def test_dbg_prints_canonical_ints(monkeypatch):
    """Fr values as the JAX package's host codec decodes each element,
    a single G1 point as the JAX package's `print_point` prints it, and
    nothing at all while disabled."""
    from legosnark_tpu.curve import bn254 as jbn
    from legosnark_tpu.curve.group import g1_from_oracle
    from legosnark_tpu.utils import dbg as jdbg

    vals = VALS + [9, 10, 11]
    pt1 = oracle.g1_mul(oracle.G1, 99)
    assert not dbg.ENABLED
    assert _printed(dbg.print_fr, "v", mont(vals)) == ""
    monkeypatch.setattr(dbg, "ENABLED", True)
    monkeypatch.setattr(jdbg, "ENABLED", True)
    jv = np.asarray(jmont(vals))
    decoded = [jbn.FR.from_mont_limbs(jv[:, i]) for i in range(len(vals))]
    assert _printed(dbg.print_fr, "v", mont(vals)) == \
        f"[cpdbg] v: {decoded[:8]} ...\n"
    assert _printed(dbg.print_fr, "v", mont(vals[:3])) == \
        f"[cpdbg] v: {decoded[:3]}\n"
    assert _printed(dbg.print_point, "P", g1_from_ints([pt1], "cpu")) == \
        _printed(jdbg.print_point, "P", g1_from_oracle([pt1]))
    pts = [pt1, None]
    assert _printed(dbg.print_point, "Q", g1_from_ints(pts, "cpu")) == \
        f"[cpdbg] Q: {pts}\n"
    m = [[r * 10 + c for c in range(5)] for r in range(6)]
    out = _printed(dbg.print_matrix, "M",
                   torch.stack([mont(row) for row in m]))
    assert out.splitlines() == ["[cpdbg] M: matrix shape (6, 5)"] + \
        [f"    {row[:4]}" for row in m[:4]]


def test_benchmark_helpers_match_jax():
    """The same calls on both packages' registries leave the same phases
    and copies; `time_function` returns the result and its micros."""
    from legosnark_tpu.utils import benchmark as jbm

    regs = []
    for mod in (bm, jbm):
        parent, slave = mod.Benchmarkable("parent"), mod.Benchmarkable("s")
        parent.add_benchmark_slave(slave)
        assert slave.benchmark is parent.benchmark
        slave.start_benchmark("work")
        assert slave.stop_benchmark("work", fence=[torch.zeros(2)]) > 0
        with parent.phase("outer") as out:
            out.append(torch.ones(3))
        other = mod.Benchmarkable("other")
        other.start_benchmark("x")
        other.stop_benchmark("x")
        parent.apply_benchmark_from(other, "x", "relabelled")
        assert parent.timing_micros("relabelled") == other.timing_micros("x")
        parent.benchmark.copy_timing("s", "work", "copy", "w2")
        assert parent.benchmark.get("copy", "w2") == slave.timing_micros(
            "work")
        out, micros = mod.time_function(lambda a, b=1: a + b, 2, b=3)
        assert out == 5 and micros > 0
        calls = []
        out, mean = mod.run_and_average(lambda: calls.append(1) or 7, n=4)
        assert out == 7 and len(calls) == 4 and mean > 0
        t0 = mod.now()
        assert mod.now() >= t0
        regs.append({k: sorted(v)
                     for k, v in parent.benchmark.timings.items()})
    assert regs[0] == regs[1]


def test_polytools_helpers_equal_jax():
    from legosnark_tpu.prototools import polytools as jpt

    a, b, s = [3, R - 1, 7], [5, 11], [R - 2]
    cases = [
        (pt.zero(2, "cpu"), jpt.zero(2)), (pt.one("cpu"), jpt.one()),
        (pt.x("cpu"), jpt.x()), (pt.one_minus_x("cpu"), jpt.one_minus_x()),
        (pt.add(mont(a), mont(b)), jpt.add(jmont(a), jmont(b))),
        (pt.add(mont(b), mont(a)), jpt.add(jmont(b), jmont(a))),
        (pt.mul(mont(a), mont(b)), jpt.mul(jmont(a), jmont(b))),
        (pt.mul(mont(b), mont(a)), jpt.mul(jmont(b), jmont(a))),
        (pt.scalar_mul(mont(a), mont(s)), jpt.scalar_mul(jmont(a), jmont(s))),
        (pt.sum_over_all_bin_values(mont(VALS[:4])),
         jpt.sum_over_all_bin_values(jmont(VALS[:4]))),
    ]
    for mine, theirs in cases:
        assert ints(mine) == jints(theirs)
    # X (1 - X) = X - X^2
    assert ints(pt.mul(pt.x("cpu"), pt.one_minus_x("cpu"))) == [0, 1, R - 1]


def test_batch_inv_scan_equals_jax():
    from legosnark_tpu.curve import bn254 as jbn
    from legosnark_tpu.fields import limb as jfl

    vals = [0, 3, R - 1, 0, 7, (1 << 250) % R, 5]
    want = [pow(v, -1, R) if v else 0 for v in vals]
    assert ints(fl.batch_inv_scan(FR, mont(vals))) == want
    assert jints(jfl.batch_inv_scan(jbn.FR, jmont(vals))) == want
    batch = torch.stack([mont(vals[:4]), mont(vals[3:])])     # [2, 8, 4]
    assert ints(fl.batch_inv_scan(FR, batch)) == want[:4] + want[3:]
    assert ints(fl.batch_inv_scan(FR, mont([9]))) == [pow(9, -1, R)]


def test_rand_fr_mont_fast_equals_jax():
    from legosnark_tpu.utils import rand as jrand

    mine, theirs = np.random.default_rng(4), np.random.default_rng(4)
    assert ints(lrand.rand_fr_mont_fast(mine, 5, "cpu")) == \
        jints(jrand.rand_fr_mont_fast(theirs, 5))
    assert mine.bytes(8) == theirs.bytes(8)


def test_msm_mont_equals_jax():
    from legosnark_tpu.curve import msm as jmsm
    from legosnark_tpu.curve.group import G1 as JG1, g1_from_oracle

    pts = [oracle.g1_mul(oracle.G1, k) for k in (2, 3, 5, 7)]
    ks = [R - 1, 0, 12345, (1 << 253) + 9]
    got = msm_mod.msm_mont(G1, g1_from_ints(pts, "cpu"), mont(ks))
    want = jmsm.msm_mont(JG1, g1_from_oracle(pts), jmont(ks))
    dot = sum(a * b for a, b in zip(ks, (2, 3, 5, 7)))
    assert convert.to_ints(got) == \
        convert.to_ints(convert.point_from_jax(want, "cpu")) == \
        [oracle.g1_mul(oracle.G1, dot)]


def test_zkeq_prove_equals_jax_and_verifies():
    """Two proofs in one call; the port's verifier accepts them and
    rejects a changed response."""
    from legosnark_tpu.curve.group import g1_from_oracle
    from legosnark_tpu.gadgets import sigma as jsigma

    g, h = oracle.g1_mul(oracle.G1, 17), oracle.g1_mul(oracle.G1, 29)
    v, r0, r1, k, e = [3, 8], [11, 12], [13, R - 1], [21, 22], [31, 32]
    pf = sigma.zkeq_prove(g1_from_ints([h], "cpu"), mont(r0), mont(r1),
                          mont(k), mont(e))
    jpf = jsigma.zkeq_prove(g1_from_oracle([g]), g1_from_oracle([h]),
                            jmont(r0), jmont(r1), jmont(k), jmont(e))
    assert convert.to_ints(pf.a) == \
        convert.to_ints(convert.point_from_jax(jpf.a, "cpu")) == \
        [oracle.g1_mul(h, x) for x in k]
    assert ints(pf.z) == jints(jpf.z) == \
        [(x + y * (a - b)) % R for x, y, a, b in zip(k, e, r0, r1)]
    gp, hp = g1_from_ints([g], "cpu"), g1_from_ints([h], "cpu")
    c0 = sigma.pedersen(gp, hp, mont(v), mont(r0))
    c1 = sigma.pedersen(gp, hp, mont(v), mont(r1))
    assert sigma.zkeq_verify(hp, c0, c1, pf, mont(e)).tolist() == [True, True]
    bad = sigma.ZKEqProof(pf.a, fl.add(FR, pf.z, mont([1, 0])))
    assert sigma.zkeq_verify(hp, c0, c1, bad, mont(e)).tolist() == \
        [False, True]
