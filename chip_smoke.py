#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`legosnark_tpu_torch`) on one GPU.

Phases, each printing its result and times on its own line:
  1. start-up: versions, the card and its power limit, the kernel build;
  2. kernels K1 (Montgomery product), K2 (G1 add) and K3 (G1 double)
     against their plain PyTorch versions at 2^20 elements, bit for bit,
     with edge values, the identity, P + P and P + (-P);
  3. a 2^20-point MSM with c = 17 (signed digits) checked by a trapdoor:
     points k_i*G with known k_i, expected (sum s_i k_i mod r)*G;
  4. CPmmp at n = 4 on the card against the same run on the CPU,
     element for element;
  5. the CPmmp honest-verifier prover at n = 1024 (data, C = A*B, keygen,
     commit A and B, prove), checked without a pairing by rebuilding
     keygen's secrets, with the kernels' launch counts of this phase.
Then a `kernels` JSON line, the `nvidia-smi` name and power limit line,
and as the last line {"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py [--phases 1,2,3,4,5]
Needs one CUDA card; exits non-zero without one, or when any check fails.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks: HBM 3.35 TB/s; 32-bit integer multiply-adds at 64 lanes
# per SM x 132 SMs x 1.98 GHz (half the FP32 lane count behind the
# published 67 TFLOP/s float32 rate)
HBM_BYTES_PER_S = 3.35e12
INT32_MUL_PER_S = 64 * 132 * 1.98e9
#: 32-bit multiply instructions per Montgomery product: 64 word products
#: for a*b and 64 for m*p, each needing its low and high word, and 8 for
#: m = t[0] * pinv, which needs only the low word
IMUL_PER_MONT = 2 * (64 + 64) + 8
LIMB_BYTES = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(f"check failed: {what}")


# ---------------------------------------------------------------------------
# host-side affine reference (Python ints), independent of the port
# ---------------------------------------------------------------------------

Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
G = (1, 2)


def aff_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    (x1, y1), (x2, y2) = p, q
    if x1 == x2 and (y1 + y2) % Q == 0:
        return None
    if p == q:
        lam = 3 * x1 * x1 * pow(2 * y1, -1, Q) % Q
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    return (x3, (lam * (x1 - x3) - y1) % Q)


def aff_mul(p, k):
    k %= R
    acc = None
    while k:
        if k & 1:
            acc = aff_add(acc, p)
        p = aff_add(p, p)
        k >>= 1
    return acc


def aff_neg(p):
    return None if p is None else (p[0], (-p[1]) % Q)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def timed_ms(torch, fn, dev, reps: int = 10) -> float:
    """Mean ms of fn() on `dev` after one warm-up: CUDA events on the card."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, imuls: float):
    """(least ms, 'bytes' | 'operations') for the given work."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, imuls / INT32_MUL_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def word_err(torch, a, b) -> int:
    """Largest |difference| between two int32 limb tensors as uint32 words
    (0 means bit-identical)."""
    da = a.to(torch.int64) & 0xFFFFFFFF
    db = b.to(torch.int64) & 0xFFFFFFFF
    return int((da - db).abs().max().item()) if da.numel() else 0


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_startup(torch, kernels) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"# phase 1 start-up: python {sys.version.split()[0]} torch "
        f"{torch.__version__} cuda {torch.version.cuda} card "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"# nvidia-smi: {smi}")
    t0 = time.perf_counter()
    log_ = kernels.build()
    build_s = time.perf_counter() - t0
    for name, rec in log_.items():
        regs = [ln.strip() for ln in rec["log"].splitlines()
                if "registers" in ln]
        log(f"# build {name}: {rec['seconds']:.1f}s; {'; '.join(regs)}")
    log(f"# phase 1 ok: kernels built in {build_s:.1f}s")
    return {"smi": smi, "build_s": build_s}


def _rand_below(np, rng, n, bound_int):
    """n ints uniform-ish in [0, bound_int) from 320 random bits each."""
    raw = rng.integers(0, 1 << 63, size=(n, 5), dtype=np.int64)
    return [int.from_bytes(r.tobytes(), "little") % bound_int for r in raw]


def phase_kernels(torch, np, dev, n: int) -> dict:
    from legosnark_tpu_torch.curve import bn254, cuda_group, msm
    from legosnark_tpu_torch.curve.group import (G1, Point, g1_generator,
                                                 g1_to_ints)
    from legosnark_tpu_torch.fields import cuda_limb
    from legosnark_tpu_torch.fields import limb as fl

    rng = np.random.default_rng(2024)
    stats = {}
    # K1: random values in [0, 2p) plus edge values, for Fr and Fq
    errs, ms, plain_ms = [], None, None
    for spec in (bn254.FR, bn254.FQ):
        p = spec.p
        edge = [0, 1, p - 1, p, 2 * p - 1, (1 << 224) - 1, (1 << 192) - 1]
        xs = edge + _rand_below(np, rng, n - len(edge), 2 * p)
        ys = edge[::-1] + _rand_below(np, rng, n - len(edge), 2 * p)
        a = fl.tensor(fl.ints_to_limbs(xs), dev)
        b = fl.tensor(fl.ints_to_limbs(ys), dev)
        got = cuda_limb.mont_mul(spec, a, b)
        want = cuda_limb.mont_mul_plain(spec, a, b)
        errs.append(word_err(torch, got, want))
        # spot check against Python ints
        gi = fl.limbs_to_ints(got[:, :64].cpu())
        for i in range(64):
            check(gi[i] % p == xs[i] * ys[i] * pow(spec.R, -1, p) % p,
                  f"K1 {spec.name} value {i}")
            check(gi[i] < 2 * p, f"K1 {spec.name} output < 2p")
        if spec is bn254.FR:
            ms = timed_ms(torch, lambda: cuda_limb.mont_mul(spec, a, b), dev,
                          reps=20)
            plain_ms = timed_ms(torch,
                                lambda: cuda_limb.mont_mul_plain(spec, a, b),
                                dev, reps=2)
    tb, by = bound(3 * LIMB_BYTES * n, IMUL_PER_MONT * n)
    stats["mont_mul"] = {"max_abs_err": max(errs), "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": tb, "bound_by": by}
    log(f"# phase 2 K1 mont_mul n={n}: max_abs_err {max(errs)} kernel "
        f"{ms:.4f} ms plain {plain_ms:.2f} ms bound {tb:.4f} ms ({by})")

    # K2/K3: points k_i*G; second operand mixes Q = P, -P, identity, other
    ks = fl.tensor(fl.ints_to_limbs(_rand_below(np, rng, n, R)), dev)
    table = msm.fixed_base_table(G1, g1_generator((), dev), c=8)
    P = msm.batch_scalar_mul(G1, table, ks, c=8)
    Qp = Point(*(t.roll(1, -1) for t in P))
    sel = torch.arange(n, device=dev) % 4
    ident = G1.identity((n,), dev)
    Qp = G1.select(sel == 0, P, Qp)
    Qp = G1.select(sel == 1, G1.neg(P), Qp)
    Qp = G1.select(sel == 2, ident, Qp)
    Pc = tuple(t.contiguous() for t in P)
    Qc = tuple(t.contiguous() for t in Qp)

    got = cuda_group.add_points(Pc, Qc)
    want = cuda_group.add_points_plain(Pc, Qc)
    err_add = max(word_err(torch, g, w) for g, w in zip(got, want))
    gotd = cuda_group.double_point(Pc)
    wantd = cuda_group.double_point_plain(Pc)
    err_dbl = max(word_err(torch, g, w) for g, w in zip(gotd, wantd))
    # group-law spot check against the affine reference
    m = 16
    pa = g1_to_ints(Point(*(t[:, :m] for t in Pc)))
    qa = g1_to_ints(Point(*(t[:, :m] for t in Qc)))
    sa = g1_to_ints(Point(*(t[:, :m] for t in got)))
    da = g1_to_ints(Point(*(t[:, :m] for t in gotd)))
    for i in range(m):
        check(sa[i] == aff_add(pa[i], qa[i]), f"K2 value {i}")
        check(da[i] == aff_add(pa[i], pa[i]), f"K3 value {i}")
    check(sa[1] is None, "P + (-P) is the identity")

    for name, fn, pfn, err, nin, nmul in (
            ("g1_add", lambda: cuda_group.add_points(Pc, Qc),
             lambda: cuda_group.add_points_plain(Pc, Qc), err_add, 6, 14),
            ("g1_double", lambda: cuda_group.double_point(Pc),
             lambda: cuda_group.double_point_plain(Pc), err_dbl, 3, 9)):
        ms = timed_ms(torch, fn, dev, reps=20)
        plain_ms = timed_ms(torch, pfn, dev, reps=1)
        tb, by = bound((nin + 3) * LIMB_BYTES * n, nmul * IMUL_PER_MONT * n)
        stats[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": tb, "bound_by": by}
        log(f"# phase 2 {name} n={n}: max_abs_err {err} kernel {ms:.4f} ms "
            f"plain {plain_ms:.2f} ms bound {tb:.4f} ms ({by})")
    for name, st in stats.items():
        check(st["max_abs_err"] == 0, f"{name} equals its plain version")
    log("# phase 2 ok: K1, K2, K3 bit-identical to their plain versions")
    return stats


def phase_msm(torch, np, dev, n: int, c: int) -> float:
    from legosnark_tpu_torch.curve import msm
    from legosnark_tpu_torch.curve.group import G1, g1_generator, g1_to_ints
    from legosnark_tpu_torch.fields import limb as fl
    from legosnark_tpu_torch.utils import rand as lrand

    rng = np.random.default_rng(77)
    k_np = lrand.rand_fr_limbs_fast(rng, n)
    s_np = lrand.rand_fr_limbs_fast(rng, n)
    k_int, s_int = fl.limbs_to_ints(k_np), fl.limbs_to_ints(s_np)
    e = sum(int(a) * int(b) for a, b in zip(k_int, s_int)) % R
    table = msm.fixed_base_table(G1, g1_generator((), dev), c=8)
    pts = msm.batch_scalar_mul(G1, table, fl.tensor(k_np, dev), c=8)
    scalars = fl.tensor(s_np, dev)
    _sync(torch, dev)
    t0 = time.perf_counter()
    out = msm.msm(G1, pts, scalars, c=c)
    _sync(torch, dev)
    ms = (time.perf_counter() - t0) * 1e3
    check(g1_to_ints(out)[0] == aff_mul(G, e), "MSM trapdoor check")
    log(f"# phase 3 ok: MSM n={n} c={c} signed, trapdoor check passed, "
        f"{ms:.1f} ms")
    return ms


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _proof_ints(res) -> dict:
    """Every element of a CPmmp run as canonical ints / affine points."""
    from legosnark_tpu_torch.convert import to_ints
    from legosnark_tpu_torch.curve.group import Point

    pf, sc = res["proof"], res["proof"].sc_proof
    out = {"a_comm": to_ints(res["a_comm"].c) + to_ints(res["a_comm"].ca),
           "b_comm": to_ints(res["b_comm"].c) + to_ints(res["b_comm"].ca),
           "t_comm": to_ints(pf.t_comm),
           "h_comms": to_ints(Point(*(t.movedim(0, -2).reshape(8, -1)
                                     for t in sc.h_comms))),
           "eq_a": to_ints(sc.eq_proofs.a),
           "eq_z": list(to_ints(sc.eq_proofs.z)),
           "ans_comms": to_ints(sc.ans_comms),
           "finals": list(to_ints(sc.finals))}
    for i, ppf in enumerate(sc.poly_pfs):
        out[f"poly{i}"] = to_ints(ppf.witness) + to_ints(ppf.witnessa)
    for f in sc.prd_proof._fields:
        v = getattr(sc.prd_proof, f)
        out[f"prd_{f}"] = to_ints(v) if isinstance(v, Point) \
            else list(to_ints(v))
    return out


def phase_parity(torch, dev) -> None:
    from legosnark_tpu_torch.examples import matrixsc

    t0 = time.perf_counter()
    on_card = _proof_ints(matrixsc.run(2, device=dev))
    t1 = time.perf_counter()
    on_cpu = _proof_ints(matrixsc.run(2, device="cpu"))
    t2 = time.perf_counter()
    for k in on_cpu:
        check(on_card[k] == on_cpu[k], f"n=4 proof element {k}: card == CPU")
    log(f"# phase 4 ok: CPmmp n=4 card == CPU on {len(on_cpu)} proof fields "
        f"(card {t1 - t0:.1f}s, cpu {t2 - t1:.1f}s)")


def mle_fold(vals, pt):
    """Bind the top variables of an MLE table of ints to the ints of pt,
    in order (variable i is bit d-1-i of the index, as in the port)."""
    for x in pt:
        h = len(vals) // 2
        vals = [(a + x * (b - a)) % R for a, b in zip(vals[:h], vals[h:])]
    return vals


def phase_cpmmp(torch, np, dev, d: int, kernels) -> dict:
    from legosnark_tpu_torch.convert import to_ints
    from legosnark_tpu_torch.curve.group import Point, g1_to_ints
    from legosnark_tpu_torch.examples import matrixsc
    from legosnark_tpu_torch.fields import limb as fl
    from legosnark_tpu_torch.utils import rand as lrand

    check(1 << d >= matrixsc._DEVICE_DATA_MIN_N, "n samples A, B by limbs")
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = matrixsc.run(d, device=dev)
    _sync(torch, dev)
    total_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    log(f"# phase 5 CPmmp n={res['n']}: launches {json.dumps(launches)} "
        f"times {json.dumps({k: round(v, 3) for k, v in res['times'].items()})} "
        f"total {total_s:.1f}s")
    for name in ("mont_mul", "g1_add", "g1_double"):
        check(launches.get(name, 0) > 0, f"{name} launched on the main path")

    # the reference works on host ints only: A and B from the example's
    # draws (seed 17 + d, canonical values below r), keygen's secrets drawn
    # as the keygen draws them, the MLEs by host folds
    t0 = time.perf_counter()
    n = res["n"]
    rng = np.random.default_rng(17 + d)
    A = list(fl.limbs_to_ints(lrand.rand_fr_limbs_fast(rng, n * n)))
    B = list(fl.limbs_to_ints(lrand.rand_fr_limbs_fast(rng, n * n)))
    BT = [B[r_ * n + c_] for c_ in range(n) for r_ in range(n)]
    rng = np.random.default_rng(1 ^ 0x9057)
    s_key = lrand.rand_fr_ints(rng, 2 * d)
    alpha = lrand.rand_fr_int(rng)

    def ints(v):
        return [int(x) for x in to_ints(v).reshape(-1)]

    r, s, rho = ints(res["r"]), ints(res["s"]), ints(res["chal"])
    a_k = mle_fold(A, r)                    # A~(r, k) for every column k
    b_k = mle_fold(BT, s)                   # B~(k, s) for every row k
    t = sum(x * y for x, y in zip(a_k, b_k)) % R   # C~(r, s), C = A*B
    want_finals = (mle_fold(a_k, rho)[0], mle_fold(b_k, rho)[0])
    at_key = (mle_fold(A, s_key)[0], mle_fold(B, s_key)[0])
    ref_s = time.perf_counter() - t0

    def pts(p):
        return g1_to_ints(p)

    pf, sc = res["proof"], res["proof"].sc_proof
    for i, (name, cm) in enumerate((("A", res["a_comm"]),
                                    ("B", res["b_comm"]))):
        c, ca = pts(cm.c)[0], pts(cm.ca)[0]
        check(c == aff_mul(G, at_key[i]), f"C_{name} = {name}~(s) G")
        check(ca == aff_mul(c, alpha), f"Ca_{name} = alpha C_{name}")

    t_comm = pts(pf.t_comm)[0]
    check(t_comm == aff_mul(G, t), "t_comm = C~(r||s) G with C = A*B")
    # the sumcheck chain, through the commitments' linearity:
    # Com(h_i(0)) + Com(h_i(1)) = Com(h_{i-1}(rho_{i-1})), Com(h_0(0)) +
    # Com(h_0(1)) = t_comm, and the last round closes on finals[0]*finals[1]
    k1 = sc.h_comms.x.shape[-1]
    hc = pts(Point(*(x.movedim(0, -2).reshape(8, -1) for x in sc.h_comms)))
    claim = t_comm
    for i in range(d):
        c = hc[i * k1 : (i + 1) * k1]
        at01 = c[0]
        for cj in c:
            at01 = aff_add(at01, cj)
        check(at01 == claim, f"sumcheck round {i}: h(0) + h(1) = claim")
        claim = None
        for j, cj in enumerate(c):
            claim = aff_add(claim, aff_mul(cj, pow(rho[i], j, R)))
    finals = ints(sc.finals)
    check(finals == list(want_finals), "sumcheck finals = host MLE values")
    check(claim == aff_mul(G, finals[0] * finals[1]),
          "last sumcheck round closes on finals[0] * finals[1]")

    open_pts = (r + rho, rho + s)
    ans_c = pts(sc.ans_comms)
    for i, cm in enumerate((res["a_comm"], res["b_comm"])):
        ans = want_finals[i]
        check(ans_c[i] == aff_mul(G, ans), f"answer commitment {i}")
        w = pts(sc.poly_pfs[i].witness)
        wa = pts(sc.poly_pfs[i].witnessa)
        rhs = None
        for j in range(2 * d):
            rhs = aff_add(rhs, aff_mul(w[j], s_key[j] - open_pts[i][j]))
            check(wa[j] == aff_mul(w[j], alpha), f"Wa_{j} = alpha W_{j}")
        lhs = aff_add(pts(cm.c)[0], aff_neg(aff_mul(G, ans)))
        check(lhs == rhs, f"opening {i}: C - ans G = sum (s_j - pt_j) W_j")
    log(f"# phase 5 ok: commitments, t_comm, the sumcheck chain, finals and "
        f"openings checked against host-int MLEs and keygen's rebuilt "
        f"secrets (reference {ref_s:.1f}s)")
    return {"launches": launches, "times": res["times"], "total_s": total_s}


KERNELS = {
    "mont_mul": ("legosnark_tpu_torch/csrc/mont_mul.cu",
                 "legosnark_tpu/fields/pallas_limb.py:156"),
    "g1_add": ("legosnark_tpu_torch/csrc/g1.cu",
               "legosnark_tpu/curve/pallas_group.py:366"),
    "g1_double": ("legosnark_tpu_torch/csrc/g1.cu",
                  "legosnark_tpu/curve/pallas_group.py:366"),
}


def main(argv) -> int:
    phases = {1, 2, 3, 4, 5}
    if "--phases" in argv:
        phases = {int(x) for x in argv[argv.index("--phases") + 1].split(",")}
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from legosnark_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    start = phase_startup(torch, kernels)
    stats = phase_kernels(torch, np, dev, 1 << 20) if 2 in phases else {}
    if 3 in phases:
        phase_msm(torch, np, dev, 1 << 20, 17)
    if 4 in phases:
        phase_parity(torch, dev)
    main_path = (phase_cpmmp(torch, np, dev, 10, kernels) if 5 in phases
                 else {"launches": {}})
    rows = []
    for name, (src, tpu) in KERNELS.items():
        st = stats.get(name, {})
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu,
                     "launches": main_path["launches"].get(name, 0),
                     "max_abs_err": st.get("max_abs_err"),
                     "ms": st.get("ms"), "plain_ms": st.get("plain_ms"),
                     "bound_ms": st.get("bound_ms"),
                     "bound_by": st.get("bound_by"), "library_ms": None,
                     "build": "ok"})
    log(f"# all phases {sorted(phases)} passed in "
        f"{time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(start["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
