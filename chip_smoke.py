#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`legosnark_tpu_torch`) on one GPU.

Phases, each printing its result and times on its own line:
  1. start-up: versions, the card and its power limit, the kernel build;
  2. kernels K1 (Montgomery product), K2 (G1 add) and K3 (G1 double,
     also with times = 4 and 17 doublings in one launch) against their
     plain PyTorch versions at 2^20 elements, bit for bit, with edge
     values, the identity, P + P and P + (-P); then K2, K3 and K3 with
     times = 17 at widths 1, 2, 32 and 2^10, bit for bit, with device us
     per launch and host us per wrapper call;
  3. a 2^20-point MSM with c = 17 (signed digits) checked by a trapdoor:
     points k_i*G with known k_i, expected (sum s_i k_i mod r)*G;
  4. CPmmp at n = 4 on the card against the same run on the CPU, element
     for element: the honest-verifier proof, the Fiat-Shamir in-clear
     proof and the Fiat-Shamir committed proof (the transcript is
     deterministic), each verified true on both devices;
  5. the main path: CPmmp honest-verifier at n = 1024 (data, C = A*B,
     keygen, commit A and B, prove, verify), checked without a pairing by
     rebuilding keygen's secrets; four tampered proofs (a round commitment
     swapped, a final changed, an opening witness changed, an entry of C
     changed) verify false; the kernels' launch counts of the run and
     their widths, and the launches and seconds of one more verify alone;
  6. the probes P1a (SOS product), P1b (tensor-core reduction) and P2
     (limb product, three variants) against their plain versions and K1
     at 2^20, bit for bit, with their times beside K1's; the pairing on
     the card: bilinearity e(aG1, bG2) = e(G1, G2)^(ab) at width 64 and
     e(G1, G2) equal to the CPU's;
  7. the Fiat-Shamir path at n = 1024 with phase 5's key and data: prove
     and verify true, a tampered proof false, with its launch counts and
     their widths.
Then a `kernels` JSON line (with `ms_by_width` for K2 and K3), the
`nvidia-smi` name and power limit line, and as the last line
{"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py [--phases 1,2,3,4,5,6,7]   (phase 7 needs 5)
Needs one CUDA card; exits non-zero without one, or when any check fails.
"""
from __future__ import annotations

import json
import os
import re
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
#: the SOS product (P1a): a*b and m*p as in CIOS, and m = t_lo * ninv mod R
#: over the whole 256-bit ninv, 36 word products of which 28 need their
#: high word
IMUL_PER_SOS = 2 * (64 + 64) + 36 + 28
#: P1b on the CUDA cores: t = a*b only
IMUL_PER_TC = 2 * 64
#: P1b on the tensor cores: 6 mma.sync m16n8k32 tiles per 8 elements, 2
#: operations per multiply-add, at the data sheet's dense int8 rate
TC_OPS_PER_ELEM = 6 * 16 * 8 * 32 * 2 // 8
INT8_TC_OPS_PER_S = 1979e12
LIMB_BYTES = 32
#: K3's `times` checked and timed at 2^20 (4: scalar multiplication's
#: windows, 17: the Horner step of a c = 17 MSM)
DOUBLE_TIMES = (4, 17)
#: the main path's narrow launch widths (Horner tails, tables, verifier)
NARROW_WIDTHS = (1, 2, 32, 1 << 10)
#: the main path's kernels, whose launches phases 5 and 7 count
MAIN_KERNELS = ("mont_mul", "g1_add", "g1_double")


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
# bounds
# ---------------------------------------------------------------------------


def bound(nbytes: float, imuls: float, tc_ops: float = 0.0):
    """(least ms, 'bytes' | 'operations') for the given work: the larger of
    the bytes over the HBM rate and each kind of operation over its peak
    (32-bit multiplies on the CUDA cores, u8 tensor-core operations)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = max(imuls / INT32_MUL_PER_S, tc_ops / INT8_TC_OPS_PER_S) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


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
                if "registers" in ln or "spill" in ln]
        log(f"# build {name}: {rec['seconds']:.1f}s; {'; '.join(regs)}")
    if log_["g1.cu"]["seconds"]:   # a fresh build: ptxas's report is there
        check(not re.search(r"[1-9][0-9]* bytes spill", log_["g1.cu"]["log"]),
              "K2 and K3 build without spills")
    log(f"# phase 1 ok: kernels built in {build_s:.1f}s")
    return {"smi": smi, "build_s": build_s}


def phase_kernels(torch, np, dev, n: int) -> dict:
    from legosnark_tpu_torch.curve import bn254, cuda_group, msm
    from legosnark_tpu_torch.curve.group import (G1, Point, g1_generator,
                                                 g1_to_ints)
    from legosnark_tpu_torch.fields import cuda_limb
    from legosnark_tpu_torch.fields import limb as fl
    from legosnark_tpu_torch.utils.bench import (edge_ints, rand_below,
                                                 timed_ms, word_err)

    rng = np.random.default_rng(2024)
    stats = {}
    # K1: random values in [0, 2p) plus edge values, for Fr and Fq
    errs, ms, plain_ms = [], None, None
    for spec in (bn254.FR, bn254.FQ):
        p = spec.p
        edge = edge_ints(p)
        xs = edge + rand_below(rng, n - len(edge), 2 * p)
        ys = edge[::-1] + rand_below(rng, n - len(edge), 2 * p)
        a = fl.tensor(fl.ints_to_limbs(xs), dev)
        b = fl.tensor(fl.ints_to_limbs(ys), dev)
        got = cuda_limb.mont_mul(spec, a, b)
        want = cuda_limb.mont_mul_plain(spec, a, b)
        errs.append(word_err(got, want))
        # spot check against Python ints
        gi = fl.limbs_to_ints(got[:, :64].cpu())
        for i in range(64):
            check(gi[i] % p == xs[i] * ys[i] * pow(spec.R, -1, p) % p,
                  f"K1 {spec.name} value {i}")
            check(gi[i] < 2 * p, f"K1 {spec.name} output < 2p")
        if spec is bn254.FR:
            ms = timed_ms(lambda: cuda_limb.mont_mul(spec, a, b), dev, 20)
            plain_ms = timed_ms(lambda: cuda_limb.mont_mul_plain(spec, a, b),
                                dev, 2)
    tb, by = bound(3 * LIMB_BYTES * n, IMUL_PER_MONT * n)
    stats["mont_mul"] = {"max_abs_err": max(errs), "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": tb, "bound_by": by}
    log(f"# phase 2 K1 mont_mul n={n}: max_abs_err {max(errs)} kernel "
        f"{ms:.4f} ms plain {plain_ms:.2f} ms bound {tb:.4f} ms ({by})")

    # K2/K3: points k_i*G; second operand mixes Q = P, -P, identity, other
    ks = fl.tensor(fl.ints_to_limbs(rand_below(rng, n, R)), dev)
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
    err_add = max(word_err(g, w) for g, w in zip(got, want))
    gotd = cuda_group.double_point(Pc)
    wantd = cuda_group.double_point_plain(Pc)
    err_dbl = max(word_err(g, w) for g, w in zip(gotd, wantd))
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
        ms = timed_ms(fn, dev, 20)
        plain_ms = timed_ms(pfn, dev, 1)
        tb, by = bound((nin + 3) * LIMB_BYTES * n, nmul * IMUL_PER_MONT * n)
        stats[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": tb, "bound_by": by}
        log(f"# phase 2 {name} n={n}: max_abs_err {err} kernel {ms:.4f} ms "
            f"plain {plain_ms:.2f} ms bound {tb:.4f} ms ({by})")
    # K3 with `times` doublings in one launch, at 2^20
    for k in DOUBLE_TIMES:
        err = max(word_err(g, w) for g, w in zip(
            cuda_group.double_point(Pc, k),
            cuda_group.double_point_plain(Pc, k)))
        ms = timed_ms(lambda: cuda_group.double_point(Pc, k), dev, 5)
        tb, by = bound(6 * LIMB_BYTES * n, k * 9 * IMUL_PER_MONT * n)
        stats["g1_double"][f"times{k}"] = {"max_abs_err": err, "ms": ms,
                                           "bound_ms": tb, "bound_by": by}
        stats["g1_double"]["max_abs_err"] = max(
            stats["g1_double"]["max_abs_err"], err)
        log(f"# phase 2 g1_double times={k} n={n}: max_abs_err {err} kernel "
            f"{ms:.4f} ms bound {tb:.4f} ms ({by})")
    _narrow_widths(dev, Pc, Qc, stats)
    for name, st in stats.items():
        check(st["max_abs_err"] == 0, f"{name} equals its plain version")
    log("# phase 2 ok: K1, K2, K3 bit-identical to their plain versions")
    return stats


def _narrow_widths(dev, Pc, Qc, stats) -> None:
    """K2, K3 and K3 with times = 17 at the main path's narrow widths:
    each held bit for bit against its plain version (K3 also with times =
    4), then device us per launch (CUDA events over 200 back-to-back
    launches) and host us per wrapper call."""
    from legosnark_tpu_torch.curve import cuda_group
    from legosnark_tpu_torch.utils.bench import launch_us, word_err

    dbl = cuda_group.double_point
    dbl_plain = cuda_group.double_point_plain
    # (name, kernel, plain version, row of `stats`, key suffix of its
    # width table, None where the variant is only checked)
    variants = (
        ("g1_add", cuda_group.add_points, cuda_group.add_points_plain,
         "g1_add", ""),
        ("g1_double", lambda p, q: dbl(p), lambda p, q: dbl_plain(p),
         "g1_double", ""),
        ("g1_double times=4", lambda p, q: dbl(p, 4),
         lambda p, q: dbl_plain(p, 4), "g1_double", None),
        ("g1_double times=17", lambda p, q: dbl(p, 17),
         lambda p, q: dbl_plain(p, 17), "g1_double", "_times17"),
    )
    for w in NARROW_WIDTHS:
        p = tuple(t[:, :w].contiguous() for t in Pc)
        q = tuple(t[:, :w].contiguous() for t in Qc)
        for name, fn, pfn, row, key in variants:
            err = max(word_err(g, v) for g, v in zip(fn(p, q), pfn(p, q)))
            st = stats[row]
            st["max_abs_err"] = max(st["max_abs_err"], err)
            if key is None:
                continue
            dev_us, host_us = launch_us(lambda: fn(p, q), dev)
            st.setdefault("ms_by_width" + key, {})[w] = dev_us / 1e3
            st.setdefault("host_ms_by_width" + key, {})[w] = host_us / 1e3
            log(f"# phase 2 {name} width {w}: max_abs_err {err} device "
                f"{dev_us:.2f} us/launch host {host_us:.2f} us/call")


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


def _proof_ints(pf) -> dict:
    """Every element of a CPmmp proof as canonical ints / affine points."""
    from legosnark_tpu_torch.convert import to_ints
    from legosnark_tpu_torch.curve.group import Point

    sc = pf.sc_proof
    out = {"r": list(to_ints(pf.r)), "s": list(to_ints(pf.s)),
           "t_comm": to_ints(pf.t_comm), "c_ans_comm": to_ints(pf.c_ans_comm),
           "h_comms": to_ints(Point(*(t.movedim(0, -2).reshape(8, -1)
                                     for t in sc.h_comms))),
           "sc_r": list(to_ints(sc.r)),
           "eq_a": to_ints(sc.eq_proofs.a),
           "eq_z": list(to_ints(sc.eq_proofs.z)),
           "ans_comms": to_ints(sc.ans_comms),
           "finals": list(to_ints(sc.finals))}
    pfs = list(sc.poly_pfs) + ([pf.c_poly_pf] if pf.c_poly_pf else [])
    for i, ppf in enumerate(pfs):
        out[f"poly{i}"] = to_ints(ppf.witness) + to_ints(ppf.witnessa)
    for f in sc.prd_proof._fields:
        v = getattr(sc.prd_proof, f)
        out[f"prd_{f}"] = to_ints(v) if isinstance(v, Point) \
            else list(to_ints(v))
    return out


def _n4_runs(dev) -> dict:
    """The n = 4 honest-verifier, Fiat-Shamir in-clear and Fiat-Shamir
    committed proofs on `dev` (one key and one set of commitments), with
    their verdicts."""
    from legosnark_tpu_torch.examples import matrixsc
    from legosnark_tpu_torch.gadgets import matrix as cpmat

    hv = matrixsc.run(2, device=dev, fs=False)
    key, A, B, C = hv["key"], hv["A"], hv["B"], hv["C"]
    a_cm, b_cm, nonces = hv["a_comm"], hv["b_comm"], hv["nonces"]
    fpf = cpmat.prove_output_in_clear_fs(key, A, B, C, a_cm, b_cm, nonces)
    f_ok = bool(cpmat.verify_output_in_clear_fs(key, a_cm, b_cm, C, fpf))
    c_cm = cpmat.commit_matrix(key, C)
    cpf = cpmat.prove_fs(key, A, B, C, a_cm, b_cm, c_cm, nonces)
    c_ok = bool(cpmat.verify_fs(key, a_cm, b_cm, c_cm, cpf))
    return {"hv": (_proof_ints(hv["proof"]), hv["ok"]),
            "fs": (_proof_ints(fpf), f_ok),
            "fs_committed": (_proof_ints(cpf), c_ok)}


def phase_parity(torch, dev) -> None:
    t0 = time.perf_counter()
    on_card = _n4_runs(dev)
    t1 = time.perf_counter()
    on_cpu = _n4_runs("cpu")
    t2 = time.perf_counter()
    for mode, (want, ok_cpu) in on_cpu.items():
        got, ok_card = on_card[mode]
        check(ok_cpu and ok_card, f"n=4 {mode}: verify true on card and CPU")
        for k in want:
            check(got[k] == want[k], f"n=4 {mode} proof element {k}: "
                  f"card == CPU")
    log(f"# phase 4 ok: CPmmp n=4 honest-verifier, Fiat-Shamir in-clear and "
        f"Fiat-Shamir committed proofs card == CPU on every field, verify "
        f"true on both (card {t1 - t0:.1f}s, cpu {t2 - t1:.1f}s)")


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
    res = matrixsc.run(d, device=dev, fs=False)
    _sync(torch, dev)
    total_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    widths = _widths(kernels)
    check(res["ok"], "CPmmp n=1024 honest-verifier proof verifies")
    log(f"# phase 5 CPmmp n={res['n']}: launches {json.dumps(launches)} "
        f"times {json.dumps({k: round(v, 3) for k, v in res['times'].items()})} "
        f"total {total_s:.1f}s")
    log(f"# phase 5 launch widths: {json.dumps(widths)}")
    for name in MAIN_KERNELS:
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
    log(f"# phase 5: commitments, t_comm, the sumcheck chain, finals and "
        f"openings checked against host-int MLEs and keygen's rebuilt "
        f"secrets (reference {ref_s:.1f}s)")

    verify_s, verify_launches = _verify_alone(torch, dev, kernels, res)
    log(f"# phase 5 verify alone: {verify_s:.3f}s, launches "
        f"{json.dumps(verify_launches)}, widths "
        f"{json.dumps(_widths(kernels))}")
    _tampers(torch, dev, res)
    log(f"# phase 5 ok: CPmmp n={n} honest-verifier verify true, four "
        f"tampered proofs false")
    return {"launches": launches, "times": res["times"], "total_s": total_s,
            "verify_s": verify_s, "verify_launches": verify_launches,
            "res": res}


def _widths(kernels) -> dict:
    """Launches of K1-K3 since the last reset, by power-of-two width."""
    return {k: dict(sorted(kernels.launch_widths.get(k, {}).items()))
            for k in MAIN_KERNELS}


def _verify_hv(res, proof=None, C=None):
    from legosnark_tpu_torch.gadgets import matrix as cpmat
    return bool(cpmat.verify_output_in_clear(
        res["key"], res["a_comm"], res["b_comm"],
        res["C"] if C is None else C, res["proof"] if proof is None else proof,
        hv_rand=res["hv"]))


def _verify_alone(torch, dev, kernels, res):
    """Seconds and kernel launches of one honest-verifier verify."""
    _sync(torch, dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    ok = _verify_hv(res)
    verify_s = time.perf_counter() - t0
    check(ok, "verify alone is true")
    return verify_s, dict(kernels.launches)


def _tampers(torch, dev, res) -> None:
    """Four tampered copies of the n = 1024 proof, each verified false."""
    from legosnark_tpu_torch.curve import bn254
    from legosnark_tpu_torch.curve.group import Point
    from legosnark_tpu_torch.fields import limb as fl

    pf = res["proof"]
    sc = pf.sc_proof

    def swap01(x):
        y = x.clone()
        y[0, ..., 0], y[0, ..., 1] = x[0, ..., 1], x[0, ..., 0]
        return y

    one = fl.one(bn254.FR, (), dev)
    finals = sc.finals.clone()
    finals[..., :1] = fl.add(bn254.FR, finals[..., :1], one)
    w = sc.poly_pfs[0]
    w_bad = w._replace(witness=Point(*(t.roll(1, -1) for t in w.witness)))
    C = res["C"].clone()
    C[0, :, :1] = fl.add(bn254.FR, C[0, :, :1], one)
    cases = {
        "round commitment swapped":
            (pf._replace(sc_proof=sc._replace(
                h_comms=Point(*(swap01(t) for t in sc.h_comms)))), None),
        "final changed":
            (pf._replace(sc_proof=sc._replace(finals=finals)), None),
        "opening witness changed":
            (pf._replace(sc_proof=sc._replace(
                poly_pfs=(w_bad,) + tuple(sc.poly_pfs[1:]))), None),
        "entry of C changed": (pf, C),
    }
    for what, (proof, Cm) in cases.items():
        t0 = time.perf_counter()
        ok = _verify_hv(res, proof, Cm)
        log(f"# phase 5 tamper '{what}': verify {ok} "
            f"({time.perf_counter() - t0:.2f}s)")
        check(not ok, f"tampered proof ({what}) verifies false")


def phase_probes(torch, np, dev) -> dict:
    """P1a, P1b and P2 at 2^20 against their plain versions and K1."""
    from legosnark_tpu_torch.probes import mont_variants

    n = 1 << 20
    t0 = time.perf_counter()
    res = mont_variants.measure(20, dev)
    k1_ms = res.pop("k1")["ms"]
    work = {   # bytes, 32-bit multiplies, tensor-core operations per element
        "mont_mul_sos": (3 * LIMB_BYTES, IMUL_PER_SOS, 0),
        "mont_mul_tc": (3 * LIMB_BYTES, IMUL_PER_TC, TC_OPS_PER_ELEM),
        "limb_product_floor": (4 * LIMB_BYTES, 16, 0),
        "limb_product_operand": (4 * LIMB_BYTES, 128, 0),
        "limb_product_product": (4 * LIMB_BYTES, 128, 0),
    }
    stats = {}
    for name, (nb, imul, tc) in work.items():
        st = res[name]
        tb, by = bound(nb * n, imul * n, tc * n)
        stats[name] = {"max_abs_err": st["max_abs_err"], "ms": st["ms"],
                       "plain_ms": st["plain_ms"], "bound_ms": tb,
                       "bound_by": by}
        k1 = f" k1_err {st['k1_err']}" if "k1_err" in st else ""
        log(f"# phase 6 {name} n={n}: max_abs_err {st['max_abs_err']}{k1} "
            f"kernel {st['ms']:.4f} ms plain {st['plain_ms']:.2f} ms bound "
            f"{tb:.4f} ms ({by}); K1 {k1_ms:.4f} ms")
        check(st["max_abs_err"] == 0, f"{name} equals its plain version")
        check(st.get("k1_err", 0) == 0, f"{name} equals K1")
    log(f"# phase 6 probes: P1b/K1 time ratio {res['mont_mul_tc']['ms'] / k1_ms:.3f}, "
        f"P1a/K1 {res['mont_mul_sos']['ms'] / k1_ms:.3f} "
        f"({time.perf_counter() - t0:.1f}s)")
    phase_pairing(torch, np, dev)
    log("# phase 6 ok: P1a, P1b and P2 bit-identical to their plain "
        "versions (P1a, P1b to K1); pairing bilinear and card == CPU")
    return stats


def phase_pairing(torch, np, dev) -> None:
    """Bilinearity e(aG1, bG2) = e(G1, G2)^(ab) at width 64 on the card,
    and e(G1, G2) on the card equal to the CPU's."""
    from legosnark_tpu_torch.convert import to_ints
    from legosnark_tpu_torch.curve import bn254, pairing as pr
    from legosnark_tpu_torch.curve.group import (G1, G2, g1_generator,
                                                 g2_generator)
    from legosnark_tpu_torch.fields import limb as fl

    m = 64
    rng = np.random.default_rng(64)
    a = [int(x) for x in rng.integers(1, 1 << 16, size=m)]
    b = [int(x) for x in rng.integers(1, 1 << 16, size=m)]
    t0 = time.perf_counter()
    P = G1.scalar_mul(g1_generator((), dev), fl.tensor(fl.ints_to_limbs(a), dev))
    Q = G2.scalar_mul(g2_generator((), dev), fl.tensor(fl.ints_to_limbs(b), dev))
    px, py, _ = pr.g1_affine(P)
    qx, qy, _ = pr.g2_affine(Q)
    e_ab = pr.pairing(px, py, qx, qy)                       # [.., 64]

    def base(device):
        gx, gy, _ = pr.g1_affine(g1_generator((), device))
        hx, hy, _ = pr.g2_affine(g2_generator((), device))
        return pr.pairing(gx, gy, hx, hy)                   # [.., 1]

    e1 = base(dev)
    # e(G1, G2)^(a_i b_i), square-and-multiply with per-lane exponent bits
    ab = [x * y for x, y in zip(a, b)]
    acc = pr.F12.one((m,), dev)
    for bit in range(max(ab).bit_length() - 1, -1, -1):
        acc = pr.F12.sqr(acc)
        take = torch.tensor([(v >> bit) & 1 for v in ab], dtype=torch.bool,
                            device=dev)
        acc = pr.F12.select(take, pr.F12.mul(acc, e1), acc)
    bil = bool(pr.F12.eq(e_ab, acc).all())
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    e1_cpu = base("cpu")
    cpu_s = time.perf_counter() - t0
    same = (list(to_ints(e1.reshape(12, 8, 1), bn254.FQ).reshape(-1))
            == list(to_ints(e1_cpu.reshape(12, 8, 1), bn254.FQ).reshape(-1)))
    log(f"# phase 6 pairing: bilinear at width {m} {bil}, e(G1, G2) card == "
        f"CPU {same} (card {card_s:.1f}s, cpu {cpu_s:.1f}s)")
    check(bil, "e(aG1, bG2) = e(G1, G2)^(ab) on the card")
    check(same, "e(G1, G2) on the card equals the CPU's")
    check(not bool(pr.F12.is_one(e1).all()), "e(G1, G2) != 1")


def phase_fs(torch, dev, kernels, res) -> dict:
    """The Fiat-Shamir path at n = 1024 with phase 5's key and data."""
    from legosnark_tpu_torch.curve.group import Point
    from legosnark_tpu_torch.gadgets import matrix as cpmat

    key, A, B, C = res["key"], res["A"], res["B"], res["C"]
    a_cm, b_cm = res["a_comm"], res["b_comm"]
    _sync(torch, dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    pf = cpmat.prove_output_in_clear_fs(key, A, B, C, a_cm, b_cm,
                                        res["nonces"])
    _sync(torch, dev)
    prove_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok = bool(cpmat.verify_output_in_clear_fs(key, a_cm, b_cm, C, pf))
    verify_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    log(f"# phase 7 FS CPmmp n={key.n}: prove {prove_s:.3f}s verify "
        f"{verify_s:.3f}s verdict {ok}; launches {json.dumps(launches)}")
    log(f"# phase 7 launch widths: {json.dumps(_widths(kernels))}")
    check(ok, "Fiat-Shamir proof at n=1024 verifies")
    for name in MAIN_KERNELS:
        check(launches.get(name, 0) > 0, f"{name} launched on the FS path")
    sc = pf.sc_proof
    bad = pf._replace(sc_proof=sc._replace(h_comms=Point(
        *(t.roll(1, 0) for t in sc.h_comms))))
    t0 = time.perf_counter()
    ok_bad = bool(cpmat.verify_output_in_clear_fs(key, a_cm, b_cm, C, bad))
    log(f"# phase 7 tamper 'round commitments rotated': verify {ok_bad} "
        f"({time.perf_counter() - t0:.2f}s)")
    check(not ok_bad, "tampered Fiat-Shamir proof verifies false")
    log("# phase 7 ok: Fiat-Shamir prove + verify at n=1024 true, tamper "
        "false")
    return {"launches": launches, "prove_s": prove_s, "verify_s": verify_s}


#: name -> (source, the TPU kernel it replaces, on the main path?)
KERNELS = {
    "mont_mul": ("legosnark_tpu_torch/csrc/mont_mul.cu",
                 "legosnark_tpu/fields/pallas_limb.py:156", True),
    "g1_add": ("legosnark_tpu_torch/csrc/g1.cu",
               "legosnark_tpu/curve/pallas_group.py:366", True),
    "g1_double": ("legosnark_tpu_torch/csrc/g1.cu",
                  "legosnark_tpu/curve/pallas_group.py:366", True),
    "mont_mul_sos": ("legosnark_tpu_torch/csrc/mont_sos.cu",
                     "scripts/probe_mxu.py:136", False),
    "mont_mul_tc": ("legosnark_tpu_torch/csrc/mont_tc.cu",
                    "scripts/probe_mxu.py:143", False),
    "limb_product_floor": ("legosnark_tpu_torch/csrc/limb_product.cu",
                           "scripts/probe_conv.py:33", False),
    "limb_product_operand": ("legosnark_tpu_torch/csrc/limb_product.cu",
                             "scripts/probe_conv.py:33", False),
    "limb_product_product": ("legosnark_tpu_torch/csrc/limb_product.cu",
                             "scripts/probe_conv.py:33", False),
}


def main(argv) -> int:
    phases = {1, 2, 3, 4, 5, 6, 7}
    if "--phases" in argv:
        phases = {int(x) for x in argv[argv.index("--phases") + 1].split(",")}
    if 7 in phases and 5 not in phases:
        print("chip_smoke: phase 7 reuses phase 5's key", file=sys.stderr)
        return 2
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
    hv = phase_cpmmp(torch, np, dev, 10, kernels) if 5 in phases else None
    if 6 in phases:
        stats.update(phase_probes(torch, np, dev))
    fs = phase_fs(torch, dev, kernels, hv["res"]) if 7 in phases else None
    paths = {"cpmmp_hv_1024": hv["launches"] if hv else {},
             "cpmmp_fs_1024": fs["launches"] if fs else {}}
    rows = []
    for name, (src, tpu, on_path) in KERNELS.items():
        st = stats.get(name, {})
        by_path = {p: c.get(name, 0) for p, c in paths.items()}
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu, "on_main_path": on_path,
                     "launches": sum(by_path.values()),
                     "launches_by_path": by_path,
                     "max_abs_err": st.get("max_abs_err"),
                     "ms": st.get("ms"), "plain_ms": st.get("plain_ms"),
                     "bound_ms": st.get("bound_ms"),
                     "bound_by": st.get("bound_by"), "library_ms": None,
                     "ms_by_width": st.get("ms_by_width")})
        rows[-1].update({k: v for k, v in st.items()
                         if k.startswith(("times", "host_ms_by", "ms_by"))})
    summary = {"phase_s": round(time.perf_counter() - t_all, 1)}
    if hv:
        summary.update({"hv_1024": {k: round(v, 3)
                                    for k, v in hv["times"].items()},
                        "hv_verify_alone_s": round(hv["verify_s"], 3)})
    if fs:
        summary.update({"fs_prove_s": round(fs["prove_s"], 3),
                        "fs_verify_s": round(fs["verify_s"], 3)})
    log(f"# all phases {sorted(phases)} passed: {json.dumps(summary)}")
    print(json.dumps({"kernels": rows}))
    print(start["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
