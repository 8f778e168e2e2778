#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`legosnark_tpu_torch`) on one GPU.

Phases, each printing its result and times on its own line:
  1. start-up: versions, the card and its power limit, the kernel build
     (fails if K2, K3 or P1b spill);
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
     at 2^20, bit for bit, with their times beside K1's and P1b's
     registers and shared memory from ptxas's report; the pairing on
     the card: bilinearity e(aG1, bG2) = e(G1, G2)^(ab) at width 64 and
     e(G1, G2) equal to the CPU's;
  7. the Fiat-Shamir path at n = 1024 with phase 5's key and data: prove
     and verify true, a tampered proof false, with its launch counts and
     their widths;
  8. the Hadamard example at n = 2^14 (`examples.hadamard.run(14)`):
     CPhadL keygen, three commitments, prove, verify, then CPhad in the
     Fiat-Shamir mode, each timed, with the kernels' launch counts and
     widths; both checked without the port's arithmetic against keygen's
     rebuilt trapdoors and host-int MLEs and Lagrange values (CPhad: the
     commitments, t = c~(rho), the finals, the sumcheck chain closing on
     beta(rho, r) a~(r) b~(r), every opening; CPhadL: c and pi as scalar
     multiples of G1, the G2 legs well formed); tampers verify false
     (CPhad: c != a o b re-proved, two round commitments swapped;
     CPhadL: a proof for c != a o b);
  9. CPlink at N = 2^10 (`examples.cplink.run(10)`): two commitment keys,
     u committed under both, the sparse subspace keygen, prove, and one
     pairing check of the proof and both knowledge legs, timed, with the
     kernels' launch counts and widths; checked without the port's
     arithmetic against host ints from the rebuilt seeds (c_H, c_F and
     their G2 legs, every P_j, pi, C_i and a); four tampers fail (pi
     doubled, F's commitment made to u' != u, x = (c_H, c_H), the
     knowledge legs swapped between the commitments);
 10. CPAC (`examples.matrixac.run(8)`: 512 gates, 64 constraints, the
     dense subspace key of a 67 x 1539 relation): verify true and the
     flipped-output tamper false; the commitments, CPhadL's pi, the t_i G
     and lin_pi equal host-int scalars times G1 (chi, the l_i(chi) and
     k rebuilt from the seeds);
 11. Groth16 on the n = 64 matmul R1CS (`examples.legogrothmatrix.run(64)`:
     2^18 constraints, 270337 variables): keygen, prove, verify and the
     emulated witness commitment, timed, with the kernels' launch counts
     per phase, their widths and the phase's peak device memory; 32
     sampled elements of each key query and A, B, C equal host-int
     scalars times G1 or G2 (the trapdoor and r, s drawn again from the
     seeds, the QAP values from host Lagrange values); the honest proof
     and three tampers (a public output + 1, A and C swapped, B + G2) in
     one `pairing_checks`, only the honest one true;
 12. the sharded layer (`parallel/sharded`, driven by `parallel/dryrun`)
     at the main path's widths: `msm_sharded` over 2^20 distinct points
     k_i*G at c = 17 (and 256 points (i + 1)*G2), `field_sum_sharded` and
     `fold_sharded` at 2^20, `sumcheck_rounds_sharded` at d = 20 with k = 2
     and 3 tables, `cpmat_rounds_sharded` at n = 1024 and `ntt_sharded` at
     2^18 forward and inverse; each on two worlds started by
     `parallel/launch`: 12a NCCL over min(4, cards) cards, one rank each
     (a world of one on one card), 12b gloo with 4 ranks on card 0 (real
     cross-rank traffic through the host). Every output, reassembled,
     equals the local engine on the card, and the MSMs host-int trapdoors;
     every rank launches K1 and every MSM rank K2 and K3. Per function and
     world: seconds, the slowest rank's, launches per kernel and the
     collective bytes received.
 13. the benchmark entry points (`bench`, `bench_gadgets`), each sub-phase
     a path with its own launch counts and widths: 13a `bench.run_msm` at
     2^18 and 2^20 with c = 16, each output equal to its host trapdoor,
     and the bench's lines; 13b `bench_cppoly(20)` with a fresh SRS
     directory (keygen a miss): C, Ca, the answer and all 20 witnesses
     equal host-int scalars times G (v, r, s and alpha drawn again from
     the seeds), a second `keygen_cached` a hit with the same key, and
     three tampers (two witnesses swapped, the answer commitment of
     ans + 1, C and Ca swapped) verify false; 13c `bench_cpsc(16)`: z0,
     z0_comm, every round's h_comms and the finals from host ints, verify
     true, three tampers (two round commitments swapped, a final changed,
     z0_comm of z0 + 1) false; 13d `bench_gadgets.main` with the other
     selectors (cplink, cphad, cpmmp) at scale 1 on 13b's SRS directory
     (cpmmp_1024x1024 a hit on cppoly_20var's file), every verdict row ok.
Each phase's seconds follow it on a line of their own. Then a `kernels`
JSON line (with `ms_by_width` for K2 and K3), the
`nvidia-smi` name and power limit line, and as the last line
{"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py [--phases 1,2,3,4,5,6,7,8,9,10,11,12,13]   (7 needs 5)
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
#: P1b on the CUDA cores: t = a*b and the one byte product of column 62
IMUL_PER_TC = 2 * 64 + 1
#: P1b on the tensor cores: 4 mma.sync m16n8k32 tiles per 8 elements (two
#: of N, two of P's rows 30..61), 2 operations per multiply-add, at the
#: data sheet's dense int8 rate
TC_OPS_PER_ELEM = 4 * 16 * 8 * 32 * 2 // 8
INT8_TC_OPS_PER_S = 1979e12
LIMB_BYTES = 32
#: K3's `times` checked and timed at 2^20 (4: scalar multiplication's
#: windows, 17: the Horner step of a c = 17 MSM)
DOUBLE_TIMES = (4, 17)
#: the main path's narrow launch widths (Horner tails, tables, verifier)
NARROW_WIDTHS = (1, 2, 32, 1 << 10)
#: the main path's kernels, whose launches phases 5 and 7 count
MAIN_KERNELS = ("mont_mul", "g1_add", "g1_double")
#: phase 13's paths, in the order it drives them
BENCH_PATHS = ("bench_msm_c16", "cppoly_20var", "cpsc_16var",
               "bench_gadgets_rest")
#: the selectors 13d drives through `bench_gadgets.main` (13b and 13c hold
#: cppoly and cpsc at full width)
BENCH_REST = ("cplink", "cphad", "cpmmp")


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


#: the G2 generator (EIP-197), affine over Fq2 = Fq[u]/(u^2 + 1)
G2_GEN = ((10857046999023057135944570762232829481370756359578518086990519993285655852781,
           11559732032986387107991004021392285783925812861821192530917403151452391805634),
          (8495653923123431417604973247489272438418190587263600148770280649306958101930,
           4082367875863433681332203403145435568316851327593401208105741076214120093531))


def f2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % Q, (a[0] * b[1] + a[1] * b[0]) % Q)


def f2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def f2_inv(a):
    d = pow(a[0] * a[0] + a[1] * a[1], -1, Q)
    return (a[0] * d % Q, -a[1] * d % Q)


def aff2_add(p, q):
    """Affine addition on the twist y^2 = x^3 + b' over Fq2."""
    if p is None:
        return q
    if q is None:
        return p
    (x1, y1), (x2, y2) = p, q
    if x1 == x2 and (y1[0] + y2[0]) % Q == 0 and (y1[1] + y2[1]) % Q == 0:
        return None
    if p == q:
        x1sq = f2_mul(x1, x1)
        lam = f2_mul((3 * x1sq[0], 3 * x1sq[1]), f2_inv((2 * y1[0], 2 * y1[1])))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_mul(lam, lam), x1), x2)
    return (x3, f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1))


def aff2_mul(p, k):
    k %= R
    acc = None
    while k:
        if k & 1:
            acc = aff2_add(acc, p)
        p = aff2_add(p, p)
        k >>= 1
    return acc


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
    for src, what in (("g1.cu", "K2 and K3"), ("mont_tc.cu", "P1b")):
        check(not re.search(r"[1-9][0-9]* bytes spill", log_[src]["log"]),
              f"{what} build without spills")
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


def phase_msm(torch, np, dev, n: int, c: int) -> list:
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
    want = aff_mul(G, e)
    ms = []
    for _ in range(3):          # the first call in the process, then warm
        _sync(torch, dev)
        t0 = time.perf_counter()
        out = msm.msm(G1, pts, scalars, c=c)
        _sync(torch, dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        check(g1_to_ints(out)[0] == want, "MSM trapdoor check")
    log(f"# phase 3 ok: MSM n={n} c={c} signed, trapdoor check passed, "
        f"{ms[0]:.1f} ms first call, {ms[1]:.1f} / {ms[2]:.1f} ms after")
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
    from legosnark_tpu_torch import kernels
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
    rec = kernels.build_log.get("mont_tc.cu", {})
    use = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", rec.get("log", ""))
    log("# phase 6 P1b ptxas: " + (f"{use[1]} registers, {use[2]} bytes of "
        "shared memory per block" if use else "no ptxas report"))
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


def phase_hadamard(torch, np, dev, d: int, kernels) -> dict:
    """The Hadamard example at n = 2^d, its host-int checks and tampers."""
    from legosnark_tpu_torch.examples import hadamard as had_example

    _sync(torch, dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = had_example.run(d, device=dev)
    total_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    log(f"# phase 8 Hadamard n={1 << d}: launches {json.dumps(launches)} "
        f"times {json.dumps({k: round(v, 3) for k, v in res['times'].items()})}"
        f" total {total_s:.1f}s")
    log(f"# phase 8 launch widths: {json.dumps(_widths(kernels))}")
    check(res["lipmaa"]["ok"], "CPhadL proof at n=2^14 verifies")
    check(res["hadsc"]["ok"], "CPhad Fiat-Shamir proof at n=2^14 verifies")
    for name in MAIN_KERNELS:
        check(launches.get(name, 0) > 0, f"{name} launched on the "
              f"Hadamard path")
    _cphad_host_checks(np, d, res["hadsc"])
    _cphadl_host_checks(np, d, res["lipmaa"])
    _hadamard_tampers(torch, dev, res)
    log("# phase 8 ok: CPhadL and CPhad (Fiat-Shamir) at n=2^14 verify, "
        "agree with host ints and rebuilt trapdoors, and reject tampers")
    return {"launches": launches, "times": res["times"], "total_s": total_s}


def _ints(v):
    from legosnark_tpu_torch.convert import to_ints
    return [int(x) for x in to_ints(v).reshape(-1)]


def _cphad_host_checks(np, d: int, had) -> None:
    """CPhad's commitments and proof from host ints: u drawn again from
    the example's seed, PST13's s and alpha from keygen's."""
    from legosnark_tpu_torch.curve.group import Point, g1_to_ints
    from legosnark_tpu_torch.utils import rand as lrand

    t0 = time.perf_counter()
    n = 1 << d
    u = lrand.rand_fr_ints(np.random.default_rng(31 + d), n)
    vals = {"u": u, "u^2": [x * x % R for x in u]}
    rng = np.random.default_rng(d ^ 0x9057)
    s_key, alpha = lrand.rand_fr_ints(rng, d), lrand.rand_fr_int(rng)
    pf = had["proof"]
    sc = pf.sc_proof
    rho, r = _ints(pf.rho), _ints(sc.r)
    comms = dict(zip(vals, had["comms"]))
    for name, v in vals.items():
        c = g1_to_ints(comms[name].c)[0]
        check(c == aff_mul(G, mle_fold(v, s_key)[0]), f"C_{name} = {name}~(s) G")
        check(g1_to_ints(comms[name].ca)[0] == aff_mul(c, alpha),
              f"Ca_{name} = alpha C_{name}")
    t = mle_fold(vals["u^2"], rho)[0]
    t_comm = g1_to_ints(pf.t_ans_comm)[0]
    check(t_comm == aff_mul(G, t), "t_ans_comm = c~(rho) G")
    fin = mle_fold(u, r)[0]
    check(_ints(sc.finals) == [fin, fin], "finals = a~(r), b~(r)")
    k1 = sc.h_comms.x.shape[-1]
    check(k1 == 4, "degree-3 rounds")
    hc = g1_to_ints(Point(*(x.movedim(0, -2).reshape(8, -1)
                            for x in sc.h_comms)))
    claim = t_comm
    for i in range(d):
        cs = hc[i * k1 : (i + 1) * k1]
        at01 = cs[0]
        for cj in cs:
            at01 = aff_add(at01, cj)
        check(at01 == claim, f"CPhad round {i}: h(0) + h(1) = claim")
        claim = None
        for j, cj in enumerate(cs):
            claim = aff_add(claim, aff_mul(cj, pow(r[i], j, R)))
    beta = 1
    for x, y in zip(rho, r):
        beta = beta * (x * y + (1 - x) * (1 - y)) % R
    check(claim == aff_mul(G, beta * fin * fin),
          "last round closes on beta(rho, r) a~(r) b~(r)")
    for name, cm, pt, ppf, ans in (
            ("c at rho", comms["u^2"], rho, pf.c_poly_pf, t),
            ("a at r", comms["u"], r, sc.poly_pfs[0], fin),
            ("b at r", comms["u"], r, sc.poly_pfs[1], fin)):
        w, wa = g1_to_ints(ppf.witness), g1_to_ints(ppf.witnessa)
        rhs = None
        for j in range(d):
            rhs = aff_add(rhs, aff_mul(w[j], s_key[j] - pt[j]))
            check(wa[j] == aff_mul(w[j], alpha), f"{name}: Wa_{j} = alpha W_{j}")
        lhs = aff_add(g1_to_ints(cm.c)[0], aff_neg(aff_mul(G, ans)))
        check(lhs == rhs, f"opening {name}: C - ans G = sum (s_j - pt_j) W_j")
    log(f"# phase 8 CPhad: commitments, t_ans_comm, finals, the degree-3 "
        f"sumcheck chain and three openings agree with host ints and "
        f"rebuilt s, alpha ({time.perf_counter() - t0:.1f}s)")


def _cphadl_host_checks(np, d: int, lip) -> None:
    """CPhadL's commitments and pi as scalar multiples of G1, the scalars
    from host ints and keygen's rebuilt chi; the G2 legs by their
    well-formedness equation."""
    from legosnark_tpu_torch.curve import pairing as pr
    from legosnark_tpu_torch.curve.bn254 import fr_two_adic_root
    from legosnark_tpu_torch.curve.group import g1_to_ints
    from legosnark_tpu_torch.gadgets import lipmaa
    from legosnark_tpu_torch.utils import rand as lrand

    t0 = time.perf_counter()
    n = 1 << d
    rng = np.random.default_rng(41 + d)
    u = lrand.rand_fr_ints(rng, n)
    ds = lrand.rand_fr_ints(rng, 3)
    check(_ints(lip["ds"]) == ds, "the commitments' r drawn again")
    rng = np.random.default_rng(d ^ 0x11BA)
    chi = lrand.rand_fr_int(rng)
    w = fr_two_adic_root(d)
    z = (pow(chi, n, R) - 1) % R
    lag, wi = [], 1
    for _ in range(n):
        lag.append(z * wi * pow(n * (chi - wi), -1, R) % R)
        wi = wi * w % R
    scal = [(sum(x * y for x, y in zip(v, lag)) + r_ * z) % R
            for v, r_ in zip((u, u, [x * x % R for x in u]), ds)]
    for i, cm in enumerate(lip["comms"]):
        check(g1_to_ints(cm.c)[0] == aff_mul(G, scal[i]),
              f"commitment {i}: c = (sum v_i l_i(chi) + r Z(chi)) G1")
    h = (scal[0] * scal[1] - scal[2]) * pow(z, -1, R) % R
    check(g1_to_ints(lip["pi"])[0] == aff_mul(G, h),
          "pi = H(chi) G1, H = (A B - C) / Z")
    ik = lip["key"].interp
    ok = pr.pairing_checks([g for cm in lip["comms"]
                            for g in lipmaa.commit_pairings(ik, cm)])
    check(bool(ok.all()), "e(c, gamma Z G2) = e(Z G1, kc) for all three")
    log(f"# phase 8 CPhadL: c and pi equal host-int scalars times G1 (rebuilt "
        f"chi, 2^{d} Lagrange values), G2 legs well formed "
        f"({time.perf_counter() - t0:.1f}s)")


def _hadamard_tampers(torch, dev, res) -> None:
    from legosnark_tpu_torch.curve import bn254
    from legosnark_tpu_torch.curve.group import Point
    from legosnark_tpu_torch.fields import limb as fl
    from legosnark_tpu_torch.gadgets import hadamard as cphad
    from legosnark_tpu_torch.gadgets import lipmaa

    one = fl.one(bn254.FR, (), dev)

    def off_by_one(v):
        v = v.clone()
        v[:, :1] = fl.add(bn254.FR, v[:, :1], one)
        return v

    def timed(what, fn):
        t0 = time.perf_counter()
        ok = bool(fn())
        log(f"# phase 8 tamper '{what}': verify {ok} "
            f"({time.perf_counter() - t0:.2f}s)")
        check(not ok, f"tampered proof ({what}) verifies false")

    had = res["hadsc"]
    key, u, (a_cm, _) = had["key"], had["u"], had["comms"]
    sq_bad = off_by_one(had["sq"])

    def wrong_product():
        c_cm = cphad.commit_vec(key, sq_bad)
        pf = cphad.prove_fs(key, u, u, sq_bad, a_cm, a_cm, c_cm,
                            had["nonces"])
        return cphad.verify_fs(key, a_cm, a_cm, c_cm, pf)

    timed("CPhad c != a o b, re-committed and re-proved", wrong_product)
    pf = had["proof"]
    sc = pf.sc_proof
    order = [1, 0] + list(range(2, sc.h_comms.x.shape[0]))
    bad = pf._replace(sc_proof=sc._replace(
        h_comms=Point(*(t[order] for t in sc.h_comms))))
    timed("CPhad round commitments 0 and 1 swapped",
          lambda: cphad.verify_fs(key, a_cm, a_cm, had["comms"][1], bad))

    lip = res["lipmaa"]
    lkey, ds = lip["key"], lip["ds"]
    sq_bad = off_by_one(lip["sq"])

    def lipmaa_wrong_product():
        ca, cb, _ = lip["comms"]
        cc = lipmaa.commit(lkey.interp, sq_bad, ds[..., 2:3])
        pi = lipmaa.prove(lkey, lip["u"], lip["u"], sq_bad, ds)
        return lipmaa.verify(lkey, ca, cb, cc, pi)

    timed("CPhadL proof for c != a o b", lipmaa_wrong_product)


def phase_cplink(torch, np, dev, log_n: int, kernels) -> dict:
    """CPlink at N = 2^log_n, its host-int checks and tampers."""
    from legosnark_tpu_torch.examples import cplink

    _sync(torch, dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = cplink.run(log_n, device=dev)
    total_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    log(f"# phase 9 CPlink N=2^{log_n}: launches {json.dumps(launches)} "
        f"times {json.dumps({k: round(v, 3) for k, v in res['times'].items()})}"
        f" total {total_s:.1f}s")
    log(f"# phase 9 launch widths: {json.dumps(_widths(kernels))}")
    check(res["ok"], "CPlink proof and both knowledge legs verify")
    for name in MAIN_KERNELS:
        check(launches.get(name, 0) > 0, f"{name} launched on the CPlink path")
    _cplink_host_checks(np, res)
    _cplink_tampers(dev, res)
    log(f"# phase 9 ok: CPlink at N=2^{log_n} verifies, agrees with host "
        f"ints from the rebuilt seeds, and rejects four tampers")
    return {"launches": launches, "times": res["times"], "total_s": total_s}


def _cplink_host_checks(np, res) -> None:
    """The commitments, the subspace key and pi from host ints: the keys'
    scalars s_h, s_f (seeds 1, 2 ^ 0x1E605), u, r_H, r_F (seed 23), k and
    a_hat (seed 7 ^ 0x5AB5)."""
    from legosnark_tpu_torch.curve.group import g1_to_ints, g2_to_ints
    from legosnark_tpu_torch.utils import rand as lrand

    t0 = time.perf_counter()
    n = res["n"]
    sh, sf = (lrand.rand_fr_ints(np.random.default_rng(seed ^ 0x1E605), n + 1)
              for seed in (1, 2))
    rng = np.random.default_rng(23)
    u = [int.from_bytes(rng.bytes(31), "little") % R for _ in range(n)]
    rh, rf = lrand.rand_fr_int(rng), lrand.rand_fr_int(rng)
    for name, vin, s, r in (("H", res["vin_h"], sh, rh),
                            ("F", res["vin_f"], sf, rf)):
        v = (sum(a * b for a, b in zip(u, s)) + r * s[n]) % R
        cm = vin.comm_in[0]
        check(g1_to_ints(cm.c) == [aff_mul(G, v)],
              f"c_{name} = (sum u_i s_i + r s_N) G1")
        check(g2_to_ints(cm.kc) == [aff2_mul(G2_GEN, v)],
              f"kc_{name} = (sum u_i s_i + r s_N) G2")
    for name, ck, s in (("H", res["ck_h"], sh), ("F", res["ck_f"], sf)):
        check(g1_to_ints(ck.h) + g1_to_ints(ck.g1s)[:4]
              == [aff_mul(G, x) for x in [s[n]] + s[:4]],
              f"key {name}: h and the first bases = s_i G1")
    rng = np.random.default_rng(7 ^ 0x5AB5)
    k, a_hat = lrand.rand_fr_ints(rng, 2), lrand.rand_fr_int(rng)
    # columns h, f, the N base columns, then N empty ones
    p = ([k[0] * sh[n] % R, k[1] * sf[n] % R]
         + [(k[0] * a + k[1] * b) % R for a, b in zip(sh[:n], sf)] + [0] * n)
    key = res["key"]
    check(g1_to_ints(key.P) == [aff_mul(G, x) for x in p],
          "P_j = (sum_i k_i sM_ij) G1 for every column")
    w = [rh, rf] + u
    pi = sum(a * b for a, b in zip(w, p))
    check(g1_to_ints(res["pi"]) == [aff_mul(G, pi)],
          "pi = (sum_j w_j p_j) G1")
    check(g2_to_ints(key.C) == [aff2_mul(G2_GEN, x * a_hat) for x in k],
          "C_i = (k_i a_hat) G2")
    check(g2_to_ints(key.a) == [aff2_mul(G2_GEN, a_hat)], "a = a_hat G2")
    log(f"# phase 9 host checks: c_H, c_F and their G2 legs, all {len(p)} "
        f"P_j, pi, C and a equal host ints ({time.perf_counter() - t0:.1f}s)")


def _cplink_tampers(dev, res) -> None:
    """Four tampered statements in one `pairing_checks`, each false."""
    from legosnark_tpu_torch.curve import bn254
    from legosnark_tpu_torch.curve import pairing as pr
    from legosnark_tpu_torch.curve.group import G1, point_concat
    from legosnark_tpu_torch.fields import limb as fl
    from legosnark_tpu_torch.gadgets import subspace
    from legosnark_tpu_torch.prototools import commit as cs

    t0 = time.perf_counter()
    key, x, pi = res["key"], res["x"], res["pi"]
    cH, cF = res["vin_h"].comm_in[0], res["vin_f"].comm_in[0]
    u_bad = res["u"].clone()
    u_bad[:, :1] = fl.add(bn254.FR, u_bad[:, :1], fl.one(bn254.FR, (), dev))
    cF_bad = cs.commit(res["ck_f"], u_bad, res["pin_f"].comm_slot[0].r).c
    cases = {
        "pi doubled": subspace.verify_pairings(key, x, G1.double(pi)),
        "F's commitment made to u' != u": subspace.verify_pairings(
            key, point_concat([cH.c, cF_bad.c]), pi),
        "x = (c_H, c_H)": subspace.verify_pairings(
            key, point_concat([cH.c, cH.c]), pi),
        "knowledge legs swapped": cs.knowledge_pairings(
            res["ck_h"], cs.Comm(cH.c, cF.kc)),
    }
    verdicts = pr.pairing_checks([g for gs in cases.values()
                                  for g in gs]).tolist()
    for what, ok in zip(cases, verdicts):
        log(f"# phase 9 tamper '{what}': verify {ok}")
        check(ok is False, f"tampered statement ({what}) verifies false")
    log(f"# phase 9 tampers: {time.perf_counter() - t0:.2f}s")


def phase_matrixac(torch, np, dev, n: int, kernels) -> dict:
    """CPAC on an n x n matrix product, with host-int checks."""
    from legosnark_tpu_torch.examples import matrixac

    _sync(torch, dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = matrixac.run(n, device=dev)
    total_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    log(f"# phase 10 CPAC matrixac n={n} ({res['rel'].n} gates): launches "
        f"{json.dumps(launches)} times "
        f"{json.dumps({k: round(v, 3) for k, v in res['times'].items()})} "
        f"total {total_s:.1f}s (the tamper's prove and verify included)")
    log(f"# phase 10 launch widths: {json.dumps(_widths(kernels))}")
    check(res["ok"], "CPAC proof verifies")
    check(res["tamper_rejected"], "CPAC proof with a flipped output fails")
    for name in MAIN_KERNELS:
        check(launches.get(name, 0) > 0, f"{name} launched on the CPAC path")
    _matrixac_host_checks(np, n, res)
    log(f"# phase 10 ok: CPAC at n={n} verifies, rejects the flipped output "
        f"and agrees with host ints")
    return {"launches": launches, "times": res["times"], "total_s": total_s}


def _matrixac_host_checks(np, n: int, res) -> None:
    """The wires' commitments, CPhadL's pi, t_i G and lin_pi as host-int
    scalars times G1: the data drawn again from seed 0xAC0 + n, chi from
    CPhadL's seed 7 ^ 0x11BA, k from the subspace seed (7 ^ 0xAC) ^ 0x5AB5."""
    from legosnark_tpu_torch.curve.bn254 import fr_two_adic_root
    from legosnark_tpu_torch.curve.group import g1_to_ints
    from legosnark_tpu_torch.utils import rand as lrand

    t0 = time.perf_counter()
    rng = np.random.default_rng(0xAC0 + n)
    A = [[lrand.rand_fr_int(rng) for _ in range(n)] for _ in range(n)]
    B = [[lrand.rand_fr_int(rng) for _ in range(n)] for _ in range(n)]
    ds = lrand.rand_fr_ints(rng, 3)
    check(_ints(res["ds"]) == ds, "the commitments' r drawn again")
    gates = [(i, k, j) for i in range(n) for k in range(n) for j in range(n)]
    ng = len(gates)
    wires = ([A[i][k] for i, k, _ in gates], [B[k][j] for _, k, j in gates])
    wires += ([x * y % R for x, y in zip(*wires)],)
    t = [sum(A[i][k] * B[k][j] for k in range(n)) % R
         for i in range(n) for j in range(n)]
    rng = np.random.default_rng(7 ^ 0x11BA)
    chi = lrand.rand_fr_int(rng)
    w_n = fr_two_adic_root(ng.bit_length() - 1)
    z = (pow(chi, ng, R) - 1) % R
    lag, wi = [], 1
    for _ in range(ng):
        lag.append(z * wi * pow(ng * (chi - wi), -1, R) % R)
        wi = wi * w_n % R
    s = [(sum(a * b for a, b in zip(v, lag)) + d * z) % R
         for v, d in zip(wires, ds)]
    pf = res["proof"]
    for name, cm, sv in zip("lro", (pf.ca, pf.cb, pf.cc), s):
        check(g1_to_ints(cm.c) == [aff_mul(G, sv)],
              f"c_{name} = (sum v_i l_i(chi) + d Z(chi)) G1")
    check(g1_to_ints(pf.had_pi) == [aff_mul(G, (s[0] * s[1] - s[2])
                                            * pow(z, -1, R))],
          "had_pi = H(chi) G1")
    check(g1_to_ints(res["key"].t_points) == [aff_mul(G, x) for x in t],
          "t_points = c_ij G1")
    rng = np.random.default_rng((7 ^ 0xAC) ^ 0x5AB5)
    k = lrand.rand_fr_ints(rng, 3 + len(t))
    # row 3 + (i n + j) of the relation sums the gates' outputs o_ikj into
    # c_ij, so <M_row, w> = c_ij
    lin = sum(a * b for a, b in zip(k, s)) + sum(a * b for a, b in zip(k[3:], t))
    check(g1_to_ints(pf.lin_pi) == [aff_mul(G, lin)],
          "lin_pi = (sum_i k_i <M_i, w>) G1")
    log(f"# phase 10 host checks: commitments, had_pi, {len(t)} t_i G and "
        f"lin_pi equal host ints ({time.perf_counter() - t0:.1f}s)")


def phase_groth16(torch, np, dev, n: int, kernels) -> dict:
    """Groth16 on the n x n matmul R1CS, its host-int checks and tampers."""
    from legosnark_tpu_torch.examples import legogrothmatrix

    _sync(torch, dev)
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = legogrothmatrix.run(n, device=dev)
    total_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    r1cs = res["r1cs"]
    log(f"# phase 11 Groth16 n={n} ({len(r1cs.A)} constraints, "
        f"{r1cs.num_vars} vars): launches {json.dumps(launches)} times "
        f"{json.dumps({k: round(v, 3) for k, v in res['times'].items()})} "
        f"total {total_s:.1f}s peak device memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB)")
    log(f"# phase 11 launches by phase: {json.dumps(res['launches'])}")
    log(f"# phase 11 launch widths: {json.dumps(_widths(kernels))}")
    check(res["ok"], "the Groth16 proof verifies")
    for name in MAIN_KERNELS:
        check(launches.get(name, 0) > 0,
              f"{name} launched on the Groth16 path")
    _groth16_host_checks(np, res)
    _groth16_tampers(dev, res)
    log(f"# phase 11 ok: Groth16 at n={n} verifies, its key samples and "
        f"proof equal host ints, and three tampers fail")
    return {"launches": launches, "times": res["times"], "total_s": total_s,
            "peak_bytes": peak}


def _groth16_host_checks(np, res, samples: int = 32) -> None:
    """32 sampled elements of each key query, the key's single elements
    and A, B, C as host-int scalars times G1 or G2: the data drawn again
    from rng 67 + n, the trapdoor from seed n ^ 0x6706, r and s from
    n ^ 0x6707, the Lagrange values of the domain at tau computed here."""
    from legosnark_tpu_torch.curve.bn254 import fr_two_adic_root
    from legosnark_tpu_torch.curve.group import (g1_to_ints, g2_to_ints,
                                                 point_map)

    def draws(rng, k):
        return [int.from_bytes(rng.bytes(40), "little") % R for _ in range(k)]

    t0 = time.perf_counter()
    n, r1cs, z, pk, vk = res["n"], res["r1cs"], res["z"], res["pk"], res["vk"]
    rng = np.random.default_rng(67 + n)
    A, B = draws(rng, n * n), draws(rng, n * n)
    check(res["public"] == [sum(A[i * n + k] * B[k * n + j] for k in range(n))
                            % R for i in range(n) for j in range(n)],
          "the public outputs are C = A B of the redrawn data")
    tau, alpha, beta, gamma, delta = draws(
        np.random.default_rng(n ^ 0x6706), 5)
    r, s = draws(np.random.default_rng(n ^ 0x6707), 2)
    m, nv, npub = len(r1cs.A), r1cs.num_vars, r1cs.num_public + 1
    d = 1 << (m - 1).bit_length()
    root = fr_two_adic_root(d.bit_length() - 1)
    z_tau = (pow(tau, d, R) - 1) % R
    lag, wj = [], 1
    for _ in range(d):
        lag.append(z_tau * wj * pow(d * (tau - wj), -1, R) % R)
        wj = wj * root % R
    u, v, w = [0] * nv, [0] * nv, [0] * nv
    for rows, acc in ((r1cs.A, u), (r1cs.B, v), (r1cs.C, w)):
        for row, lj in zip(rows, lag):
            for var, coef in row:
                acc[var] = (acc[var] + coef * lj) % R
    comb = [(beta * a + alpha * b + c) % R for a, b, c in zip(u, v, w)]
    dinv, ginv = pow(delta, -1, R), pow(gamma, -1, R)
    queries = {   # name -> (points, scalar of index i, on G2?)
        "a_query": (pk.a_query, lambda i: u[i], False),
        "b1_query": (pk.b1_query, lambda i: v[i], False),
        "b2_query": (pk.b2_query, lambda i: v[i], True),
        "h_query": (pk.h_query, lambda i: pow(tau, i, R) * z_tau * dinv,
                    False),
        "l_query": (pk.l_query, lambda i: comb[npub + i] * dinv, False),
        "ic": (vk.ic, lambda i: comb[i] * ginv, False)}
    pick = np.random.default_rng(11)
    for name, (pts, scalar, on_g2) in queries.items():
        width = pts.x.shape[-1]
        idx = sorted(int(i) for i in pick.choice(width, min(samples, width),
                                                 replace=False))
        got = (g2_to_ints if on_g2 else g1_to_ints)(
            point_map(lambda t: t[..., idx], pts))
        want = [aff2_mul(G2_GEN, scalar(i)) if on_g2 else aff_mul(G, scalar(i))
                for i in idx]
        check(got == want, f"{name} at {len(idx)} sampled indices")
    check(g1_to_ints(pk.alpha_g1) + g1_to_ints(pk.beta_g1)
          + g1_to_ints(pk.delta_g1) == [aff_mul(G, x)
                                        for x in (alpha, beta, delta)],
          "alpha, beta, delta in G1")
    check(g2_to_ints(pk.beta_g2) + g2_to_ints(vk.gamma_g2)
          + g2_to_ints(pk.delta_g2) == [aff2_mul(G2_GEN, x)
                                        for x in (beta, gamma, delta)],
          "beta, gamma, delta in G2")
    a = sum(x * y for x, y in zip(z, u)) % R
    b = sum(x * y for x, y in zip(z, v)) % R
    c = sum(x * y for x, y in zip(z, w)) % R
    priv = sum(x * y for x, y in zip(z[npub:], comb[npub:]))
    a_s = (alpha + a + r * delta) % R
    b_s = (beta + b + s * delta) % R
    c_s = ((priv + a * b - c) * dinv + s * a_s + r * b_s - r * s * delta) % R
    pf = res["pf"]
    check(g1_to_ints(pf.a) == [aff_mul(G, a_s)],
          "A = (alpha + a(tau) + r delta) G1")
    check(g2_to_ints(pf.b) == [aff2_mul(G2_GEN, b_s)],
          "B = (beta + b(tau) + s delta) G2")
    check(g1_to_ints(pf.c) == [aff_mul(G, c_s)],
          "C = ((priv + a b - c) / delta + s A + r B1 - rs delta) G1")
    log(f"# phase 11 host checks: up to {samples} samples of each of the six "
        f"key queries, the six single key elements and A, B, C equal host ints "
        f"({time.perf_counter() - t0:.1f}s)")


def _groth16_tampers(dev, res) -> None:
    """The honest proof and three tampers in one `pairing_checks`."""
    from legosnark_tpu_torch.curve import pairing as pr
    from legosnark_tpu_torch.curve.group import G2, g2_generator
    from legosnark_tpu_torch.gadgets import groth16

    t0 = time.perf_counter()
    vk, pf, public = res["vk"], res["pf"], res["public"]
    bad = list(public)
    bad[0] = (bad[0] + 1) % R
    cases = {
        "honest": groth16.verify_pairs(vk, public, pf),
        "public output + 1": groth16.verify_pairs(vk, bad, pf),
        "A and C swapped": groth16.verify_pairs(
            vk, public, groth16.Proof(pf.c, pf.b, pf.a)),
        "B + G2": groth16.verify_pairs(vk, public, groth16.Proof(
            pf.a, G2.add(pf.b, g2_generator((), dev)), pf.c)),
    }
    verdicts = pr.pairing_checks([g for gs in cases.values()
                                  for g in gs]).tolist()
    for what, ok in zip(cases, verdicts):
        log(f"# phase 11 verify '{what}': {ok}")
        honest = what == "honest"
        check(ok is honest, f"verify '{what}' is {honest}")
    log(f"# phase 11 tampers: {time.perf_counter() - t0:.2f}s")


def phase_sharded(torch, np, dev, sizes, worlds: dict) -> dict:
    """The sharded layer (`parallel/dryrun`) at `sizes` on each world of
    `worlds` (path -> (devices, backend)): every output equal to the
    local engine on `dev`, the MSMs also to host-int trapdoors, K1 on
    every rank and K2, K3 on every MSM rank."""
    from legosnark_tpu_torch.curve.group import g1_to_ints, g2_to_ints
    from legosnark_tpu_torch.fields import limb as fl
    from legosnark_tpu_torch.parallel import dryrun

    seed = 12
    t0 = time.perf_counter()
    ref = dryrun.reference(sizes, seed, dev)
    _sync(torch, dev)
    ref_s = time.perf_counter() - t0
    inp = dryrun.make_inputs(sizes, seed)
    ks, ss = fl.limbs_to_ints(inp["msm_k"]), fl.limbs_to_ints(inp["msm_s"])
    e = sum(int(k) * int(s) for k, s in zip(ks, ss)) % R
    check(g1_to_ints(ref["msm_g1"]) == [aff_mul(G, e)],
          "local G1 MSM equals the host trapdoor")
    e2 = sum((i + 1) * int(s)
             for i, s in enumerate(fl.limbs_to_ints(inp["g2_s"]))) % R
    check(g2_to_ints(ref["msm_g2"]) == [aff2_mul(G2_GEN, e2)],
          "local G2 MSM equals the host trapdoor")
    log(f"# phase 12 sizes {json.dumps(sizes._asdict())}: local engine "
        f"{ref_s:.1f}s, its MSMs equal the host trapdoors")
    launches, times = {}, {}
    for path, (devices, backend) in worlds.items():
        t0 = time.perf_counter()
        _, ranks = dryrun.run_world(devices, backend, sizes, seed, ref)
        world_s = time.perf_counter() - t0
        log(f"# phase 12 {path}: backend {backend}, {len(devices)} ranks on "
            f"{','.join(devices)}, {world_s:.1f}s with start-up; every "
            f"output equals the local engine")
        for r, rk in enumerate(ranks):
            per = rk["stats"]
            k1 = sum(st["launches"].get("mont_mul", 0) for st in per.values())
            check(k1 > 0, f"{path} rank {r} launched K1")
            for kern in ("g1_add", "g1_double"):
                check(per["msm_sharded_g1"]["launches"].get(kern, 0) > 0,
                      f"{path} rank {r} launched {kern} in its MSM")
        summ = dryrun.summary(ranks)
        total: dict = {}
        for name, st in summ.items():
            log(f"# phase 12 {path} {name}: {st['seconds']:.4f} s, slowest "
                f"rank {st['slowest_s']:.4f} s, launches "
                f"{json.dumps(st['launches'])}, collective bytes "
                f"{st['collective_bytes']}")
            for k, v in st["launches"].items():
                total[k] = total.get(k, 0) + v
        launches[path] = total
        times[path] = {name: round(st["slowest_s"], 4)
                       for name, st in summ.items()}
        times[path]["world_s"] = round(world_s, 1)
    log(f"# phase 12 ok: {', '.join(worlds)} equal the local engine and the "
        f"host trapdoors; K1 on every rank, K2 and K3 in every rank's MSM")
    return {"launches": launches, "times": times}


def sharded_worlds(torch) -> dict:
    """Phase 12's worlds: NCCL over min(4, cards) cards, one rank each,
    and gloo with 4 ranks on card 0 (NCCL refuses two ranks on a card)."""
    w = min(4, torch.cuda.device_count())
    return {f"sharded_w{w}_nccl": ([f"cuda:{r}" for r in range(w)], "nccl"),
            "sharded_w4_gloo": (["cuda:0"] * 4, "gloo")}


def phase_bench(torch, np, dev, kernels) -> dict:
    """The benchmark entry points on the card: 13a the MSM bench at 2^18
    and 2^20 with c = 16, 13b `bench_cppoly(20)`, 13c `bench_cpsc(16)`,
    13d `bench_gadgets.main` with the other selectors at scale 1. Each is
    a path of its own: launch counts set to 0 before it and read after."""
    import tempfile
    from fractions import Fraction

    from legosnark_tpu_torch import bench, bench_gadgets as bg
    from legosnark_tpu_torch.curve.group import g1_to_ints

    launches, summary = {}, {}

    def drive(path, fn, *args):
        _sync(torch, dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(torch, dev)
        launches[path] = dict(kernels.launches)
        log(f"# phase 13 {path}: {time.perf_counter() - t0:.1f}s, launches "
            f"{json.dumps(launches[path])}, widths "
            f"{json.dumps(_widths(kernels))}")
        for name in MAIN_KERNELS:
            check(launches[path].get(name, 0) > 0,
                  f"{name} launched on the {path} path")
        return out

    msms = drive("bench_msm_c16", lambda: {
        log_n: bench.run_msm(log_n, 16, 3, dev) for log_n in (18, 20)})
    for log_n, res in msms.items():
        e = sum(k * s for k, s in zip(res["k"], res["s"])) % R
        check(g1_to_ints(res["out"]) == [aff_mul(G, e)],
              f"MSM 2^{log_n} c=16 trapdoor check")
        line = bench.size_line(log_n, res)
        summary[f"msm_2e{log_n}_c16"] = line
        log(f"# phase 13a {json.dumps(line)}")
    log(f"# phase 13a {json.dumps(bench.headline(msms))}")
    log("# phase 13a ok: both MSMs at c = 16 meet their trapdoors")

    build = os.path.join(HERE, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as cache:
        rows = bg.Rows()
        res = drive("cppoly_20var", bg.bench_cppoly, 20, dev, cache, rows)
        summary["cppoly_20var"] = rows.rows
        check(rows.rows[0]["srs_cache_hit"] is False,
              "the first keygen misses the fresh SRS cache")
        check(res["ok"], "CPpoly over 20 variables verifies")
        _cppoly_host_checks(np, 20, res)
        _cppoly_cache_round_trip(torch, dev, 20, cache, res["key"])
        _cppoly_tampers(dev, res)
        log("# phase 13b ok: cppoly_20var agrees with host ints and the "
            "rebuilt s, alpha; the SRS cache round trip holds; three "
            "tampers fail")

        rows = bg.Rows()
        res = drive("cpsc_16var", bg.bench_cpsc, 16, dev, cache, rows)
        summary["cpsc_16var"] = rows.rows
        check(res["ok"], "CPsc over 16 variables verifies")
        _cpsc_host_checks(np, 16, res)
        _cpsc_tampers(dev, res)
        log("# phase 13c ok: cpsc_16var agrees with host ints and rejects "
            "three tampers")

        out = os.path.join(cache, "rows.json")
        drive("bench_gadgets_rest", bg.main, [
            *BENCH_REST, "--out", out, "--srs-cache", cache])
        with open(out) as fh:
            rows = json.load(fh)
    names = bg.config_names(BENCH_REST, Fraction(1))
    check({r["config"] for r in rows} == names,
          f"the scale 1 run emits {sorted(names)}")
    for name in names:
        ok = [r["ok"] for r in rows if r["config"] == name and "ok" in r]
        check(ok == [True], f"{name}: its verdict row shows ok true")
    hit = [r["srs_cache_hit"] for r in rows
           if r["config"] == "cpmmp_1024x1024" and r["phase"] == "keygen"]
    check(hit == [True], "cpmmp_1024x1024's keygen hits cppoly_20var's SRS")
    log(f"# phase 13d ok: {len(rows)} rows of {len(names)} configurations "
        f"at scale 1, every verdict true, cpmmp's keygen a cache hit")
    return {"launches": launches, "summary": summary}


def _cppoly_host_checks(np, d: int, res) -> None:
    """CPpoly from host ints: v and r drawn again from the bench's seed 3,
    s and alpha from keygen's seed 1 ^ 0x9057. C = v~(s) G, Ca = alpha C,
    the answer v~(r), and each witness W_i = q_i~(s_{i+1..}) G with q_i
    the quotient hi - lo of v folded at r_0..r_{i-1}, Wa_i = alpha W_i."""
    from legosnark_tpu_torch.curve.group import g1_to_ints
    from legosnark_tpu_torch.fields import limb as fl
    from legosnark_tpu_torch.utils import rand as lrand

    t0 = time.perf_counter()
    rng = np.random.default_rng(3)
    v = [int(x) for x in fl.limbs_to_ints(lrand.rand_fr_limbs_fast(rng, 1 << d))]
    r = lrand.rand_fr_ints(rng, d)
    check(_ints(res["r"]) == r, "the opening point drawn again")
    rng = np.random.default_rng(1 ^ 0x9057)
    s, alpha = lrand.rand_fr_ints(rng, d), lrand.rand_fr_int(rng)
    c = g1_to_ints(res["comm"].c)[0]
    check(c == aff_mul(G, mle_fold(v, s)[0]), "C = v~(s) G")
    check(g1_to_ints(res["comm"].ca)[0] == aff_mul(c, alpha), "Ca = alpha C")
    pf = res["proof"]
    w, wa = g1_to_ints(pf.witness), g1_to_ints(pf.witnessa)
    for i in range(d):
        h = len(v) // 2
        q = [(hi - lo) % R for lo, hi in zip(v[:h], v[h:])]
        check(w[i] == aff_mul(G, mle_fold(q, s[i + 1:])[0]),
              f"W_{i} = q_{i}~(s_{i + 1}..) G")
        check(wa[i] == aff_mul(w[i], alpha), f"Wa_{i} = alpha W_{i}")
        v = mle_fold(v, r[i : i + 1])
    check(_ints(res["ans"]) == v, "the answer is v~(r)")
    check(g1_to_ints(res["ans_comm"]) == [aff_mul(G, v[0])],
          "the answer commitment is v~(r) G")
    log(f"# phase 13b host checks: C, Ca, v~(r) and all {d} witnesses "
        f"({time.perf_counter() - t0:.1f}s)")


def _cppoly_cache_round_trip(torch, dev, d: int, cache, key) -> None:
    """A second `keygen_cached` finds the file and loads the same key."""
    from legosnark_tpu_torch.gadgets import poly as cppoly

    check(cppoly.srs_path(d, 1, cache).exists(), "the SRS file was written")
    t0 = time.perf_counter()
    again = cppoly.keygen_cached(d, 1, cache, dev)
    _sync(torch, dev)
    load_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for p, q in zip(
        key.bases + key.bases_a + (key.g2_s, key.g2_alpha, key.g1, key.g2),
        again.bases + again.bases_a + (again.g2_s, again.g2_alpha, again.g1,
                                       again.g2))
        for a, b in zip(p, q))
    check(same, "the cached key equals the built one")
    size = os.path.getsize(cppoly.srs_path(d, 1, cache))
    log(f"# phase 13b SRS cache: hit, {size} bytes, loaded in {load_s:.2f}s, "
        f"equal to the built key")


def _cppoly_tampers(dev, res) -> None:
    from legosnark_tpu_torch.curve import bn254
    from legosnark_tpu_torch.curve.group import G1, point_map
    from legosnark_tpu_torch.fields import limb as fl
    from legosnark_tpu_torch.gadgets import poly as cppoly

    key, cm, pf, r = res["key"], res["comm"], res["proof"], res["r"]
    d = pf.witness.x.shape[-1]
    order = [1, 0] + list(range(2, d))
    ans1 = fl.add(bn254.FR, res["ans"], fl.one(bn254.FR, (), dev))
    cases = {
        "W_0 and W_1 swapped": (cm, res["ans_comm"], pf._replace(
            witness=point_map(lambda x: x[..., order], pf.witness))),
        "answer commitment of ans + 1": (cm, G1.scalar_mul(
            key.g1, fl.from_mont(bn254.FR, ans1)), pf),
        "C and Ca swapped": (cppoly.PolyComm(cm.ca, cm.c), res["ans_comm"], pf),
    }
    for what, (c, ac, p) in cases.items():
        t0 = time.perf_counter()
        ok = bool(cppoly.check_commit(key, c) & cppoly.verify(key, c, ac, r, p))
        log(f"# phase 13b tamper '{what}': verify {ok} "
            f"({time.perf_counter() - t0:.2f}s)")
        check(not ok, f"tampered CPpoly opening ({what}) verifies false")


def _cpsc_host_checks(np, d: int, res) -> None:
    """CPsc from host ints: a, b and the challenges drawn again from the
    bench's seed 7 + d. z0 = sum a_i b_i, z0_comm = z0 G, each round's
    h_comms its round polynomial's coefficients times G, the finals
    a~(r) and b~(r)."""
    from legosnark_tpu_torch.curve.group import Point, g1_to_ints
    from legosnark_tpu_torch.fields import limb as fl
    from legosnark_tpu_torch.utils import rand as lrand

    t0 = time.perf_counter()
    rng = np.random.default_rng(7 + d)
    a, b = ([int(x) for x in fl.limbs_to_ints(
        lrand.rand_fr_limbs_fast(rng, 1 << d))] for _ in range(2))
    for k in (d, 5, d, 1):                 # eq_k, prd_b, eq_e, prd_e
        lrand.rand_fr_ints(rng, k)
    chal = lrand.rand_fr_ints(rng, d)
    check(_ints(res["chal"]) == chal, "the round challenges drawn again")
    z0 = sum(x * y for x, y in zip(a, b)) % R
    check(_ints(res["z0"]) == [z0], "z0 = sum a_i b_i")
    check(g1_to_ints(res["z0_comm"]) == [aff_mul(G, z0)], "z0_comm = z0 G")
    pf = res["proof"]
    for i in range(d):
        h = len(a) // 2
        da = [(y - x) % R for x, y in zip(a[:h], a[h:])]
        db = [(y - x) % R for x, y in zip(b[:h], b[h:])]
        coeffs = (sum(x * y for x, y in zip(a[:h], b[:h])),
                  sum(x * y + u * w for x, y, u, w in zip(a[:h], db, da, b[:h])),
                  sum(x * y for x, y in zip(da, db)))
        check(g1_to_ints(Point(*(t[i] for t in pf.h_comms)))
              == [aff_mul(G, c) for c in coeffs],
              f"round {i}: h_comms = h_{i}'s coefficients times G")
        a, b = mle_fold(a, chal[i : i + 1]), mle_fold(b, chal[i : i + 1])
    check(_ints(pf.finals) == a + b, "the finals are a~(r) and b~(r)")
    log(f"# phase 13c host checks: z0, z0_comm, all {d} rounds' h_comms and "
        f"the finals ({time.perf_counter() - t0:.1f}s)")


def _cpsc_tampers(dev, res) -> None:
    from legosnark_tpu_torch.curve import bn254
    from legosnark_tpu_torch.curve.group import point_map
    from legosnark_tpu_torch.fields import limb as fl
    from legosnark_tpu_torch.gadgets import sumcheck as cpsc

    key, pf = res["key"], res["proof"]
    one = fl.one(bn254.FR, (), dev)
    order = [1, 0] + list(range(2, pf.h_comms.x.shape[0]))
    finals = pf.finals.clone()
    finals[..., :1] = fl.add(bn254.FR, finals[..., :1], one)
    cases = {
        "round commitments 0 and 1 swapped": (res["z0_comm"], pf._replace(
            h_comms=point_map(lambda x: x[order], pf.h_comms))),
        "a final changed": (res["z0_comm"], pf._replace(finals=finals)),
        "z0_comm of z0 + 1": (cpsc.commit_scalar(
            key.g1, fl.add(bn254.FR, res["z0"], one)), pf),
    }
    for what, (zc, p) in cases.items():
        t0 = time.perf_counter()
        ok = bool(cpsc.verify(key, zc, res["comms"], p, lambda r: (r, r),
                              rand=res["hv"]))
        log(f"# phase 13c tamper '{what}': verify {ok} "
            f"({time.perf_counter() - t0:.2f}s)")
        check(not ok, f"tampered CPsc proof ({what}) verifies false")


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
    phases = set(range(1, 14))
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
        from legosnark_tpu_torch.parallel import dryrun
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    phase_s = {}

    def timed(k, fn, *args):
        """Phase k's result; its seconds on a line of their own."""
        if k not in phases:
            return None
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[k] = round(time.perf_counter() - t0, 1)
        log(f"# phase {k} seconds: {phase_s[k]}")
        return out

    start = phase_startup(torch, kernels)
    log(f"# phase 1 seconds: {time.perf_counter() - t_all:.1f}")
    stats = timed(2, phase_kernels, torch, np, dev, 1 << 20) or {}
    timed(3, phase_msm, torch, np, dev, 1 << 20, 17)
    timed(4, phase_parity, torch, dev)
    hv = timed(5, phase_cpmmp, torch, np, dev, 10, kernels)
    stats.update(timed(6, phase_probes, torch, np, dev) or {})
    fs = timed(7, lambda: phase_fs(torch, dev, kernels, hv["res"]))
    had = timed(8, phase_hadamard, torch, np, dev, 14, kernels)
    link = timed(9, phase_cplink, torch, np, dev, 10, kernels)
    mac = timed(10, phase_matrixac, torch, np, dev, 8, kernels)
    g16 = timed(11, phase_groth16, torch, np, dev, 64, kernels)
    worlds = sharded_worlds(torch)
    shd = timed(12, phase_sharded, torch, np, dev, dryrun.FULL, worlds)
    bnc = timed(13, phase_bench, torch, np, dev, kernels)
    paths = {"cpmmp_hv_1024": hv["launches"] if hv else {},
             "cpmmp_fs_1024": fs["launches"] if fs else {},
             "hadamard_2e14": had["launches"] if had else {},
             "cplink_2e10": link["launches"] if link else {},
             "matrixac_8": mac["launches"] if mac else {},
             "groth16_64": g16["launches"] if g16 else {}}
    paths.update({p: shd["launches"][p] if shd else {} for p in worlds})
    paths.update({p: bnc["launches"].get(p, {}) if bnc else {}
                  for p in BENCH_PATHS})
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
    summary = {"phase_s": round(time.perf_counter() - t_all, 1),
               "seconds_by_phase": phase_s}
    if hv:
        summary.update({"hv_1024": {k: round(v, 3)
                                    for k, v in hv["times"].items()},
                        "hv_verify_alone_s": round(hv["verify_s"], 3)})
    if fs:
        summary.update({"fs_prove_s": round(fs["prove_s"], 3),
                        "fs_verify_s": round(fs["verify_s"], 3)})
    for name, res in (("hadamard_2e14", had), ("cplink_2e10", link),
                      ("matrixac_8", mac), ("groth16_64", g16)):
        if res:
            summary[name] = {k: round(v, 3) for k, v in res["times"].items()}
    if shd:
        summary.update(shd["times"])
    if bnc:
        summary.update(bnc["summary"])
    log(f"# all phases {sorted(phases)} passed: {json.dumps(summary)}")
    print(json.dumps({"kernels": rows}))
    print(start["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
