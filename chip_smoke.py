#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`legosnark_tpu_torch`) on one GPU.

Phases, each printing its result and times on its own line:
  1. start-up: versions, the card and its power limit, the kernel build
     (fails if K2-K6 or P1b spill);
  2. kernels K1 (Montgomery product), K2 (G1 add) and K3 (G1 double,
     also with times = 4 and 17 doublings in one launch) against their
     plain PyTorch versions at 2^20 elements, bit for bit, with edge
     values, the identity, P + P and P + (-P); then K2, K3 and K3 with
     times = 17 at widths 1, 2, 32 and 2^10, bit for bit, with device us
     per launch and host us per wrapper call; K4 (the MiMC permutation)
     against the transcript's torch loop at 2^20 (the plain form and the
     tree's combine, odd and even) and at width 1 (the plain form and
     state + digest), timed at 2^20 beside its bound and at width 1 in
     device and host us; K5 (G2 add) and K6 (G2 double, times 1, 4 and
     17) against their plain versions at 2^20 points k_i*G2, bit for bit,
     the group law checked on 16 against the affine host reference,
     timed beside their bounds, and at widths 1, 2, 8 and 32 (K6 also
     with times = 17) bit for bit with device and host us;
  3. a 2^20-point MSM with c = 17 (signed digits) checked by a trapdoor:
     points k_i*G with known k_i, expected (sum s_i k_i mod r)*G;
  4. CPmmp at n = 4 on the card against the same run on the CPU, element
     for element: the honest-verifier proof, the Fiat-Shamir in-clear
     proof and the Fiat-Shamir committed proof (the transcript is
     deterministic), each verified true on both devices;
  5. CPmmp at n = 1024 in the honest-verifier mode
     (`examples.matrixsc.run(10, fs=False)`: data, keygen, the two
     commitments, prove, verify), verify true, K1-K3 launched;
  6. the probes P1a (SOS product), P1b (tensor-core reduction) and P2
     (limb product, three variants) against their plain versions and K1
     at 2^20, bit for bit, with their times beside K1's and P1b's
     registers and shared memory from ptxas's report; the pairing on
     the card: pairing.cu's build seconds and ptxas report, K7 (Miller
     loop) and K8 (product and final exponentiation) at the cells'
     shapes (Groth16's one group of 4 pairs, CPmmp's 126 pairs in 44
     groups; bit for bit against the plain path, both timed) and at 2^14
     pairs, beside their bounds; bilinearity e(aG1, bG2) = e(G1, G2)^(ab)
     at width 64 and e(G1, G2) equal to the CPU's;
  7. the same in the Fiat-Shamir mode (`matrixsc.run(10)`), verify true,
     K1-K4 launched;
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
 11. Groth16 on the 128 x 128 matmul R1CS, 2^21 constraints
     (`examples.legogrothmatrix.run(128)`: setup, prove, verify, the
     emulated witness commitment), verify true, K1-K3, K5 and K6 launched;
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

Phases 5, 7-11 and 13 each drive one or more paths, with the kernels'
launches counted per path and by width. Phases 5, 7 and 11 check only the
verdict and the launches: their paths are the benchmark's cells, held to
their plain references with tampered proofs (`python3 portbench/run.py
--workload cpmmp_1024.hv`, `.fs`, `groth16_mm128.session`, `--trace 1`).

Usage: python3 chip_smoke.py [--phases 1,2,3,...,13]
Needs one CUDA card; exits non-zero without one, or when any check fails.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

# the host-int reference and the roofline constants are the benchmark's:
# the cells and these checks share one copy (ROADMAP.md, section 4)
from portbench.reference._bn254 import (G1_GEN as G, G2_GEN, R, aff2_add,
                                        aff2_mul, aff_add, aff_mul, aff_neg,
                                        mle_fold)
from portbench.roofline import (HBM_BYTES_PER_S, IMUL_PER_MONT,
                                INT32_MUL_PER_S, LIMB_BYTES)

HERE = os.path.dirname(os.path.abspath(__file__))

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
#: Montgomery products per MiMC permutation (K4): 110 rounds of three
MIMC_PRODUCTS = 330
#: Montgomery products per thread of csrc/pairing.cu, counted over its
#: sequence of Fq products: K7 per pair (its two Fermat inversions
#: included), K8 per product of one Miller value (each further value in the
#: product adds one Fq12 product, 54)
MONT_PER_MILLER = 11248
MONT_PER_FINAL_EXP = 12369
#: the cells' pairing checks (group sizes): Groth16's one group of 4 pairs;
#: CPmmp's two CPpoly openings at d = 20, each a knowledge group of 2
#: pairs, a main group of 21 and 20 knowledge groups of 2
PAIRING_SHAPES = {"groth16": [4], "cpmmp": ([2, 21] + [2] * 20) * 2}
#: K7's and K8's width where the multiply rate bounds them
PAIRING_WIDE = 1 << 14
#: K3's `times` checked and timed at 2^20 (4: scalar multiplication's
#: windows, 17: the Horner step of a c = 17 MSM)
DOUBLE_TIMES = (4, 17)
#: the main path's narrow launch widths (Horner tails, tables, verifier)
NARROW_WIDTHS = (1, 2, 32, 1 << 10)
#: K5/K6's narrow widths: the G2 Horner steps of one to a few MSM rows,
#: the generator table's chain, the key's scalar multiplications
G2_NARROW_WIDTHS = (1, 2, 8, 32)
#: the main path's kernels, which every path of phases 5, 7-11 and 13
#: must launch
MAIN_KERNELS = ("mont_mul", "g1_add", "g1_double")
#: the phases, as `--phases` names them
PHASES = tuple(range(1, 14))
#: phases 5, 7 and 11: the path each drives, the example's `run` at its
#: benchmark cell's size, and the kernels it launches beyond K1-K3
EXAMPLE_PATHS = {5: ("cpmmp_hv_1024", ()), 7: ("cpmmp_fs_1024", ("mimc",)),
                 11: ("groth16_128", ("g2_add", "g2_double"))}
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
    for src, what in (("g1.cu", "K2 and K3"), ("mont_tc.cu", "P1b"),
                      ("mimc.cu", "K4"), ("g2.cu", "K5 and K6")):
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
    stats["mimc"] = _mimc(dev, rng, n)
    stats.update(_g2_kernels(torch, dev, rng, n))
    for name, st in stats.items():
        check(st["max_abs_err"] == 0, f"{name} equals its plain version")
    log("# phase 2 ok: K1-K6 bit-identical to their plain versions")
    return stats


def _g2_kernels(torch, dev, rng, n: int) -> dict:
    """K5 and K6 (times 1, 4, 17) against their plain versions at n points
    k_i*G2, bit for bit, with the second operand mixing Q = P, -P, the
    identity and another point, and the group law checked against the
    affine host reference on 16 of them; their ms beside the bounds and
    the plain versions'; then K5, K6 and K6 with times = 17 at widths 1-32,
    bit for bit, with device us per launch and host us per wrapper call."""
    from legosnark_tpu_torch import kernels
    from legosnark_tpu_torch.curve import cuda_group, msm
    from legosnark_tpu_torch.curve.group import (G2, Point, g2_generator,
                                                 g2_to_ints)
    from legosnark_tpu_torch.fields import limb as fl
    from legosnark_tpu_torch.utils.bench import (launch_us, rand_below,
                                                 timed_ms, word_err)

    ks = fl.tensor(fl.ints_to_limbs(rand_below(rng, n, R)), dev)
    table = msm.fixed_base_table(G2, g2_generator((), dev), c=8)
    P = msm.batch_scalar_mul(G2, table, ks, c=8)
    Qp = Point(*(t.roll(1, -1) for t in P))
    sel = torch.arange(n, device=dev) % 4
    Qp = G2.select(sel == 0, P, Qp)
    Qp = G2.select(sel == 1, G2.neg(P), Qp)
    Qp = G2.select(sel == 2, G2.identity((n,), dev), Qp)
    Pc = tuple(t.contiguous() for t in P)
    Qc = tuple(t.contiguous() for t in Qp)
    add, add_plain = cuda_group.g2_add_points, cuda_group.g2_add_points_plain
    dbl, dbl_plain = (cuda_group.g2_double_point,
                      cuda_group.g2_double_point_plain)

    kernels.reset_launches()
    got, gotd = add(Pc, Qc), dbl(Pc)
    check(dict(kernels.launches) == {"g2_add": 1, "g2_double": 1},
          "K5 and K6 counted under g2_add and g2_double alone")
    m = 16
    pa, qa, sa, da = (g2_to_ints(Point(*(t[..., :m] for t in x)))
                      for x in (Pc, Qc, got, gotd))
    for i in range(m):
        check(sa[i] == aff2_add(pa[i], qa[i]), f"K5 value {i}")
        check(da[i] == aff2_add(pa[i], pa[i]), f"K6 value {i}")
    check(sa[1] is None, "P + (-P) is the identity on G2")
    stats = {}
    for name, fn, pfn, nin, nmul in (
            ("g2_add", lambda: add(Pc, Qc), lambda: add_plain(Pc, Qc), 6, 42),
            ("g2_double", lambda: dbl(Pc), lambda: dbl_plain(Pc), 3, 25)):
        err = max(word_err(g, w) for g, w in zip(fn(), pfn()))
        ms = timed_ms(fn, dev, 20)
        plain_ms = timed_ms(pfn, dev, 1)
        tb, by = bound((nin + 3) * 2 * LIMB_BYTES * n,
                       nmul * IMUL_PER_MONT * n)
        stats[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": tb, "bound_by": by}
        log(f"# phase 2 {name} n={n}: max_abs_err {err} kernel {ms:.4f} ms "
            f"plain {plain_ms:.2f} ms bound {tb:.4f} ms ({by})")
    for k in DOUBLE_TIMES:
        err = max(word_err(g, w) for g, w in zip(dbl(Pc, k),
                                                  dbl_plain(Pc, k)))
        ms = timed_ms(lambda: dbl(Pc, k), dev, 5)
        tb, by = bound(6 * 2 * LIMB_BYTES * n, k * 25 * IMUL_PER_MONT * n)
        st = stats["g2_double"]
        st[f"times{k}"] = {"max_abs_err": err, "ms": ms, "bound_ms": tb,
                           "bound_by": by}
        st["max_abs_err"] = max(st["max_abs_err"], err)
        log(f"# phase 2 g2_double times={k} n={n}: max_abs_err {err} kernel "
            f"{ms:.4f} ms bound {tb:.4f} ms ({by})")
    variants = (("g2_add", add, add_plain, ""),
                ("g2_double", lambda p, q: dbl(p), lambda p, q: dbl_plain(p),
                 ""),
                ("g2_double", lambda p, q: dbl(p, 17),
                 lambda p, q: dbl_plain(p, 17), "_times17"))
    for w in G2_NARROW_WIDTHS:
        p = tuple(t[..., :w].contiguous() for t in Pc)
        q = tuple(t[..., :w].contiguous() for t in Qc)
        for name, fn, pfn, key in variants:
            err = max(word_err(g, v) for g, v in zip(fn(p, q), pfn(p, q)))
            st = stats[name]
            st["max_abs_err"] = max(st["max_abs_err"], err)
            dev_us, host_us = launch_us(lambda: fn(p, q), dev)
            st.setdefault("ms_by_width" + key, {})[w] = dev_us / 1e3
            st.setdefault("host_ms_by_width" + key, {})[w] = host_us / 1e3
            log(f"# phase 2 {name}{key.replace('_', ' ')} width {w}: "
                f"max_abs_err {err} device {dev_us:.2f} us/launch host "
                f"{host_us:.2f} us/call")
    return stats


def _mimc(dev, rng, n: int) -> dict:
    """K4 against the transcript's torch loop, bit for bit: at n lanes the
    plain form and the tree's combine over n and n - 1 lanes (the odd last
    lane permuted alone), at width 1 the plain form and state + digest;
    then its ms at n beside the bound and the plain version's, and at
    width 1 device us per launch and host us per call."""
    from legosnark_tpu_torch.curve import bn254
    from legosnark_tpu_torch.fields import limb as fl
    from legosnark_tpu_torch.utils import transcript as ttr
    from legosnark_tpu_torch.utils.bench import (edge_ints, launch_us,
                                                 rand_below, timed_ms,
                                                 word_err)

    r = bn254.R
    edge = edge_ints(r)
    x, y = (fl.tensor(fl.ints_to_limbs(v + rand_below(rng, n - len(v), 2 * r)),
                      dev) for v in (edge, edge[::-1]))
    x1, y1 = x[:, -1:].contiguous(), y[:, -1:].contiguous()
    cases = (("plain form", lambda: ttr.permute(x), lambda: ttr.permute_plain(x)),
             ("combine", lambda: ttr.combine(x), lambda: ttr.combine_plain(x)),
             ("combine odd", lambda: ttr.combine(x[:, 1:]),
              lambda: ttr.combine_plain(x[:, 1:])),
             ("width 1", lambda: ttr.permute(x1), lambda: ttr.permute_plain(x1)),
             ("state + digest", lambda: ttr.permute(x1, y1),
              lambda: ttr.permute_plain(x1, y1)))
    err = 0
    for what, fn, pfn in cases:
        e = word_err(fn(), pfn())
        log(f"# phase 2 mimc {what}: max_abs_err {e}")
        err = max(err, e)
    ms = timed_ms(lambda: ttr.permute(x), dev, 20)
    plain_ms = timed_ms(lambda: ttr.permute_plain(x), dev, 1)
    tb, by = bound(2 * LIMB_BYTES * n, MIMC_PRODUCTS * IMUL_PER_MONT * n)
    dev_us, host_us = launch_us(lambda: ttr.permute(x1), dev)
    plain1_ms = timed_ms(lambda: ttr.permute_plain(x1), dev, 2)
    log(f"# phase 2 mimc n={n}: max_abs_err {err} kernel {ms:.4f} ms plain "
        f"{plain_ms:.2f} ms bound {tb:.4f} ms ({by}); width 1: device "
        f"{dev_us:.2f} us/launch host {host_us:.2f} us/call plain "
        f"{plain1_ms:.2f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": tb, "bound_by": by, "ms_by_width": {1: dev_us / 1e3},
            "host_ms_by_width": {1: host_us / 1e3},
            "ms_by_width_plain": {1: plain1_ms}}


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


def _widths(kernels) -> dict:
    """Launches of K1-K3 since the last reset, by exact width: key "w",
    or "wxt" for a K3 launch of `times` t > 1."""
    return {k: {(f"{w}" if t == 1 else f"{w}x{t}"): n for (w, t), n in
                sorted(kernels.launch_widths.get(k, {}).items())}
            for k in MAIN_KERNELS}


def drive(torch, dev, kernels, k: int, path: str, need, fn, *args):
    """Phase k's path `path`: fn(*args) with the launch counts set to 0
    before it and read after, each kernel in `need` launched at least
    once. Returns fn's result and the path's launches."""
    _sync(torch, dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(torch, dev)
    launches = dict(kernels.launches)
    log(f"# phase {k} {path}: {time.perf_counter() - t0:.1f}s, launches "
        f"{json.dumps(launches)}, widths {json.dumps(_widths(kernels))}")
    for name in need:
        check(launches.get(name, 0) > 0, f"{name} launched on the {path} "
              f"path")
    return out, launches


def phase_example(torch, dev, kernels, k: int, fn, *args) -> dict:
    """Phase k: an example's `run` as the path EXAMPLE_PATHS names, its
    verdict true."""
    path, extra = EXAMPLE_PATHS[k]
    res, launches = drive(torch, dev, kernels, k, path, MAIN_KERNELS + extra,
                          fn, *args)
    check(res["ok"], f"the {path} proof verifies")
    log(f"# phase {k} ok: {path} verifies, times "
        f"{json.dumps({p: round(v, 3) for p, v in res['times'].items()})}")
    return {"launches": launches, "times": res["times"]}


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
    stats.update(phase_pairing(torch, np, dev))
    log("# phase 6 ok: P1a, P1b and P2 bit-identical to their plain "
        "versions (P1a, P1b to K1); K7 and K8 bit-identical to the plain "
        "pairing; pairing bilinear and card == CPU")
    return stats


def _ptxas_by_function(log_text: str) -> list:
    """ptxas's report per function: each entry kernel's registers, stack
    frame and spills, and every called function that spills."""
    out, fn = [], None
    for ln in log_text.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m[1]
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", ln)
        if m and fn:
            kernel = re.search(r"pairing_\w+_kernel", fn)
            if kernel or int(m[2]):
                out.append(f"{kernel[0] if kernel else fn}: {m[1]} B stack, "
                           f"{m[2]} B spill stores")
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn and re.search(r"pairing_\w+_kernel", fn):
            out[-1] += f", {m[1]} registers"
    return out


def _pairing_timings(torch, dev, pr, P, Q, name: str, sizes):
    """K7 and K8 over one pairing_checks shape (group sizes; each group
    its own product) against the plain path: ms per launch by CUDA events,
    the plain path's seconds, the bounds; K7's Miller values and K8's
    results bit-identical to the plain path's."""
    from legosnark_tpu_torch.curve.group import Point
    from legosnark_tpu_torch.fields import limb as fl
    from legosnark_tpu_torch.utils.bench import timed_ms

    n = sum(sizes)
    reps = -(-n // P.x.shape[-1])
    p = Point(*(t.repeat(1, reps)[..., :n].contiguous() for t in P))
    q = Point(*(t.repeat(1, 1, reps)[..., :n].contiguous() for t in Q))
    idx = pr._group_table(sizes).to(dev)
    fs = pr.miller_values(p, q)
    k7_ms = timed_ms(lambda: pr.miller_values(p, q), dev, 3)
    k8_ms = timed_ms(lambda: pr.final_exps(fs, idx), dev, 3)
    st = {"pairs": n, "products": len(sizes), "k7_ms": k7_ms,
          "k8_ms": k8_ms,
          "k7_bound_ms": bound(0, n * MONT_PER_MILLER * IMUL_PER_MONT)[0],
          "k8_bound_ms": bound(0, len(sizes) * MONT_PER_FINAL_EXP
                               * IMUL_PER_MONT)[0]}
    _sync(torch, dev)
    t0 = time.perf_counter()
    ml = pr._miller_masked(p, q)
    _sync(torch, dev)
    t1 = time.perf_counter()
    ones = torch.cat([ml, pr.F12.one((1,), dev)], dim=-1)
    fe = pr.final_exp_plain(pr._tree_prod(ones[..., idx].movedim(-2, 0)))
    _sync(torch, dev)
    st.update(plain_miller_s=t1 - t0,
              plain_final_exp_s=time.perf_counter() - t1)
    check(torch.equal(fs, fl.canon(pr.F1.spec, ml)),
          f"K7 equals the plain Miller values ({name})")
    check(torch.equal(pr.final_exps(fs, idx), fl.canon(pr.F1.spec, fe)),
          f"K8 equals final_exp_plain ({name})")
    log(f"# phase 6 pairing {name}: {n} pairs, {len(sizes)} products: K7 "
        f"{k7_ms:.3f} ms (bound {st['k7_bound_ms']:.4f}), K8 {k8_ms:.3f} ms "
        f"(bound {st['k8_bound_ms']:.4f}); plain Miller "
        f"{st['plain_miller_s']:.2f} s, final exp. "
        f"{st['plain_final_exp_s']:.2f} s")
    return st


def phase_pairing(torch, np, dev) -> dict:
    """The pairing on K7/K8: ptxas's report and the build seconds of
    pairing.cu; K7 and K8 at the cells' pairing_checks shapes (bit for bit
    against the plain path) and at 2^14 pairs; bilinearity
    e(aG1, bG2) = e(G1, G2)^(ab) at width 64; e(G1, G2) on the card equal
    to the CPU's."""
    from legosnark_tpu_torch import kernels
    from legosnark_tpu_torch.convert import to_ints
    from legosnark_tpu_torch.curve import bn254, pairing as pr
    from legosnark_tpu_torch.curve.group import (G1, G2, g1_generator,
                                                 g2_generator)
    from legosnark_tpu_torch.fields import limb as fl

    rec = kernels.build_log["pairing.cu"]
    log(f"# phase 6 pairing.cu: built in {rec['seconds']:.1f}s; "
        + "; ".join(_ptxas_by_function(rec["log"])))
    m = 64
    rng = np.random.default_rng(64)
    a = [int(x) for x in rng.integers(1, 1 << 16, size=m)]
    b = [int(x) for x in rng.integers(1, 1 << 16, size=m)]
    P = G1.scalar_mul(g1_generator((), dev), fl.tensor(fl.ints_to_limbs(a), dev))
    Q = G2.scalar_mul(g2_generator((), dev), fl.tensor(fl.ints_to_limbs(b), dev))
    shapes = dict(PAIRING_SHAPES, wide=[1] * PAIRING_WIDE)
    stats = {name: _pairing_timings(torch, dev, pr, P, Q, name, sizes)
             for name, sizes in shapes.items()}
    t0 = time.perf_counter()
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
    wide = stats["wide"]
    return {name: {"ms": wide[f"{k}_ms"], "bound_ms": wide[f"{k}_bound_ms"],
                   "bound_by": "operations", "plain_ms": wide[plain] * 1e3,
                   "ms_by_shape": {s: v[f"{k}_ms"] for s, v in stats.items()},
                   "plain_s_by_shape": {s: v[plain] for s, v in stats.items()}}
            for name, k, plain in (
                ("pairing_miller", "k7", "plain_miller_s"),
                ("pairing_final_exp", "k8", "plain_final_exp_s"))}


def phase_hadamard(torch, np, dev, d: int, kernels) -> dict:
    """The Hadamard example at n = 2^d, its host-int checks and tampers."""
    from legosnark_tpu_torch.examples import hadamard as had_example

    res, launches = drive(torch, dev, kernels, 8, "hadamard_2e14",
                          MAIN_KERNELS + ("mimc",), had_example.run, d, dev)
    check(res["lipmaa"]["ok"], "CPhadL proof at n=2^14 verifies")
    check(res["hadsc"]["ok"], "CPhad Fiat-Shamir proof at n=2^14 verifies")
    _cphad_host_checks(np, d, res["hadsc"])
    _cphadl_host_checks(np, d, res["lipmaa"])
    _hadamard_tampers(torch, dev, res)
    log("# phase 8 ok: CPhadL and CPhad (Fiat-Shamir) at n=2^14 verify, "
        "agree with host ints and rebuilt trapdoors, and reject tampers")
    return {"launches": launches, "times": res["times"]}


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

    res, launches = drive(torch, dev, kernels, 9, "cplink_2e10", MAIN_KERNELS,
                          cplink.run, log_n, dev)
    check(res["ok"], "CPlink proof and both knowledge legs verify")
    _cplink_host_checks(np, res)
    _cplink_tampers(dev, res)
    log(f"# phase 9 ok: CPlink at N=2^{log_n} verifies, agrees with host "
        f"ints from the rebuilt seeds, and rejects four tampers")
    return {"launches": launches, "times": res["times"]}


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

    res, launches = drive(torch, dev, kernels, 10, "matrixac_8", MAIN_KERNELS,
                          matrixac.run, n, dev)
    check(res["ok"], "CPAC proof verifies")
    check(res["tamper_rejected"], "CPAC proof with a flipped output fails")
    _matrixac_host_checks(np, n, res)
    log(f"# phase 10 ok: CPAC at n={n} verifies, rejects the flipped output "
        f"and agrees with host ints ({res['rel'].n} gates)")
    return {"launches": launches, "times": res["times"]}


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

    def on_path(path, fn, *args):
        out, launches[path] = drive(torch, dev, kernels, 13, path,
                                    MAIN_KERNELS, fn, *args)
        return out

    msms = on_path("bench_msm_c16", lambda: {
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
        res = on_path("cppoly_20var", bg.bench_cppoly, 20, dev, cache, rows)
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
        res = on_path("cpsc_16var", bg.bench_cpsc, 16, dev, cache, rows)
        summary["cpsc_16var"] = rows.rows
        check(res["ok"], "CPsc over 16 variables verifies")
        _cpsc_host_checks(np, 16, res)
        _cpsc_tampers(dev, res)
        log("# phase 13c ok: cpsc_16var agrees with host ints and rejects "
            "three tampers")

        out = os.path.join(cache, "rows.json")
        on_path("bench_gadgets_rest", bg.main, [
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
    "mimc": ("legosnark_tpu_torch/csrc/mimc.cu", None, True),
    "g2_add": ("legosnark_tpu_torch/csrc/g2.cu", None, True),
    "g2_double": ("legosnark_tpu_torch/csrc/g2.cu", None, True),
    "pairing_miller": ("legosnark_tpu_torch/csrc/pairing.cu", None, True),
    "pairing_final_exp": ("legosnark_tpu_torch/csrc/pairing.cu", None, True),
}


def main(argv) -> int:
    phases = set(PHASES)
    if "--phases" in argv:
        phases = {int(x) for x in argv[argv.index("--phases") + 1].split(",")}
    if phases - set(PHASES):
        print(f"chip_smoke: no phase {sorted(phases - set(PHASES))}; the "
              f"phases are {PHASES}", file=sys.stderr)
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
        from legosnark_tpu_torch.examples import legogrothmatrix, matrixsc
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
    hv = timed(5, phase_example, torch, dev, kernels, 5, matrixsc.run, 10,
               dev, False)
    stats.update(timed(6, phase_probes, torch, np, dev) or {})
    fs = timed(7, phase_example, torch, dev, kernels, 7, matrixsc.run, 10,
               dev)
    had = timed(8, phase_hadamard, torch, np, dev, 14, kernels)
    link = timed(9, phase_cplink, torch, np, dev, 10, kernels)
    mac = timed(10, phase_matrixac, torch, np, dev, 8, kernels)
    g16 = timed(11, phase_example, torch, dev, kernels, 11,
                legogrothmatrix.run, 128, dev)
    worlds = sharded_worlds(torch)
    shd = timed(12, phase_sharded, torch, np, dev, dryrun.FULL, worlds)
    bnc = timed(13, phase_bench, torch, np, dev, kernels)
    done = {"cpmmp_hv_1024": hv, "cpmmp_fs_1024": fs, "hadamard_2e14": had,
            "cplink_2e10": link, "matrixac_8": mac, "groth16_128": g16}
    paths = {p: res["launches"] if res else {} for p, res in done.items()}
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
    for name, res in done.items():
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
